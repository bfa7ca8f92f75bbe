#!/usr/bin/env python
"""The warp probes' small stages, the PyTorch/CUDA port of tools/warp_bisect.py
(which bisected a TPU compiler crash: 64-lane minor dim vs fori+dot vs
dynamic stores):

  dma64 / dma128:    out[r, x] = 2 * x[r + 16, x + 32]                    (K6)
  nodma64:           out[r, x] = 2 * x[16 + r % 8, x + 32]                (K6, period 8)
  fori128 / fori64:  out[8 ri + i, o] = S (128 x 184) @ x[8 ri + 16 + i, 0:184]
                     for o < 128; columns 128 .. 255 zeros                 (K7, H pass alone)

on inputs and a selection matrix of ones, as there.

    python tools/torch_warp_bisect.py [dma64 dma128 nodma64 fori128 fori64] [--device cpu]

Each stage prints its wall time (the first call: the kernels' build, at
first use, included) and the sum of its output. On the card it also times
30 back-to-back launches with CUDA events after a warm-up (returned, for
chip_smoke.py). The TPU probe leaves fori's columns 128 .. 255 unwritten;
here they are zeros.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_vcve_torch.kernels.probes import mmsel_h, timed, window_copy  # noqa: E402

H, W = 64, 256
TILE = 128
KW = 184
# stage -> (printed name, form, lanes), in the order the JAX file runs them
STAGES = {"dma64": ("dma 64-lane", "dma", 64), "dma128": ("dma 128-lane", "dma", 128),
          "nodma64": ("nodma 64-lane", "nodma", 64),
          "fori128": ("fori+dot 128-lane", "fori", 128), "fori64": ("fori+dot 64-lane", "fori", 64)}


def stage_call(form, lanes, dev, h=H, w=W):
    """(the kernel's wrapper, its arguments) for one stage, inputs of ones."""
    wpad = w + 64
    ones = lambda *shape: torch.ones(shape, dtype=torch.bfloat16, device=dev)  # noqa: E731
    if form == "dma":
        return window_copy, (ones(1, h + 40, wpad, lanes), h, w, 16, 32)
    if form == "nodma":
        return window_copy, (ones(1, h, wpad, lanes), h, w, 16, 32, 8)
    return mmsel_h, (ones(1, h + 40, wpad, lanes), ones(1, 1, TILE, KW), h // 8, 16, w)


def stage(name, fn, dev, reps=30):
    t0 = time.perf_counter()
    try:
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[ok] {name} ({wall:.1f}s) sum={float(out.float().sum())}", flush=True)
    except Exception as e:  # noqa: BLE001 -- the probe reports each stage and goes on
        print(f"[FAIL] {name} ({time.perf_counter() - t0:.1f}s): {repr(e)[:300]}", flush=True)
        return None, None
    if dev.type != "cuda":
        return None, out
    return timed(fn, reps)[0], out


def main(argv=None):
    """Run the named stages (default dma64 nodma64 fori128 fori64, as
    there); returns {stage: dict(ms=CUDA-event ms a launch or None, out=...,
    fn=the wrapper, args=its inputs)}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stages", nargs="*", help=f"stages to run, of {', '.join(STAGES)} "
                   "(default: dma64 nodma64 fori128 fori64)")
    p.add_argument("--device", default="cuda", help="cuda (default; the kernels) or cpu "
                   "(their plain versions)")
    p.add_argument("--hw", type=int, nargs=2, default=[H, W], metavar=("H", "W"),
                   help="output size; H a multiple of 8, W >= 128")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_warp_bisect: no CUDA device (use --device cpu)")
    which = args.stages or ["dma64", "nodma64", "fori128", "fori64"]
    unknown = sorted(set(which) - set(STAGES))
    if unknown:
        p.error(f"unknown stages {unknown}; choose from {list(STAGES)}")
    res = {}
    for name, (label, form, lanes) in STAGES.items():
        if name not in which:
            continue
        fn, fn_args = stage_call(form, lanes, dev, *args.hw)
        ms, out = stage(label, lambda: fn(*fn_args), dev)
        res[name] = dict(ms=ms, out=out, fn=fn, args=fn_args)
    return res


if __name__ == "__main__":
    results = main()
    sys.exit(0 if all(r["out"] is not None for r in results.values()) else 1)
