#!/usr/bin/env python
"""The banded block8 warp as a selection matmul, the PyTorch/CUDA port of
tools/warp_kernel_probe2.py, with its two stages:

  band DMA floor (128-lane): the scaled window copy of a 128-lane
    pixel-pair map (K6), the floor for moving the band;
  matmul-select H + dense V: per 8-row band and 128-column tile, a (128, 184)
    selection matrix S built outside the kernel (build_s) contracts the
    band's (184, C) window on the tensor cores, rounded to bf16; then a
    dense 40-term vertical blend in float32 (K7).

    python tools/torch_warp_kernel_probe2.py                 # the card, 720p
    python tools/torch_warp_kernel_probe2.py --device cpu --hw 16 256 --channels 16 --n 1

Inputs come from numpy's default_rng(0) in the JAX file's order. Times are
CUDA events over 30 (--n) back-to-back launches after a warm-up (the host
clock over the plain versions on the CPU).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_vcve_torch.kernels.probes import (  # noqa: E402
    bf16_from_numpy as bf16, build_s, mmsel_warp, timed, window_copy)

H, W, C = 720, 1280, 64
B = 8
PADX = 32
PADY = 20
TILE = 128
DV = 40  # V dense terms (out row i reads hband[d + i], d in [0, DV))


def stage(name, fn):
    try:
        ms, out = fn()
        print(f"[ok] {name}: {ms:.3f} ms/warp", flush=True)
        return ms, out
    except Exception as e:  # noqa: BLE001 -- the probe reports each stage and goes on
        print(f"[FAIL] {name}: {repr(e)[:600]}", flush=True)
        return None, None


def main(argv=None):
    """Run both stages; returns {stage: dict(ms=..., out=..., fn=the timed
    call, args=its inputs)} (ms and out None where it failed)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; the kernels) or cpu "
                   "(their plain versions)")
    p.add_argument("--hw", type=int, nargs=2, default=[H, W], metavar=("H", "W"),
                   help="output size; H a multiple of 8, W of 128")
    p.add_argument("--channels", type=int, default=C)
    p.add_argument("--n", type=int, default=30, help="timed calls a stage (default 30, as there)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_warp_kernel_probe2: no CUDA device (use --device cpu)")
    h, w = args.hw
    c = args.channels
    nby, wp, hp = h // B, w + 2 * PADX, h + 2 * PADY
    rng = np.random.default_rng(0)
    xp = bf16(rng.standard_normal((1, hp, wp, c)).astype(np.float32), dev)
    xp2 = bf16(rng.standard_normal((1, hp, wp // 2, 2 * c)).astype(np.float32), dev)
    base = np.arange(w, dtype=np.int32)[None, :] + PADX
    dx = rng.integers(-17, 18, (nby, w)).astype(np.int32)
    m0 = base + dx
    w0 = rng.random((nby, w)).astype(np.float32)
    w1 = rng.random((nby, w)).astype(np.float32)
    s_all = build_s(*(torch.from_numpy(a).to(dev) for a in (m0, w0, w1)))

    vm_np = np.zeros((nby, w, DV), np.float32)
    dyi = rng.integers(1, DV - 1, (nby, w))
    for d in range(DV):
        vm_np[:, :, d][dyi == d] = 0.7
        vm_np[:, :, d][dyi == d - 1] = 0.3
    vm = torch.from_numpy(vm_np).to(dev)

    res = {}
    for name, fn, fn_args in (
            ("band DMA floor (128-lane)", window_copy, (xp2, h, w // 2, 16, PADX // 2)),
            ("matmul-select H + dense V", mmsel_warp, (xp, s_all, vm))):
        ms, out = stage(name, lambda: timed(lambda: fn(*fn_args), args.n))
        res[name] = dict(ms=ms, out=out, fn=fn, args=fn_args)
    print({"floor128_ms": res["band DMA floor (128-lane)"]["ms"],
           "mmsel_ms": res["matmul-select H + dense V"]["ms"]})
    return res


if __name__ == "__main__":
    results = main()
    sys.exit(0 if all(r["out"] is not None for r in results.values()) else 1)
