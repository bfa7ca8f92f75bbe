#!/usr/bin/env python
"""Primitive-cost probes for the banded warp, the PyTorch/CUDA port of
tools/warp_kernel_probe.py, with its three stages on its geometry (720p,
C 64, 90 bands of 8 rows, a padded (760, 1344, C) bf16 input):

  band DMA floor: 2 x the (H, W) window of the padded input at (16, 32), the
    floor for moving a band (K6);
  dense select (35H+35V): the two-pass gather warp, a horizontal pass of two
    taps at random shifts rounded to bf16, then a vertical pass of two
    (K11; the TPU summed 35 masked shifts a pass, two of them non-zero);
  per-block window DMAs (320/band): per 8x8 block, the average of two
    shifted windows at random origins, written block-major as the TPU probe
    writes them (K12).

    python tools/torch_warp_kernel_probe.py                 # the card, 720p
    python tools/torch_warp_kernel_probe.py --device cpu --hw 16 256 --channels 8 --n 1

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
    bf16_from_numpy as bf16, block_windows, gather2, timed, window_copy)

H, W, C = 720, 1280, 64
B = 8
PADX = 32
PADY = 20
X0 = PADX - 17  # column of the select's shift 0 (band[:, s + PADX - 17])
FLOOR_ROW = 16  # the floor copies band rows 16 .. 23: input rows 8 ri + 16


def stage(name, fn):
    try:
        ms, out = fn()
        print(f"[ok] {name}: {ms:.3f} ms/warp", flush=True)
        return ms, out
    except Exception as e:  # noqa: BLE001 -- the probe reports each stage and goes on
        print(f"[FAIL] {name}: {repr(e)[:700]}", flush=True)
        return None, None


def draw_inputs(h, w, c, with_input=True):
    """numpy's default_rng(0) in the JAX file's order (:203-216) at output
    size (h, w) and width c: the padded input ``(1, h + 40, w + 64, c)``
    float32 (None without ``with_input``: its normals are drawn in chunks
    and dropped, which leaves the stream where it was), then ``sy``, ``sx``
    (one an 8x8 block) and ``shidx``, ``dyidx``, ``wx0``, ``wx1``, ``wy0``,
    ``wy1`` (h/8, w) as int32 and float32 arrays."""
    nby, nbx = h // B, w // B
    hp, wp = h + 2 * PADY, w + 2 * PADX
    rng = np.random.default_rng(0)
    shape = (1, hp, wp, c)
    if with_input:
        xp = rng.standard_normal(shape).astype(np.float32)
    else:
        xp, left = None, hp * wp * c
        while left:
            left -= len(rng.standard_normal(min(left, 1 << 22)))
    sy = rng.integers(0, hp - 10, nby * nbx).astype(np.int32)
    sx = (rng.integers(0, (wp - 20) // B, nby * nbx) * B).astype(np.int32)
    shidx = rng.integers(0, 34, (nby, w)).astype(np.int32)
    dyidx = rng.integers(0, 34, (nby, w)).astype(np.int32)
    weights = [rng.random((nby, w)).astype(np.float32) for _ in range(4)]
    return (xp, sy, sx, shidx, dyidx, *weights)


def main(argv=None):
    """Run the three stages; returns {stage: dict(ms=..., out=..., fn=the
    timed call, args=its inputs)} (ms and out None where it failed)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; the kernels) or cpu "
                   "(their plain versions)")
    p.add_argument("--hw", type=int, nargs=2, default=[H, W], metavar=("H", "W"),
                   help="output size, multiples of 8")
    p.add_argument("--channels", type=int, default=C)
    p.add_argument("--n", type=int, default=30, help="timed calls a stage (default 30, as there)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_warp_kernel_probe: no CUDA device (use --device cpu)")
    h, w = args.hw
    c = args.channels
    xp, *tables = draw_inputs(h, w, c)
    xp = bf16(xp, dev)
    sy, sx, shidx, dyidx, wx0, wx1, wy0, wy1 = (torch.from_numpy(t).to(dev) for t in tables)

    res = {}
    for name, fn, fn_args in (
            ("band DMA floor", window_copy, (xp, h, w, FLOOR_ROW, PADX)),
            ("dense select (35H+35V)", gather2, (xp, shidx, wx0, wx1, dyidx, wy0, wy1, X0)),
            ("per-block window DMAs (320/band)", block_windows, (xp, sy, sx, h, w))):
        ms, out = stage(name, lambda: timed(lambda: fn(*fn_args), args.n))
        res[name] = dict(ms=ms, out=out, fn=fn, args=fn_args)
    print({"floor_ms": res["band DMA floor"]["ms"],
           "select_ms": res["dense select (35H+35V)"]["ms"],
           "block_dma_ms": res["per-block window DMAs (320/band)"]["ms"]})
    return res


if __name__ == "__main__":
    results = main()
    sys.exit(0 if all(r["out"] is not None for r in results.values()) else 1)
