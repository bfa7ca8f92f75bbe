#!/usr/bin/env python
"""The chunk-copy probe of the PF warp's memory traffic, the PyTorch/CUDA
port of tools/dma_probe.py: a (1, 736, 656, 128) bf16 array (123.6 MB) read
in 92 chunks of 8 rows, with its knobs:

  --split K      each chunk's copy in K column segments, each with its own
                 barrier, started back to back (default: 1, 2 and 4)
  --write-out    0: read every chunk, write only the last chunk's first row
                 (8 x 128); 1: write the whole array back out (default: both)
  --depth N      chunks started ahead of the one in use (default DP_DEPTH or 3;
                 a ring of N + 1 stages)
  --mode M       manual (default DP_MODE or manual): a per-block ring of TMA
                 bulk copies (K13 ring_copy); pipelined: a plain streamed
                 copy, one block per chunk (K13 stream_copy)

Each configuration prints the JAX file's line, its time per copy over N = 30
calls chained through ``z + dep`` (each call's input depends on the last
output, as there; the add is one more read and write of the array that the
GB/s does not count), then the kernel alone, CUDA events over --n
back-to-back launches after a warm-up.

    python tools/torch_dma_probe.py                  # the card
    python tools/torch_dma_probe.py --device cpu --hw 48 48 --n 1 --chain 2
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_vcve_torch.kernels.probes import (  # noqa: E402
    bf16_from_numpy as bf16, ring_copy, stream_copy, timed)

H, W = 720, 1280
WH = W // 2       # 640
WP = WH + 16      # PF cols
HP = H + 16       # PF rows
LANES = 128
N = 30


def chained_ms(step, z, n):
    """Milliseconds a call of ``step`` over ``n`` calls, each on ``z + dep``
    where dep (~1e-30 x the last output's first value, in z's type) ties
    the call to the one before (tools/dma_probe.py: chained, :119)."""
    def chain():
        carry = None
        for _ in range(n):
            dep = 0.0 if carry is None else carry.reshape(-1)[0].float() * 1e-30
            carry = step(z + torch.as_tensor(dep, device=z.device).to(z.dtype))
        return carry.float().sum()

    ms, _ = timed(chain, 1)
    return ms / n


def main(argv=None):
    """Run each configuration; returns {label: dict(ms=the chained time,
    kernel_ms=the kernel alone, out=its output on z, fn=the timed call,
    args=its inputs, bytes=what the GB/s counts)}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; the kernels) or cpu "
                   "(their plain versions)")
    p.add_argument("--mode", choices=("manual", "pipelined"),
                   default=os.environ.get("DP_MODE", "manual"))
    p.add_argument("--split", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--write-out", type=int, nargs="+", default=[0, 1], choices=(0, 1))
    p.add_argument("--depth", type=int, default=int(os.environ.get("DP_DEPTH", "3")))
    p.add_argument("--hw", type=int, nargs=2, default=[HP, WP], metavar=("HP", "WP"),
                   help="the array's rows (a multiple of 8) and columns")
    p.add_argument("--lanes", type=int, default=LANES)
    p.add_argument("--chain", type=int, default=N, help="chained calls (default 30, as there)")
    p.add_argument("--n", type=int, default=30, help="timed launches of the kernel alone")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_dma_probe: no CUDA device (use --device cpu)")
    hp, wp = args.hw
    rng = np.random.default_rng(0)
    z = bf16(rng.standard_normal((1, hp, wp, args.lanes)).astype(np.float32), dev)
    nchunks = hp // 8
    in_bytes = nchunks * 8 * wp * args.lanes * 2
    if args.mode == "pipelined":
        configs = [(f"pipelined out={w}", stream_copy, (z, bool(w)), w) for w in (0, 1)]
    else:
        configs = [(f"split={s} out={w} depth={args.depth}", ring_copy,
                    (z, s, bool(w), args.depth), w)
                   for s in args.split for w in args.write_out]
    res = {}
    for label, fn, fn_args, write_out in configs:
        step = lambda x, fn=fn, a=fn_args: fn(x, *a[1:])  # noqa: E731
        nbytes = in_bytes + (hp * wp * args.lanes * 2 if write_out else 0)
        try:
            ms = chained_ms(step, z, args.chain)
            kernel_ms, out = timed(lambda: fn(*fn_args), args.n)
        except Exception as e:  # noqa: BLE001 -- the probe reports each configuration and goes on
            print(f"[FAIL] {label}: {repr(e)[:700]}", flush=True)
            res[label] = dict(ms=None, kernel_ms=None, out=None, fn=fn, args=fn_args,
                              bytes=nbytes)
            continue
        print(f"{label}: {ms:7.3f} ms  {nbytes / ms / 1e6:6.1f} GB/s "
              f"({nbytes / 1e6:.0f} MB)", flush=True)
        print(f"  kernel alone: {kernel_ms:7.3f} ms  {nbytes / kernel_ms / 1e6:6.1f} GB/s",
              flush=True)
        res[label] = dict(ms=ms, kernel_ms=kernel_ms, out=out, fn=fn, args=fn_args, bytes=nbytes)
    return res


if __name__ == "__main__":
    results = main()
    sys.exit(0 if all(r["out"] is not None for r in results.values()) else 1)
