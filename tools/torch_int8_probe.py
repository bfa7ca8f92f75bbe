#!/usr/bin/env python
"""int8 against bf16 on the tensor cores, the PyTorch/CUDA port of
tools/int8_probe.py, staged as there:

  1. bf16 matmul (K8)
  2. pre-quantized int8 matmul (K8, int8)
  3. quantize (K9: per-tensor absmax, two passes) + int8 matmul with the scale (K8)
  4. int8 tap conv: K9 on the band, then the 3x3 valid conv (K10, int8)
  5. bf16 tap conv at the same geometry (K10, bf16)

    python tools/torch_int8_probe.py                  # the card, the JAX file's shapes
    python tools/torch_int8_probe.py --device cpu --mkn 64 32 16 --band 6 20 32 --out 4 18 --n 1

Inputs come from numpy's default_rng(0) in the JAX file's order. Times are
CUDA events over the JAX file's n back-to-back launches (100, 50 for the
tap convs; --n sets another) after a warm-up; on the CPU the host clock over the plain
versions. Each stage prints and continues on failure, as there; the exit
code is 1 if any stage failed.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_vcve_torch.kernels.probes import (  # noqa: E402
    absmax_quantize, bf16_from_numpy as bf16, matmul, tapconv, timed)

M, K, N = 4096, 128, 128
BH, BW, C2 = 24, 656, 128
ROWS, COLS = 16, 320


def stage(name, fn):
    """Run one stage, print its time in microseconds as the JAX file does;
    (us, output), or (None, None) where it failed."""
    try:
        ms, out = fn()
        print(f"[ok] {name}: {ms * 1e3:.1f} us", flush=True)
        return ms * 1e3, out
    except Exception as e:  # noqa: BLE001 -- the probe reports each stage and goes on
        msg = repr(e).replace("\\n", " ")[:600]
        print(f"[FAIL] {name}: {msg}", flush=True)
        return None, None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; the kernels) or cpu "
                   "(their plain versions)")
    p.add_argument("--mkn", type=int, nargs=3, default=[M, K, N], metavar=("M", "K", "N"))
    p.add_argument("--band", type=int, nargs=3, default=[BH, BW, C2], metavar=("BH", "BW", "C2"))
    p.add_argument("--out", type=int, nargs=2, default=[ROWS, COLS], metavar=("ROWS", "COLS"))
    p.add_argument("--n", type=int, default=None,
                   help="timed calls a stage (default: the JAX file's, 100 and 50 for the tap convs)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the five stages; returns {stage: dict(us=..., out=..., fn=the
    timed call, args=its inputs)} (us and out None where it failed)."""
    args = parse(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_int8_probe: no CUDA device (use --device cpu for the plain versions)")
    m, k, n = args.mkn
    bh, bw, c2 = args.band
    rows, cols = args.out
    rng = np.random.default_rng(0)
    a_f = rng.standard_normal((m, k)).astype(np.float32)
    b_f = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    a_bf, b_bf = bf16(a_f, dev), bf16(b_f, dev)
    s_a = np.abs(a_f).max() / 127.0
    s_b = np.abs(b_f).max(axis=0) / 127.0
    a_q = torch.from_numpy(np.clip(np.round(a_f / s_a), -127, 127).astype(np.int8)).to(dev)
    b_q = torch.from_numpy(np.clip(np.round(b_f / s_b), -127, 127).astype(np.int8)).to(dev)
    res = {}

    def run(name, fn, fn_args, n_reps):
        t, out = stage(name, lambda: timed(lambda: fn(*fn_args), args.n or n_reps))
        res[name] = dict(us=t, out=out, fn=fn, args=fn_args)
        return t, out

    # --- 1. bf16 matmul
    t1, o1 = run("bf16 matmul", matmul, (a_bf, b_bf), 100)
    # --- 2. int8 matmul (pre-quantized)
    t2, o2 = run("int8 matmul", matmul, (a_q, b_q), 100)
    if t1 and t2:
        print(f"  -> int8 speedup x{t1 / t2:.2f}")
    if o1 is not None and o2 is not None:
        approx = o2.cpu().numpy().astype(np.float64) * (s_a * s_b[None, :])
        o1n = o1.cpu().numpy()
        err = np.abs(approx - o1n.astype(np.float64)).max()
        print(f"  -> dequant max|err| {err:.4f} vs |out|max {np.abs(o1n).max():.1f}")

    # --- 3. quantize + int8 matmul
    def quantized_matmul(a, b):
        q, s = absmax_quantize(a)
        return matmul(q, b, s)

    run("quantize-in-kernel + int8 matmul", quantized_matmul, (a_bf, b_q), 100)

    # --- 4. tap conv on an int8 band
    band_f = rng.standard_normal((bh, bw, c2)).astype(np.float32)
    band_bf = bf16(band_f, dev)
    w_f = rng.standard_normal((3, 3, c2, c2)).astype(np.float32) * 0.05
    ws = np.abs(w_f).max(axis=(0, 1, 2)) / 127.0
    wq = torch.from_numpy(np.clip(np.round(w_f / ws), -127, 127).astype(np.int8)).to(dev)

    def quantized_tapconv(band, w):
        q, s = absmax_quantize(band)
        return tapconv(q, w, rows, cols, s)

    t4, _ = run("int8 tap-conv (strided slices)", quantized_tapconv, (band_bf, wq), 50)

    # --- 4b. bf16 tap conv, same geometry
    w_bf = bf16(w_f, dev)
    t5, _ = run("bf16 tap-conv (same geometry)", lambda band, w: tapconv(band, w, rows, cols),
                (band_bf, w_bf), 50)
    if t4 and t5:
        print(f"  -> tap-conv int8 speedup x{t5 / t4:.2f}")
    return res


if __name__ == "__main__":
    results = main()
    sys.exit(0 if all(r["out"] is not None for r in results.values()) else 1)
