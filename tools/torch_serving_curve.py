#!/usr/bin/env python
"""Latency/throughput curve of batched serving on one card (the PyTorch port's
counterpart of tools/serving_curve.py).

For b = 1..--max-b: the serving forward (the port's serving config,
``warp_impl='pf'``, remat off, features in --dtype) of b concurrent clips of
--t frames at --hw, the batch ``pnp_vcve_torch.serving.StreamScheduler``
hands ``batched_forward_executor``. One warm-up forward, then --iters
forwards chained on their own outputs (each clip's output, clipped to
[0, 1], is the next forward's input) between two ``torch.cuda.synchronize()``
calls. Each row: dispatch latency (= each clip's latency at that b),
ms/frame, aggregate frames/s and peak device memory. An out-of-memory error
at some b is printed as the bound and the sweep goes on; any other error
fails.

    python tools/torch_serving_curve.py [--max-b 4] [--t 12] [--hw 720 1280]
        [--iters 4] [--dtype bf16|fp32] [--config CFG] [--device cuda|cpu]

``--device cuda`` (the default) runs the CUDA kernels and fails when there
is no GPU; ``--device cpu`` runs their plain versions (a small --hw only).
Prints one JSON line per b, then a markdown table.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SERVING_CONFIG = REPO / "pnp_vcve_torch" / "configs" / "HR_davis_LR_128x128_serving.py"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batched-serving latency/throughput curve")
    p.add_argument("--max-b", type=int, default=4)
    p.add_argument("--t", type=int, default=12)
    p.add_argument("--hw", type=int, nargs=2, default=(720, 1280))
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    p.add_argument("--config", default=str(SERVING_CONFIG))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_inputs(b, t, h, w, device):
    """b clips of t frames, drawn from a fixed seed: MVs and partitions
    constant over 8x8 blocks (what the rasterizer emits), MVs ~6 px, I/P/B
    slices."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    slices = np.full((b, t), 66.0, np.float32)
    slices[:, ::4] = 80.0
    slices[:, 0] = 73.0
    up = lambda a: np.repeat(np.repeat(a, 8, axis=2), 8, axis=3)  # noqa: E731
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), dtype=np.float32),
        qps=rng.random((b, t), dtype=np.float32),
        slices=slices,
        mvs=up((rng.standard_normal((b, t, h // 8, w // 8, 4)) * 6).astype(np.float32)),
        base_qps=np.full((b, t), 15.0 / 255.0, np.float32),
        par_map=up((rng.random((b, t, h // 8, w // 8, 3)) > 0.5).astype(np.float32) / 255.0),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}


def run_curve(args):
    """The rows of the curve, one per b (printed as they come)."""
    import torch

    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.config import Config

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    cfg = Config.fromfile(args.config)
    # random weights drawn from a fixed seed: the time does not depend on them
    model = build_generator({**dict(cfg.model["generator"]), "remat": False}, device=device)
    model.feature_dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    t, (h, w) = args.t, args.hw
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    rows = []
    for b in range(1, args.max_b + 1):
        try:
            inputs = make_inputs(b, t, h, w, device)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            with torch.inference_mode():
                lrs = model(**inputs).clamp_(0.0, 1.0)  # warm-up
                sync()
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    lrs = model(**{**inputs, "lrs": lrs}).clamp_(0.0, 1.0)
                sync()
                dispatch = (time.perf_counter() - t0) / args.iters
            row = dict(
                b=b, t=t, h=h, w=w, dtype=args.dtype, device=kind,
                dispatch_latency_s=dispatch, per_clip_latency_s=dispatch,
                ms_per_frame=dispatch / (b * t) * 1e3, aggregate_fps=b * t / dispatch,
                peak_mem_gib=(torch.cuda.max_memory_allocated(device) / 2**30 if cuda
                              else None),
            )
            del inputs, lrs
        except torch.cuda.OutOfMemoryError as e:
            row = dict(b=b, t=t, h=h, w=w, dtype=args.dtype, device=kind,
                       oom=str(e).splitlines()[0][:200])
            if cuda:
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None):
    rows = run_curve(parse_args(argv))
    print("\n| b | dispatch latency (s) | ms/frame | aggregate f/s | peak memory (GiB) |")
    print("|---|---|---|---|---|")
    for r in rows:
        if "oom" in r:
            print(f"| {r['b']} | out of device memory (the bound) | — | — | — |")
        else:
            peak = "n/a" if r["peak_mem_gib"] is None else f"{r['peak_mem_gib']:.3f}"
            print(f"| {r['b']} | {r['dispatch_latency_s']:.4f} | {r['ms_per_frame']:.2f} | "
                  f"{r['aggregate_fps']:.3f} | {peak} |")
    return rows


if __name__ == "__main__":
    main()
