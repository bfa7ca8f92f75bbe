#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pnp_vcve_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the script exits non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the four kernels from pnp_vcve_torch/kernels/csrc (nvcc, sm_90a)
   and print the compiler's register / shared-memory / spill report;
3. each kernel against its plain PyTorch version at the main path's shapes
   (b=1, 720x1280, 64 channels) and at a ragged size (36x52), in float32
   (TF32 off; max|diff| <= 1e-4 std) and bfloat16 (max < 0.02 std,
   mean < 0.002 std; warp 0.08 / 0.01; input conv max 0.04 std, see
   BF16_BOUNDS); at 720p both are timed with CUDA events in turns (plain,
   kernel, kernel, plain);
4. the main path: ``tools/torch_test.py`` with the flagship serving config
   and the parity fixture's weights on a REDS4-layout fixture of 4 clips x
   8 frames at 720x1280 (PNG frames, MV sidecars, qp.json) that
   tools/data/make_protocol_fixture.py writes under build/chip_smoke/; the
   kernels' launch counts must equal 2 warps, 2 input convs, 16 DRT blocks
   and 1 head per frame;
5. the whole model's kernel path against its plain path on one clip of
   8 frames at 256x448 (max|diff| <= 3e-3, float32).

The line before the last is a JSON object with each kernel's launches on the
main path, its error and its time beside the plain version's; the last line
is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
MAIN_HW = (720, 1280)
RAGGED_HW = (36, 52)
CLIPS, FRAMES = 4, 8
TOL_MODEL = 3e-3
# bfloat16 (max, mean) bounds in units of std(ref): tests/test_tpu_parity.py
# :43-51, the warp's :71 and the input conv's max from :137 -- its leaky-ReLU
# output reaches ~9.6 std, where bfloat16's own half-ulp rounding of the
# output is already 0.019-0.038 std
BF16_BOUNDS = {"warp": (0.08, 0.01), "input_conv": (0.04, 0.002),
               "drt_block": (0.02, 0.002), "head": (0.02, 0.002)}

# FLOP per output pixel at 64 channels (2 per multiply-add), from the shapes
FLOP_PER_PIXEL = {
    "input_conv (backward, 3 parts)": 2 * 9 * (3 + 128) * 64,
    "input_conv (forward, 4 parts)": 2 * 9 * (3 + 192) * 64,
    "drt_block": 2 * (9 * 64 * 64 + 3 * 64 * 64 + 9 * 64 * 64),
    "head": 2 * 9 * 64 * (64 + 3),
}

KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "warp": ("pnp_vcve_torch/kernels/csrc/warp.cu", "pnp_vcve_tpu/kernels/warp_pf.py:488"),
    "input_conv": ("pnp_vcve_torch/kernels/csrc/input_conv.cu",
                   "pnp_vcve_tpu/kernels/drt_stack.py:649"),
    "drt_block": ("pnp_vcve_torch/kernels/csrc/drt_block.cu",
                  "pnp_vcve_tpu/kernels/drt_stack.py:305"),
    "head": ("pnp_vcve_torch/kernels/csrc/head.cu", "pnp_vcve_tpu/kernels/drt_stack.py:1058"),
}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build():
    from pnp_vcve_torch.kernels.build import library

    t0 = time.perf_counter()
    lib = library()
    print(f"[build] {lib.path} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s)")
    for line in lib.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            print("[build]", line.strip())
    smem = {n: getattr(lib.lib, f"pnp_{n}_smem")() for n in ("input_conv", "drt_block", "head")}
    print(f"[build] dynamic shared memory per block (bytes): {smem}")


def _timed(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _compare(name, got, ref, dtype, bounds):
    import torch

    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    sd = float(ref.std()) or 1.0
    diff = (got - ref).abs()
    mx, mean = float(diff.max()), float(diff.mean())
    if dtype == torch.float32:
        ok = mx <= 1e-4 * sd
        bound = f"<= 1e-4 std = {1e-4 * sd:.3g}"
    else:
        max_rel, mean_rel = bounds
        ok = mx < max_rel * sd and mean < mean_rel * sd
        bound = f"< {max_rel} std = {max_rel * sd:.3g}, mean < {mean_rel * sd:.3g}"
    print(f"[kernel] {name}: max|diff| {mx:.3g} mean {mean:.3g} ({bound})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _cases(dev, dtype, b, h, w, gen):
    """(label, kernel name, kernel call, plain call in float32 on the same
    values, plain call in the working type, reps for timing) per case."""
    import torch

    from pnp_vcve_torch.kernels import KERNELS, PLAIN
    from pnp_vcve_torch.kernels.drt_stack import part_kernels

    def feat(c):
        return torch.randn((b, h, w, c), generator=gen).to(dev, dtype)

    def wt(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    x = feat(64)
    # block-constant motion vectors as the rasterizer emits them, +-24 px
    fb = torch.rand((b, -(-h // 8), -(-w // 8), 2), generator=gen) * 48 - 24
    flow = fb.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w].contiguous()
    flow = flow.to(dev, dtype)
    cases = [("warp", "warp", lambda: KERNELS.flow_warp(x, flow),
              lambda: PLAIN.flow_warp(x.float(), flow.float()),
              lambda: PLAIN.flow_warp(x, flow), 20)]
    gate = torch.ones(b, device=dev)
    for n_parts, tag in ((3, "backward"), (4, "forward")):
        parts = [feat(3)] + [feat(64) for _ in range(n_parts - 1)]
        kernel = wt((3, 3, 3 + 64 * (n_parts - 1), 64), 0.03)
        bias = wt((64,), 0.1)
        ks = part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
        cases.append((
            f"input_conv ({tag}, {n_parts} parts)", "input_conv",
            lambda p=parts, k=ks, bb=bias: KERNELS.input_conv(p, k, bb),
            lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(f32(p), k, bb),
            lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(p, k, bb), 5))
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    blk = (wt((b, 3, 3, 64, 64), 0.03), wt((b, 64), 0.1),
           torch.rand((b, 64), generator=gen).to(dev),
           wt((64, 3, 64), 0.03), wt((3, 3, 64, 64), 0.03), wt((64,), 0.1))
    cases.append(("drt_block", "drt_block", lambda: KERNELS.drt_block(x, par, *blk),
                  lambda: PLAIN.drt_block(x.float(), par.float(), *blk),
                  lambda: PLAIN.drt_block(x, par, *blk), 5))
    hd = (wt((3, 3, 64, 64), 0.03), wt((64,), 0.1), wt((3, 3, 64, 3), 0.06), wt((3,), 0.1))
    cases.append(("head", "head", lambda: KERNELS.head(x, *hd),
                  lambda: PLAIN.head(x.float(), *hd), lambda: PLAIN.head(x, *hd), 5))
    return cases


def phase_kernels(dev):
    """Returns {kernel: (max_abs_err, ms, plain_ms)} in float32 at 720p; the
    input conv's entry covers its two forms (worst error, mean time)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for (h, w), timed in ((MAIN_HW, True), (RAGGED_HW, False)):
            for label, name, kern, ref32, plain, reps in _cases(dev, dtype, 1, h, w, gen):
                tag = f"{label} {str(dtype)[6:]} {h}x{w}"
                err = _compare(tag, kern(), ref32(), dtype, BF16_BOUNDS[name])
                if not timed:
                    continue
                p1, k1, k2, p2 = (_timed(f, reps) for f in (plain, kern, kern, plain))
                rate = (f"{FLOP_PER_PIXEL[label] * h * w / (k1 + k2) * 2e-9:.1f} TFLOP/s"
                        if label in FLOP_PER_PIXEL else "")
                print(f"[time] {tag}: kernel {k1:.3f} / {k2:.3f} ms, "
                      f"plain {p1:.3f} / {p2:.3f} ms {rate}")
                if dtype == torch.float32:
                    rows.setdefault(name, []).append((err, (k1 + k2) / 2, (p1 + p2) / 2))
            torch.cuda.empty_cache()
    return {
        name: (max(r[0] for r in rs), sum(r[1] for r in rs) / len(rs),
               sum(r[2] for r in rs) / len(rs))
        for name, rs in rows.items()
    }


def phase_main_path(dev):
    """tools/torch_test.py on a REDS4-layout 720p fixture (PNG frames, MV
    sidecars, qp.json) written by tools/data/make_protocol_fixture.py."""
    import numpy as np
    import torch

    from pnp_vcve_tpu.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import REDS4_CLIPS, write_fixture

    work = ROOT / "build" / "chip_smoke"
    h, w = MAIN_HW
    t0 = time.perf_counter()
    write_fixture(work / "data", clips=REDS4_CLIPS[:CLIPS], frames=FRAMES, height=h,
                  width=w, crf=15, seed=SEED, quiet=True)
    cfg = work / "serving_720p.py"
    # the flagship serving config, pointed at the fixture (its qp.json sits
    # inside the test pipeline, which --testdir_* do not reach)
    cfg.write_text(
        f"_base_ = [{str(ROOT / 'configs' / 'HR_davis_LR_128x128_serving_tpu.py')!r}]\n"
        "from pnp_vcve_tpu.core.presets import flagship_data\n"
        f"data = flagship_data(test_lq={str(work / 'data/crf15/png')!r}, "
        f"test_gt={str(work / 'data/sharp/png')!r}, "
        f"test_qp_json={str(work / 'data/qp.json')!r})\n"
        f"data['test']['num_input_frames'] = {FRAMES}\n"
    )
    print(f"[main] fixture: {CLIPS} clips x {FRAMES} frames at {h}x{w} "
          f"in {time.perf_counter() - t0:.1f} s")

    fwd_s = []  # generator forward time per clip, device-synchronised

    def tic(module, args):
        if isinstance(module, PnPVCVE):
            torch.cuda.synchronize()
            fwd_s.append(-time.perf_counter())

    def toc(module, args, out):
        if isinstance(module, PnPVCVE):
            torch.cuda.synchronize()
            fwd_s[-1] += time.perf_counter()

    pre = torch.nn.modules.module.register_module_forward_pre_hook(tic)
    post = torch.nn.modules.module.register_module_forward_hook(toc)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out_dir = work / "out"
    metrics = torch_test.main([
        str(cfg), str(ROOT / "tests/fixtures/parity/state_dict.npz"), "--device", dev.type,
        "--save-path", str(out_dir), "--save-image",
    ])
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    pre.remove()
    post.remove()

    nb = Config.fromfile(cfg).model["generator"]["num_blocks"]
    n = CLIPS * FRAMES
    want = {"warp": 2 * n, "input_conv": 2 * n, "drt_block": 2 * nb * n, "head": n}
    print(f"[main] launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError("main path did not run every step through the kernels")
    if set(metrics) != {"PSNR", "SSIM"} or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"main path metrics missing or not finite: {metrics}")
    pngs = sorted(out_dir.glob("*/*.png"))
    if len(pngs) != n:
        raise AssertionError(f"expected {n} enhanced frames under {out_dir}, found {len(pngs)}")
    print(f"[main] {n} frames at {h}x{w}: generator {sum(fwd_s):.3f} s = "
          f"{n / sum(fwd_s):.3f} frames/s; tools/torch_test.py incl. loading and "
          f"host metrics {wall:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def phase_model_vs_plain(dev):
    import numpy as np
    import torch

    from pnp_vcve_tpu.core.config import Config
    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.kernels import KERNELS, PLAIN

    cfg = Config.fromfile(ROOT / "configs" / "HR_davis_LR_128x128_serving_tpu.py")
    model = build_generator(cfg.model["generator"], device=dev)
    load_generator_weights(model, str(ROOT / "tests/fixtures/parity/state_dict.npz"))

    # one clip: 8x8-block-constant MVs, one-hot partitions, I/P/B slices
    rng = np.random.default_rng(SEED)
    t, h, w = FRAMES, 256, 448
    up = lambda a: np.repeat(np.repeat(a, 8, 2), 8, 3)  # noqa: E731
    slices = np.full((1, t), 66.0, np.float32)
    slices[:, ::4] = 80.0
    slices[:, 0] = 73.0
    inputs = dict(
        lrs=rng.random((1, t, h, w, 3), dtype=np.float32),
        qps=(rng.integers(20, 40, (1, t)) / 255.0).astype(np.float32),
        slices=slices,
        mvs=up((rng.standard_normal((1, t, h // 8, w // 8, 4)) * 6).astype(np.float32)),
        base_qps=np.full((1, t), 35 / 255.0, np.float32),
        par_map=up(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, t, h // 8, w // 8))]
                   / 255.0),
    )
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in inputs.items()}
    with torch.inference_mode():
        got = model(**inputs)
        model.ops = PLAIN
        want = model(**inputs)
        model.ops = KERNELS
    if got.shape != (1, t, h, w, 3) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"model output {tuple(got.shape)} not finite/of the expected shape")
    err = float((got - want).abs().max())
    print(f"[model] kernel path vs plain path, {t} frames {h}x{w} float32: "
          f"max|diff| {err:.3g} (<= {TOL_MODEL})")
    if not err <= TOL_MODEL:
        raise AssertionError("model kernel path disagrees with its plain path")


def main():
    sys.path.insert(0, str(ROOT))
    dev = phase_device()
    phase_build()
    kern = phase_kernels(dev)
    counts = phase_main_path(dev)
    phase_model_vs_plain(dev)

    import torch

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": kern[name][0],
         "ms": kern[name][1], "plain_ms": kern[name][2]}
        for name, (src, rep) in KERNEL_INFO.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
