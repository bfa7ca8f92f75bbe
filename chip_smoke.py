#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pnp_vcve_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases (any failure raises and the script exits non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels from pnp_vcve_torch/kernels/csrc (nvcc, sm_90a)
   and print the compiler's register / shared-memory / spill report;
3. each kernel against its plain PyTorch version at the main path's shapes
   (b=1, 720x1280, 64 channels), at b=4 on a smaller frame (256x448) and at
   ragged sizes (36x52; 40x56 for K1b, which needs multiples of 8), in
   float32 (TF32 off; max|diff| <= 1e-4 std) and bfloat16 (max < 0.02 std,
   mean < 0.002 std; the warps 0.08 / 0.01; the input conv's and K5's max
   0.04 std, see BF16_BOUNDS); K1b on block-constant flows up to +-24 px,
   so that its +-16 px clamp bites; K3s's new_last_key bitwise equal to ``torch.where``
   on its own out for a keyframe sample and a non-keyframe one; K3 also
   called with the argument order of the TPU's per-block DRT kernels
   (``drt_block_pallas``, ``drt_block_packed``); K5 (the per-sample 3x3
   conv) at 64 -> 64, at 720p also for b=2 with its own kernels per
   sample, and at the ragged size for c_in in {3, 8, 64} and c_out in
   {8, 64}. At 720p each is timed with CUDA events in turns (plain,
   kernel, kernel, plain), beside one PyTorch call that computes the same
   function where there is one (``F.grid_sample`` for the warps, one
   ``F.conv2d`` over the concatenated parts for the input conv, one
   ``F.conv2d`` with ``groups=b`` for K5), its yardsticks (K1b: K1 on the
   same flow; K3s: K3 plus ``torch.where``) and the card's bound for the
   work (bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s,
   whichever is larger);
4. the main path: ``tools/torch_test.py`` with the port's flagship serving
   config (``warp_impl='pf'``) and the parity fixture's weights on a
   REDS4-layout fixture of 4 clips x 8 frames at 720x1280 (PNG frames, MV
   sidecars, qp.json) that tools/data/make_protocol_fixture.py writes under
   build/chip_smoke/; the launch counts must be, per frame, 2 block warps
   (K1b), 2 input convs, 14 DRT blocks, 2 key-select blocks (K3s), 1 head
   and no per-pixel warp (K1);
5. the serving model's kernel path against its plain path on one clip of
   8 frames at 256x448 with block-constant MVs up to +-24 px
   (max|diff| <= 3e-3, float32), and, on the same inputs, its output
   against the ``block8`` model's on the MVs clamped to +-16 px beforehand
   (the same bound);
6. gradients at the flagship width (64 channels, 8 blocks, 6 experts): one
   Charbonnier loss on b=2 clips of 4 frames at 192x256, backpropagated
   through the kernels and through the plain path (float32, TF32 off);
   every parameter's gradient within 1e-3 of its largest plain entry, the
   losses within 1e-5 relative. The frames are not smaller because the
   partition 1x1 convs' weight gradients (sums of x * par / 255 over a third
   of the pixels, gated by a ReLU) shift with the float rounding of the
   forward by an amount that falls with the pixel count: at 64x96 it
   reached 1.2e-3 of the largest entry;
7. training: ``tools/torch_train.py`` with the port's flagship training
   config (b=5, 15 frames, 128x128 crops, Adam, cosine restart, remat) on a
   DAVIS-layout fixture of 2 clips x 20 frames at 256x256 (CRF 15/25/35 and
   sharp) under build/chip_smoke/train: 4 iterations with a checkpoint at 2,
   then a resume from 2 for 2 more, with cuDNN and PyTorch held to
   deterministic algorithms; the loss must be finite, the launch counts
   those of the forward and the remat recompute (K1, not K1b or K3s), and
   the resumed weights equal to the uninterrupted run's. Seconds per
   iteration, iterations/s and peak device memory are printed, and
   ``torch.profiler``'s split of the resumed run's last iteration: device
   time by kernel, the share of the port's kernels and the device's idle
   share;
8. batched serving: ``pnp_vcve_torch.serving.StreamScheduler`` with
   ``batched_forward_executor`` (max_batch 4) on the serving config and the
   parity weights; three streams submit 2 clips each, 6 clips of 8 frames
   at 720x1280 with their own I/P/B slices and 16x16-block MVs; each
   stream must complete in order, one dispatch must carry >= 3 clips, each
   clip must be within 1e-4 (float32) of the same clip enhanced alone, and
   the launch counts those of 8 frames per dispatch (one launch serves all
   the clips of a dispatch). Dispatch sizes and walls, per-clip
   latency p50/p95, aggregate frames/s and peak device memory are printed;
9. the latency/throughput curve: ``tools/torch_serving_curve.py --max-b 4
   --t 8 --iters 2`` (720p, bfloat16) in a subprocess, a row for each b;
10. the HTTP handler: a servable packed by ``tools/torch_pnp2servable.py``
   from the serving config and the parity weights, served by
   ``tools/torch_serving_handler.py`` on a free local port; 3 POSTed PNG
   frames of 720x1280 must come back as PNGs equal, as uint8, to
   ``pnp_vcve_torch.apis.restoration_inference`` on the same frames, with
   the serving path's launches per frame; the health check must answer;
11. the block forms: the training config at full width (64 channels,
   8 blocks, 6 experts) built through ``build_restorer`` with
   blocktype='drt_woqp', one_layer=False and channel_first=False in turn,
   the parity fixture's weights where they fit: each kernel path against
   its plain path on one clip of 8 frames at 256x448 (max|diff| <= 3e-3),
   then a 720p clip of 8 frames, once untimed and twice timed, with the
   last run's launch counts, and for the K5 forms once more under
   ``torch.profiler`` (device busy time, idle share, K5's share) (per
   frame 2 K1, 2 K2, 1 K4 and 16 K3 under 'drt_woqp', 32 K5 in the other
   two); for one_layer=False also phase 6's gradient check at 192x256;
12. the probes (B10a): ``tools/torch_int8_probe.py``,
   ``tools/torch_warp_kernel_probe2.py`` and ``tools/torch_warp_bisect.py``
   (all five stages) at their JAX files' shapes on the card, the probe
   kernels' counts (``kernels/probes.py: LAUNCHES``) zeroed before and read
   after, each of K6-K10 launched; then every stage's output against its
   plain version on the same inputs (K6, the int8 forms of K8 and K10, and
   K9's q and s bitwise; the bf16 forms of K8 and K10 max|diff| <= 1e-5
   max|ref|; K7 phase 3's bf16 bounds), timed in turns beside it, beside
   ``torch.matmul`` (k1, bf16 out), ``torch._int_mm`` (k2), ``F.conv2d``
   (k5, bf16 out) or ``torch.mul`` on the strided window (K6 without a
   period) and beside its bound (``tools/torch_kernel_bounds.py``'s work
   functions on this run's shapes and, for K7, the non-zeros of its S and
   vm); and K10 in bf16 and int8 at K5's geometry (720x1280, 64 -> 64)
   beside K5 and one cuDNN conv, a measurement only.

Each phase prints its wall time.
The line before the last is a JSON object with each kernel's launches
(``launches``: all the driven paths together, each path's counts zeroed just
before it and read just after; then each path's own: the serving path of
phase 4, the batched path of phase 8, the handler of phase 10, training in
phase 7, each block form's last 720p run in phase 11; the probe tools'
run of phase 12 for K6-K10), its error, its time beside the plain
version's, the library call's, its yardsticks' and the bound (K6-K10: the
headline stage, every stage under ``forms``); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIGS = ROOT / "pnp_vcve_torch" / "configs"

SEED = 0
MAIN_HW = (720, 1280)
RAGGED_HW = (36, 52)
BLOCK_RAGGED_HW = (40, 56)  # K1b needs multiples of 8
BATCH_B, BATCH_HW = 4, (256, 448)
CLIPS, FRAMES = 4, 8
TOL_MODEL = 3e-3
MV_REACH = 24.0  # block-constant MVs up to +-24 px: K1b's +-16 px clamp bites
# phase 8: three streams of two clips each, max_batch 4
STREAMS, CLIPS_PER_STREAM, MAX_BATCH, TOL_BATCHED = 3, 2, 4, 1e-4
HANDLER_FRAMES = 3
# bfloat16 (max, mean) bounds in units of std(ref): tests/test_tpu_parity.py
# :43-51, the warp's :71 and the input conv's max from :137 -- its leaky-ReLU
# output reaches ~9.6 std, where bfloat16's own half-ulp rounding of the
# output is already 0.019-0.038 std. K5's max takes the same 0.04: its output
# (no residual, the gain folded in) reaches 5.5 std, and an output in [2, 4)
# at std 0.378 rounds by up to 2^-7 = 0.0207 std (measured 0.00777)
BF16_BOUNDS = {"warp": (0.08, 0.01), "warp_block": (0.08, 0.01), "input_conv": (0.04, 0.002),
               "drt_block": (0.02, 0.002), "drt_block_select": (0.02, 0.002),
               "head": (0.02, 0.002), "conv3x3": (0.04, 0.002)}
# K5 at the ragged size: the 3-channel frame, 8 channels and the model's 64
CONV_RAGGED_CHANNELS = [(ci, co) for ci in (3, 8, 64) for co in (8, 64)]

# FLOP per output pixel at 64 channels (2 per multiply-add), from the shapes
FLOP_PER_PIXEL = {
    "input_conv (backward, 3 parts)": 2 * 9 * (3 + 128) * 64,
    "input_conv (forward, 4 parts)": 2 * 9 * (3 + 192) * 64,
    "drt_block": 2 * (9 * 64 * 64 + 3 * 64 * 64 + 9 * 64 * 64),
    "drt_block_select": 2 * (9 * 64 * 64 + 3 * 64 * 64 + 9 * 64 * 64),
    "head": 2 * 9 * 64 * (64 + 3),
    "conv3x3": 2 * 9 * 64 * 64,
}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3, float32 on
# the CUDA cores, dense bf16 on the tensor cores
HBM_BYTES_S, F32_FLOP_S, BF16_TC_FLOP_S = 3.35e12, 67e12, 989e12
GRAD_TOL, LOSS_RTOL = 1e-3, 1e-5
TRAIN_FRAMES, TRAIN_HW, TRAIN_ITERS = 20, (256, 256), 4

KERNEL_INFO = {  # name -> (source, TPU kernel it replaces)
    "warp": ("pnp_vcve_torch/kernels/csrc/warp.cu", "pnp_vcve_tpu/kernels/warp_pf.py:488"),
    "warp_block": ("pnp_vcve_torch/kernels/csrc/warp_block.cu",
                   "pnp_vcve_tpu/kernels/warp_pf.py:552"),
    "input_conv": ("pnp_vcve_torch/kernels/csrc/input_conv.cu",
                   "pnp_vcve_tpu/kernels/drt_stack.py:649"),
    "drt_block": ("pnp_vcve_torch/kernels/csrc/drt_block.cu",
                  "pnp_vcve_tpu/kernels/drt_stack.py:305"),
    "drt_block_select": ("pnp_vcve_torch/kernels/csrc/drt_block.cu",
                         "pnp_vcve_tpu/kernels/drt_stack.py:278"),
    "head": ("pnp_vcve_torch/kernels/csrc/head.cu", "pnp_vcve_tpu/kernels/drt_stack.py:1058"),
    "conv3x3": ("pnp_vcve_torch/kernels/csrc/conv3x3.cu",
                "pnp_vcve_tpu/kernels/conv_block.py:86"),
}
# the other TPU functions a kernel computes (B8, B9): the same math in another layout
ALSO_REPLACES = {
    "drt_block": ["pnp_vcve_tpu/kernels/drt_packed.py:149",
                  "pnp_vcve_tpu/kernels/conv_block.py:180"],
    "conv3x3": ["pnp_vcve_tpu/kernels/conv_packed.py:48",
                "pnp_vcve_tpu/kernels/conv_packed.py:118"],
}
# phase 11: the block forms of the training config (models/bae.py)
BLOCK_FORMS = {"drt_woqp": dict(blocktype="drt_woqp"), "one_layer_false": dict(one_layer=False),
               "channel_first_false": dict(channel_first=False)}
FORMS_HW = (256, 448)
GRAD_B, GRAD_T, GRAD_HW = 2, 4, (192, 256)  # phases 6 and 11
# phase 12: the probe kernels K6-K10 -> (source, the TPU function it
# replaces, the others), each at its pallas_call
PROBE_INFO = {
    "window_copy": ("pnp_vcve_torch/kernels/csrc/probe_copy.cu", "tools/warp_kernel_probe2.py:78",
                    ["tools/warp_bisect.py:52", "tools/warp_bisect.py:72"]),
    "mmsel": ("pnp_vcve_torch/kernels/csrc/probe_mmsel.cu", "tools/warp_kernel_probe2.py:126",
              ["tools/warp_bisect.py:105"]),
    "matmul": ("pnp_vcve_torch/kernels/csrc/probe_matmul.cu", "tools/int8_probe.py:70",
               ["tools/int8_probe.py:80", "tools/int8_probe.py:100"]),
    "absmax_quantize": ("pnp_vcve_torch/kernels/csrc/probe_matmul.cu", "tools/int8_probe.py:100",
                        ["tools/int8_probe.py:127"]),
    "tapconv": ("pnp_vcve_torch/kernels/csrc/probe_tapconv.cu", "tools/int8_probe.py:148",
                ["tools/int8_probe.py:127"]),
}
K5_GEOMETRY = (720, 1280, 64)  # K10 timed at K5's frame, 64 -> 64 (measurement only)


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
    return torch.device("cuda", 0), smi


def phase_build():
    from pnp_vcve_torch.kernels.build import SMEM_REPORT, library

    t0 = time.perf_counter()
    lib = library()
    print(f"[build] {lib.path} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {lib.build_seconds:.1f} s)")
    for line in lib.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            print("[build]", line.strip())
    smem = {n: getattr(lib.lib, f"pnp_{n}_smem")() for n in SMEM_REPORT}
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


def _grid(flow, h, w, dtype):
    """grid_sample's normalised grid for a pixel flow (align_corners=True)."""
    import torch

    dev = flow.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    return torch.stack([(xs + flow[..., 0].float()) * 2 / (w - 1) - 1,
                        (ys + flow[..., 1].float()) * 2 / (h - 1) - 1], -1).to(dtype)


def _cases(dev, dtype, b, h, w, gen):
    """One dict per case: label, kernel name, the kernel call, the plain
    call in float32 on the same values, the plain call in the working type,
    the library call (or None), yardsticks to time beside it, an extra
    check (or None), reps for timing, and the bytes the function must move
    (each input read once, each output written once)."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import KERNELS, PLAIN
    from pnp_vcve_torch.kernels.drt_stack import part_kernels
    from pnp_vcve_torch.ops.warp import PF_MAX_MV, block_flow

    def feat(c):
        return torch.randn((b, h, w, c), generator=gen).to(dev, dtype)

    def wt(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    x = feat(64)
    # block-constant motion vectors as the rasterizer emits them, +-24 px
    fb = torch.rand((b, -(-h // 8), -(-w // 8), 2), generator=gen) * (2 * MV_REACH) - MV_REACH
    flow = fb.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w].contiguous()
    flow = flow.to(dev, dtype)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    grid = _grid(flow, h, w, dtype)
    cases = [dict(
        label="warp", name="warp", kern=lambda: KERNELS.flow_warp(x, flow),
        ref32=lambda: PLAIN.flow_warp(x.float(), flow.float()),
        plain=lambda: PLAIN.flow_warp(x, flow),
        library=lambda: F.grid_sample(x_nchw, grid, mode="bilinear", padding_mode="zeros",
                                      align_corners=True),
        yardsticks={}, check=None, reps=20, bytes=nbytes(x, flow, x))]
    if h % 8 == 0 and w % 8 == 0:
        table = block_flow(flow, PF_MAX_MV)
        # grid_sample on the same flow: the clamped table expanded per pixel
        grid_b = _grid(table.repeat_interleave(8, 1).repeat_interleave(8, 2), h, w, dtype)
        cases.append(dict(
            label="warp_block", name="warp_block",
            kern=lambda: KERNELS.flow_warp_block(x, flow, PF_MAX_MV),
            ref32=lambda: PLAIN.flow_warp_block(x.float(), flow.float(), PF_MAX_MV),
            plain=lambda: PLAIN.flow_warp_block(x, flow, PF_MAX_MV),
            library=lambda: F.grid_sample(x_nchw, grid_b, mode="bilinear",
                                          padding_mode="zeros", align_corners=True),
            yardsticks={"k1_ms": lambda: KERNELS.flow_warp(x, flow)}, check=None, reps=20,
            bytes=nbytes(x, table, x)))
    gate = torch.ones(b, device=dev)
    for n_parts, tag in ((3, "backward"), (4, "forward")):
        parts = [feat(3)] + [feat(64) for _ in range(n_parts - 1)]
        kernel = wt((3, 3, 3 + 64 * (n_parts - 1), 64), 0.03)
        bias = wt((64,), 0.1)
        ks = part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
        cat = torch.cat(parts, -1).permute(0, 3, 1, 2).contiguous()
        w_oihw = kernel.permute(3, 2, 0, 1).contiguous().to(dtype)
        cases.append(dict(
            label=f"input_conv ({tag}, {n_parts} parts)", name="input_conv",
            kern=lambda p=parts, k=ks, bb=bias: KERNELS.input_conv(p, k, bb),
            ref32=lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(f32(p), k, bb),
            plain=lambda p=parts, k=ks, bb=bias: PLAIN.input_conv(p, k, bb),
            library=lambda c=cat, k=w_oihw, bb=bias.to(dtype): F.conv2d(c, k, bb, padding=1),
            yardsticks={}, check=None, reps=5, bytes=nbytes(*parts, *ks, bias, x)))
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    blk = (wt((b, 3, 3, 64, 64), 0.03), wt((b, 64), 0.1),
           torch.rand((b, 64), generator=gen).to(dev),
           wt((64, 3, 64), 0.03), wt((3, 3, 64, 64), 0.03), wt((64,), 0.1))
    cases.append(dict(
        label="drt_block", name="drt_block", kern=lambda: KERNELS.drt_block(x, par, *blk),
        ref32=lambda: PLAIN.drt_block(x.float(), par.float(), *blk),
        plain=lambda: PLAIN.drt_block(x, par, *blk), library=None, yardsticks={},
        check=None, reps=5, bytes=nbytes(x, par, *blk, x)))
    last_key = feat(64)
    is_key = (torch.arange(b, device=dev) % 2 == 0).float()  # keyframes and not

    def select_check():
        """new_last_key is bitwise torch.where on K3s's own out, for each
        sample's flag and its opposite."""
        for key in (is_key, 1.0 - is_key):
            out, new_lk = KERNELS.drt_block_select(x, par, *blk, last_key, key)
            want = torch.where(key.reshape(-1, 1, 1, 1) > 0.5, out, last_key)
            if not torch.equal(new_lk.view(torch.int16 if dtype == torch.bfloat16 else
                                           torch.int32),
                               want.view(torch.int16 if dtype == torch.bfloat16 else
                                         torch.int32)):
                raise AssertionError("drt_block_select: new_last_key is not the select of out")
        return "new_last_key == where(is_key, out, last_key) bitwise, both flags"

    cases.append(dict(
        label="drt_block_select", name="drt_block_select",
        kern=lambda: KERNELS.drt_block_select(x, par, *blk, last_key, is_key)[0],
        ref32=lambda: PLAIN.drt_block(x.float(), par.float(), *blk),
        plain=lambda: PLAIN.drt_block_select(x, par, *blk, last_key, is_key),
        library=None,
        yardsticks={"k3_where_ms": lambda: torch.where(
            is_key.reshape(-1, 1, 1, 1) > 0.5, KERNELS.drt_block(x, par, *blk), last_key)},
        check=select_check, reps=5, bytes=nbytes(x, par, *blk, last_key, is_key, x, x)))
    if (h, w) in (MAIN_HW, RAGGED_HW):
        # K3 called with drt_block_pallas's / drt_block_packed's argument order
        # (x, par, dyn_kernels, dyn_biases, par_kernel, conv1_kernel, conv1_bias,
        # gamma), the B8/B9 entry: the same wrapper, its arguments reordered
        def pallas_order(fn):
            return lambda x_, p_, dk, db, pk, k1, b1, g: fn(x_, p_, dk, db, g, pk, k1, b1)

        jargs = (blk[0], blk[1], blk[3], blk[4], blk[5], blk[2])
        cases.append(dict(
            label="drt_block (drt_block_pallas argument order)", name="drt_block",
            kern=lambda: pallas_order(KERNELS.drt_block)(x, par, *jargs),
            ref32=lambda: pallas_order(PLAIN.drt_block)(x.float(), par.float(), *jargs),
            plain=lambda: pallas_order(PLAIN.drt_block)(x, par, *jargs), library=None,
            yardsticks={}, check=None, reps=5, time=False, bytes=nbytes(x, par, *blk, x)))
    hd = (wt((3, 3, 64, 64), 0.03), wt((64,), 0.1), wt((3, 3, 64, 3), 0.06), wt((3,), 0.1))
    cases.append(dict(
        label="head", name="head", kern=lambda: KERNELS.head(x, *hd),
        ref32=lambda: PLAIN.head(x.float(), *hd), plain=lambda: PLAIN.head(x, *hd),
        library=None, yardsticks={}, check=None, reps=5,
        bytes=nbytes(x, *hd) + b * h * w * 3 * x.element_size()))

    def conv_case(bb, c_in, c_out, timed):
        """K5 with per-sample kernels, biases and gains; the library call is
        one F.conv2d with groups=bb on the same kernels (the gain folded in),
        the grouped-conv form of ops/dynamic_conv.py: per_sample_conv."""
        xc = x if (bb, c_in) == (b, 64) else torch.randn((bb, h, w, c_in), generator=gen).to(
            dev, dtype)
        k, bias = wt((bb, 3, 3, c_in, c_out), 0.03), wt((bb, c_out), 0.1)
        g = torch.rand((bb, c_out), generator=gen).to(dev)
        xg = xc.permute(0, 3, 1, 2).reshape(1, bb * c_in, h, w).contiguous()
        wg = ((k * g[:, None, None, None, :]).permute(0, 4, 3, 1, 2)
              .reshape(bb * c_out, c_in, 3, 3).to(dtype).contiguous())
        bg = (bias * g).reshape(-1).to(dtype)
        main = (bb, c_in, c_out) == (b, 64, 64)
        return dict(
            label="conv3x3" if main else f"conv3x3 ({c_in}->{c_out}, b={bb})", name="conv3x3",
            kern=lambda: KERNELS.conv3x3(xc, k, bias, g),
            ref32=lambda: PLAIN.conv3x3(xc.float(), k, bias, g),
            plain=lambda: PLAIN.conv3x3(xc, k, bias, g),
            library=lambda: F.conv2d(xg, wg, bg, padding=1, groups=bb),
            yardsticks={}, check=None, reps=5, time=timed,
            bytes=nbytes(xc, k, bias, g) + bb * h * w * c_out * xc.element_size())

    # K5 at the model's 64 -> 64; at 720p also two samples with their own
    # kernels; at the ragged size every pair of CONV_RAGGED_CHANNELS
    cases.append(conv_case(b, 64, 64, True))
    if (b, h, w) == (1, *MAIN_HW):
        cases.append(conv_case(2, 64, 64, False))
    if (h, w) == RAGGED_HW:
        cases += [conv_case(b, ci, co, False) for ci, co in CONV_RAGGED_CHANNELS
                  if (ci, co) != (64, 64)]
    return cases


def phase_kernels(dev):
    """Returns {kernel: row} in float32 at 720p: the worst error, the mean
    times of the kernel, its plain version, the library call and the
    yardsticks, and the bounds. The input conv's row covers its two forms
    (worst error, mean time and bound)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    rows = {}
    sizes = ((1, MAIN_HW, True), (BATCH_B, BATCH_HW, False), (1, RAGGED_HW, False),
             (1, BLOCK_RAGGED_HW, False))
    for dtype in (torch.float32, torch.bfloat16):
        for b, (h, w), timed in sizes:
            for c in _cases(dev, dtype, b, h, w, gen):
                tag = f"{c['label']} {str(dtype)[6:]} b={b} {h}x{w}"
                err = _compare(tag, c["kern"](), c["ref32"](), dtype, BF16_BOUNDS[c["name"]])
                if c["check"] is not None:
                    print(f"[kernel] {tag}: {c['check']()}")
                if not (timed and c.get("time", True)):
                    continue
                p1, k1, k2, p2 = (_timed(f, c["reps"])
                                  for f in (c["plain"], c["kern"], c["kern"], c["plain"]))
                lib = _timed(c["library"], c["reps"]) if c["library"] else None
                yard = {k: _timed(f, c["reps"]) for k, f in c["yardsticks"].items()}
                flop = FLOP_PER_PIXEL.get(c["label"], 0) * b * h * w
                t_bytes, t_ops = c["bytes"] / HBM_BYTES_S * 1e3, flop / F32_FLOP_S * 1e3
                rate = f"{flop / (k1 + k2) * 2e-9:.1f} TFLOP/s, " if flop else ""
                yard_txt = "".join(f", {k[:-3]} {v:.3f} ms" for k, v in yard.items())
                print(f"[time] {tag}: kernel {k1:.3f} / {k2:.3f} ms, "
                      f"plain {p1:.3f} / {p2:.3f} ms, library "
                      f"{'none' if lib is None else f'{lib:.3f} ms'}{yard_txt}; {rate}"
                      f"{c['bytes'] / ((k1 + k2) / 2) * 1e-6:.0f} GB/s; bound "
                      f"{max(t_bytes, t_ops):.3f} ms (bytes {t_bytes:.3f}, float32 ops "
                      f"{t_ops:.3f}, bf16 tensor-core ops {flop / BF16_TC_FLOP_S * 1e3:.3f})")
                if dtype == torch.float32:
                    rows.setdefault(c["name"], []).append(dict(
                        err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib,
                        t_bytes=t_bytes, t_ops=t_ops, t_bf16=flop / BF16_TC_FLOP_S * 1e3,
                        **yard))
            torch.cuda.empty_cache()

    def mean(rs, k):
        return None if rs[0][k] is None else sum(r[k] for r in rs) / len(rs)

    out = {}
    for name, rs in rows.items():
        t_bytes, t_ops = mean(rs, "t_bytes"), mean(rs, "t_ops")
        extra = {k: mean(rs, k) for k in rs[0] if k.endswith("_ms") and k != "library_ms"}
        out[name] = dict(
            max_abs_err=max(r["err"] for r in rs), ms=mean(rs, "ms"),
            plain_ms=mean(rs, "plain_ms"), bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=mean(rs, "library_ms"), bound_bf16_tensor_ms=mean(rs, "t_bf16"),
            **{k: v for k, v in extra.items() if k not in ("ms", "plain_ms")})
    return out


def phase_main_path(dev):
    """tools/torch_test.py on a REDS4-layout 720p fixture (PNG frames, MV
    sidecars, qp.json) written by tools/data/make_protocol_fixture.py."""
    import numpy as np
    import torch

    from pnp_vcve_torch.core.config import Config
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
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128_serving.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
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

    gen_cfg = Config.fromfile(cfg).model["generator"]
    n = CLIPS * FRAMES
    want = _launches_per_pass(n, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
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


def _clip_inputs(rng, b, t, h, w, dev, mv_reach=None, mv_block=8):
    """b clips of t frames: MVs constant over mv_block x mv_block blocks
    (normal, 6 px std; or uniform up to +-mv_reach), one-hot partitions,
    I/P/B slices, as the rasterizer and the codec give them."""
    import numpy as np
    import torch

    up = lambda a, k=8: np.repeat(np.repeat(a, k, 2), k, 3)  # noqa: E731
    slices = np.full((b, t), 66.0, np.float32)
    slices[:, ::4] = 80.0
    slices[:, 0] = 73.0
    shape = (b, t, h // mv_block, w // mv_block, 4)
    mv = (rng.standard_normal(shape) * 6 if mv_reach is None
          else rng.uniform(-mv_reach, mv_reach, shape))
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), dtype=np.float32),
        qps=(rng.integers(20, 40, (b, t)) / 255.0).astype(np.float32),
        slices=slices,
        mvs=up(mv.astype(np.float32), mv_block),
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=up(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h // 8, w // 8))]
                   / 255.0),
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in inputs.items()}


def _flagship_generator(config, dev):
    """The config's generator with the parity fixture's weights, and the
    config."""
    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(CONFIGS / config)
    model = build_generator(cfg.model["generator"], device=dev)
    load_generator_weights(model, str(ROOT / "tests/fixtures/parity/state_dict.npz"))
    return model, cfg


def _launches_per_pass(t, num_blocks, warp_impl="padgather", fused_blocks=True):
    """Kernel launches of one forward over t frames: each sweep step warps
    (K1b under 'pf', K1 in training), runs the input conv and the blocks
    (under 'pf' the last is K3s; the unfused block forms run two K5 per
    block instead of one K3); the forward sweep's steps run the head."""
    pf = warp_impl == "pf"
    k3 = 2 * (num_blocks - pf) * t if fused_blocks else 0
    return {"warp": 0 if pf else 2 * t, "warp_block": 2 * t if pf else 0,
            "input_conv": 2 * t, "drt_block": k3, "drt_block_select": 2 * t if pf else 0,
            "head": t, "conv3x3": 0 if fused_blocks else 4 * num_blocks * t}


def phase_model_vs_plain(dev):
    """The serving model ('pf') through its kernels against its plain path
    on MVs up to +-24 px, and against the 'block8' model on the MVs clamped
    to +-16 px beforehand."""
    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.ops.warp import PF_MAX_MV

    model, cfg = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    t, h, w = FRAMES, 256, 448
    inputs = _clip_inputs(np.random.default_rng(SEED), 1, t, h, w, dev, mv_reach=MV_REACH)
    clamped = {**inputs, "mvs": inputs["mvs"].clamp(-PF_MAX_MV, PF_MAX_MV)}
    with torch.inference_mode():
        reset_launches()
        got = model(**inputs)
        counts = dict(LAUNCHES)
        model.ops = PLAIN
        want = model(**inputs)
        model.ops = KERNELS
        model.warp_impl = "block8"
        block8 = model(**clamped)
        model.warp_impl = "pf"
    if got.shape != (1, t, h, w, 3) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"model output {tuple(got.shape)} not finite/of the expected shape")
    gen_cfg = cfg.model["generator"]
    expected = _launches_per_pass(t, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
    if counts != expected:
        raise AssertionError(f"pf launches {counts}, expected {expected}")
    err = float((got - want).abs().max())
    err8 = float((got - block8).abs().max())
    print(f"[model] pf kernel path vs plain path, {t} frames {h}x{w} float32, MVs to "
          f"+-{MV_REACH:g} px: max|diff| {err:.3g}; vs the block8 kernel path on MVs clamped "
          f"to +-{PF_MAX_MV:g} px: max|diff| {err8:.3g} (each <= {TOL_MODEL})")
    if not (err <= TOL_MODEL and err8 <= TOL_MODEL):
        raise AssertionError("pf model kernel path disagrees with its plain path or block8")


def phase_grads(dev):
    """One Charbonnier loss at the flagship width through the kernels
    (forward kernels, plain-version backward in each Function, the remat
    recompute) and through the plain path; every parameter's gradient is
    held to the plain one."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg = _flagship_generator("HR_davis_LR_128x128.py", dev)
    gen_cfg = cfg.model["generator"]
    return _grad_check("grad", model, gen_cfg,
                       _launches_per_pass(GRAD_T, gen_cfg["num_blocks"]), SEED + 6, dev)


def _grad_check(tag, model, gen_cfg, per_pass, seed, dev):
    """One Charbonnier loss on GRAD_B clips of GRAD_T frames at GRAD_HW
    through the kernels and through the plain path (float32, TF32 off):
    the kernel path's launches must be ``per_pass`` (twice with remat; none
    in the backward), every parameter's gradient within GRAD_TOL of its
    largest plain entry and the losses within LOSS_RTOL. Returns the worst
    ratio."""
    import math

    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
    from pnp_vcve_torch.train.losses import charbonnier_loss

    rng = np.random.default_rng(seed)
    (b, t), (h, w) = (GRAD_B, GRAD_T), GRAD_HW
    inputs = _clip_inputs(rng, b, t, h, w, dev)
    gt = torch.from_numpy(rng.random((b, t, h, w, 3), dtype=np.float32)).to(dev)
    runs = {}
    for ops in (KERNELS, PLAIN):
        model.ops = ops
        model.zero_grad()
        reset_launches()
        loss = charbonnier_loss(model(**inputs), gt)
        loss.backward()
        torch.cuda.synchronize()
        runs[ops is KERNELS] = (float(loss.detach()), dict(LAUNCHES),
                                {n: p.grad.clone() for n, p in model.named_parameters()})
    model.ops = KERNELS
    (loss_k, counts, g_k), (loss_p, _, g_p) = runs[True], runs[False]
    passes = 2 if gen_cfg.get("remat", True) else 1
    want = {k: passes * v for k, v in per_pass.items()}
    print(f"[{tag}] launches {counts} (expected {want}: the forward"
          f"{' and the remat recompute' if passes == 2 else ''}; none in the backward)")
    if counts != want:
        raise AssertionError("the gradient run did not go through the kernels as expected")
    ratios = {}
    for n, ref in g_p.items():
        if not bool(torch.isfinite(g_k[n]).all()):
            raise AssertionError(f"gradient of {n} not finite")
        # a gradient the kernel path dropped shows as a zero tensor: ratio 1
        diff, scale = float((g_k[n] - ref).abs().max()), float(ref.abs().max())
        ratios[n] = diff / scale if scale else (0.0 if diff == 0 else math.inf)
    worst = max(ratios, key=ratios.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"[{tag}] {len(ratios)} parameter tensors, b={b} t={t} {h}x{w} float32 (TF32 off): "
          f"loss {loss_k:.7f} vs plain {loss_p:.7f} (relative {loss_rel:.3g} <= {LOSS_RTOL}); "
          f"worst tensor {worst}: max|g_kern - g_plain| = {ratios[worst]:.3g} x max|g_plain| "
          f"(<= {GRAD_TOL})")
    if not (loss_rel <= LOSS_RTOL and ratios[worst] <= GRAD_TOL):
        raise AssertionError("kernel-path gradients disagree with the plain path")
    return ratios[worst]


def phase_train(dev, smi):
    """tools/torch_train.py at the flagship training settings on a DAVIS
    fixture: 4 iterations with a checkpoint at 2, then a resume from 2."""
    import math
    import shutil
    import warnings

    import torch
    from torch.optim.optimizer import register_optimizer_step_post_hook
    from torch.profiler import ProfilerActivity, profile, schedule

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches

    sys.path[:0] = [str(ROOT / "tools"), str(ROOT / "tools" / "data")]
    import torch_train
    from make_protocol_fixture import write_fixture

    work = ROOT / "build" / "chip_smoke" / "train"
    if work.exists():
        shutil.rmtree(work)
    data = work / "data"
    t0 = time.perf_counter()
    qp = {}
    # one CRF per call; each call rewrites qp.json, so the three are merged
    for crf in (15, 25, 35):
        write_fixture(data, clips=("bear", "boat"), frames=TRAIN_FRAMES, height=TRAIN_HW[0],
                      width=TRAIN_HW[1], crf=crf, seed=SEED, quiet=True)
        qp.update(json.loads((data / "qp.json").read_text()))
    (data / "qp.json").write_text(json.dumps(qp))
    cfg_path = work / "train_davis.py"
    # the port's flagship training config with data.train pointed at the
    # fixture through the DAVIS type; every other setting as published
    cfg_path.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import train_dataset\n"
        f"data = dict(train=[train_dataset('DAVISMultipleGTMixCompressDataset', {str(data)!r}, "
        f"'sharp', {str(data / 'qp.json')!r})])\n"
    )
    cfg = Config.fromfile(cfg_path)
    print(f"[train] fixture: 2 clips x {TRAIN_FRAMES} frames at {TRAIN_HW[0]}x{TRAIN_HW[1]}, "
          f"CRF 15/25/35 + sharp, in {time.perf_counter() - t0:.1f} s")

    # training keeps PyTorch's defaults (cuDNN convolutions in TF32); the
    # resume check needs deterministic algorithms (cuDNN's weight gradients
    # and the warp's scatter-add otherwise sum with atomics in no fixed order)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    step_end, profiled = [], []

    def on_step(optimizer, args, kwargs):
        torch.cuda.synchronize()
        step_end.append(time.perf_counter())
        for step in profiled:
            step()

    hook = register_optimizer_step_post_hook(on_step)
    options = ["--device", dev.type,
               "--cfg-options", "checkpoint_config.interval=2", "log_config.interval=1"]
    # the profiler records the resumed run's last iteration: it waits
    # through iteration 3 and records from its optimizer step to iteration
    # 4's (the hook steps it); a warm-up step would need a third iteration
    warnings.filterwarnings("ignore", "Profiler won't be using warmup")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=0, active=1, repeat=1))
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        torch_train.main([str(cfg_path), "--work-dir", str(work / "full"),
                          "--total-iters", str(TRAIN_ITERS), *options])
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        steady = (step_end[TRAIN_ITERS - 1] - step_end[0]) / (TRAIN_ITERS - 1)
        reset_launches()
        profiled.append(prof.step)
        prof.start()
        torch_train.main([str(cfg_path), "--work-dir", str(work / "resumed"),
                          "--total-iters", str(TRAIN_ITERS),
                          "--resume-from", str(work / "full" / "ckpt" / "2.pth"), *options])
        prof.stop()
        resumed_counts = dict(LAUNCHES)
    finally:
        hook.remove()
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    _print_breakdown(prof, step_end[-1] - step_end[-2], steady)

    gen_cfg = cfg.model["generator"]
    t = cfg.data["train"][0]["dataset"]["num_input_frames"]
    per_iter = {k: (2 if gen_cfg.get("remat", True) else 1) * v
                for k, v in _launches_per_pass(t, gen_cfg["num_blocks"]).items()}
    want = {k: TRAIN_ITERS * v for k, v in per_iter.items()}
    want_resumed = {k: (TRAIN_ITERS - 2) * v for k, v in per_iter.items()}
    print(f"[train] launches {counts} (expected {want}: per iteration the forward and the "
          f"remat recompute, {t} frames); resumed run {resumed_counts} (expected {want_resumed})")
    if counts != want or resumed_counts != want_resumed:
        raise AssertionError("training did not run every step through the kernels")

    losses = [float(line.split("loss=")[1].split()[0])
              for line in (work / "full" / "train.log").read_text().splitlines()
              if " loss=" in line]
    if len(losses) != TRAIN_ITERS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses missing or not finite: {losses}")
    full = torch.load(work / "full" / "ckpt" / f"{TRAIN_ITERS}.pth", weights_only=True)
    resumed = torch.load(work / "resumed" / "ckpt" / f"{TRAIN_ITERS}.pth", weights_only=True)
    diff = max(float((full["model"][k] - v).abs().max()) for k, v in resumed["model"].items())
    moved = max(float((full["model"][k] - v).abs().max())
                for k, v in torch.load(work / "full" / "ckpt" / "2.pth",
                                       weights_only=True)["model"].items())
    print(f"[train] losses {losses}; resumed run vs uninterrupted run after {TRAIN_ITERS} "
          f"iterations: max|dw| {diff:.3g} (must be 0 under deterministic algorithms; "
          f"the weights moved {moved:.3g} over iterations 3-4)")
    if diff != 0 or not resumed["step"] == full["step"] == TRAIN_ITERS:
        raise AssertionError("the resumed run does not end where the uninterrupted run ends")
    # steady: iterations 2-4 of the first run (the first iteration includes
    # cuDNN's and the allocator's warm-up)
    b = cfg.data["train_dataloader"]["samples_per_gpu"]
    print(f"[train] {smi}: b={b}, {t} frames, 128x128 crops, float32 (cuDNN TF32 on, "
          f"deterministic algorithms): {steady:.4f} s per iteration over iterations "
          f"2-{TRAIN_ITERS} = {1 / steady:.4f} it/s; {TRAIN_ITERS} iterations incl. start-up "
          f"{wall:.2f} s; peak device memory {peak / 2**30:.3f} GiB")
    return counts


def _serving_sample(rng, t, h, w, block=16):
    """One clip as a client submits it (time first): its own I/P/B slice
    pattern (first frame I), MVs constant over 16x16 blocks (6 px std),
    one-hot partitions over 8x8 blocks."""
    import numpy as np

    up = lambda a, k: np.repeat(np.repeat(a, k, 1), k, 2)  # noqa: E731
    slices = rng.choice(np.array([73.0, 80.0, 66.0], np.float32), size=t)
    slices[0] = 73.0
    return dict(
        lq=rng.random((t, h, w, 3), dtype=np.float32),
        qps=(rng.integers(20, 40, t) / 255.0).astype(np.float32),
        slices=slices,
        mvs=up((rng.standard_normal((t, h // block, w // block, 4)) * 6).astype(np.float32),
               block),
        base_qps=np.full(t, 35 / 255.0, np.float32),
        partitions=up(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (t, h // 8, w // 8))]
                      / 255.0, 8),
    )


def phase_batched(dev, smi):
    """StreamScheduler + batched_forward_executor on the serving config:
    three streams of two 720p clips each; per-stream order, a batch of >= 3,
    each clip against itself enhanced alone, the launch counts."""
    import numpy as np
    import torch

    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.serving import StreamScheduler, batched_forward_executor
    from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

    model, cfg = _flagship_generator("HR_davis_LR_128x128_serving.py", dev)
    h, w = MAIN_HW
    rng = np.random.default_rng(SEED + 8)
    streams = [f"s{i}" for i in range(STREAMS)]
    # submission order: each stream's first clip, then each stream's second
    order = [(sid, k) for k in range(CLIPS_PER_STREAM) for sid in streams]
    samples = {key: _serving_sample(rng, FRAMES, h, w) for key in order}
    n_frames = len(order) * FRAMES
    sched = StreamScheduler(batched_forward_executor(model), max_batch=MAX_BATCH,
                            max_wait_s=1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tickets = {key: sched.submit(key[0], samples[key]) for key in order}
    sched.close(drain=True)
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    outs = {key: t.wait() for key, t in tickets.items()}
    st = sched.stats()

    for sid in streams:
        done = [tickets[(sid, k)].done_at for k in range(CLIPS_PER_STREAM)]
        seqs = [tickets[(sid, k)].seq for k in range(CLIPS_PER_STREAM)]
        if seqs != list(range(CLIPS_PER_STREAM)) or done != sorted(done):
            raise AssertionError(f"stream {sid} completed out of order: seq {seqs}, done {done}")
    sizes = [d["batch"] for d in st["dispatches"]]
    if max(sizes) < 3:
        raise AssertionError(f"no dispatch carried 3 or more clips: {sizes}")
    # one launch per kernel and step serves every clip of a dispatch
    steps = FRAMES * len(sizes)
    gen_cfg = cfg.model["generator"]
    want = _launches_per_pass(steps, gen_cfg["num_blocks"], gen_cfg.get("warp_impl", "padgather"))
    print(f"[batched] launches {counts} (expected {want}: {len(sizes)} dispatches x {FRAMES} "
          f"steps, each launch covering its dispatch's clips; {n_frames} clip frames)")
    if counts != want:
        raise AssertionError("the batched path did not run every step through the kernels")

    # each clip alone (b=1), against its batched output
    eval_step = make_eval_step(model)
    errs, alone_s = [], 0.0
    for key in order:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = eval_step({k: samples[key][k][None] for k in MODEL_INPUT_KEYS})[0]
        alone_s += time.perf_counter() - t1
        out = outs[key]
        if out.shape != (FRAMES, h, w, 3) or not np.isfinite(out).all():
            raise AssertionError(f"clip {key}: output {out.shape} not finite/of the expected shape")
        errs.append(float(np.abs(out - ref).max()))
    lat = np.array([t.latency_s for t in tickets.values()])
    print(f"[batched] {smi}: {len(order)} clips x {FRAMES} frames at {h}x{w}, float32, "
          f"max_batch {MAX_BATCH}: dispatches "
          + ", ".join(f"b={d['batch']} {d['wall_s']:.3f} s" for d in st["dispatches"])
          + f"; per-clip latency p50 {np.percentile(lat, 50):.3f} s p95 "
          f"{np.percentile(lat, 95):.3f} s; aggregate {n_frames / wall:.3f} frames/s over "
          f"{wall:.3f} s (submit to drain); the same clips one at a time "
          f"{n_frames / alone_s:.3f} frames/s ({alone_s:.3f} s, host copies included); "
          f"peak device memory {peak / 2**30:.3f} GiB")
    print(f"[batched] each clip batched vs alone at b=1: max|diff| {max(errs):.3g} "
          f"(per clip {', '.join(f'{e:.3g}' for e in errs)}; <= {TOL_BATCHED})")
    if not max(errs) <= TOL_BATCHED:
        raise AssertionError("a batched clip differs from the same clip enhanced alone")
    return counts


def phase_curve():
    """tools/torch_serving_curve.py in a subprocess: a row for each b."""
    import torch

    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    cmd = [sys.executable, str(ROOT / "tools" / "torch_serving_curve.py"), "--max-b", "4",
           "--t", str(FRAMES), "--iters", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in proc.stdout.splitlines():
        print("[curve]", line)
    if proc.returncode != 0:
        raise AssertionError(f"torch_serving_curve.py failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if [r["b"] for r in rows] != [1, 2, 3, 4]:
        raise AssertionError(f"the curve has no row for each b = 1..4: {rows}")


def phase_handler(dev):
    """A servable of the serving config and the parity weights behind the
    HTTP handler on a free local port: 3 POSTed 720p PNGs come back as the
    PNGs of apis.restoration_inference; the health check answers."""
    import io
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from pnp_vcve_torch import apis
    from pnp_vcve_torch.kernels import LAUNCHES, reset_launches
    from pnp_vcve_torch.metrics import tensor2img

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_pnp2servable
    import torch_serving_handler

    servable = torch_pnp2servable.pnp2servable(
        str(CONFIGS / "HR_davis_LR_128x128_serving.py"),
        str(ROOT / "tests/fixtures/parity/state_dict.npz"),
        str(ROOT / "build" / "chip_smoke" / "servables"), model_name="pnp_vcve", force=True)
    handler = torch_serving_handler.PnPServingHandler()
    handler.initialize(servable, device=dev.type)
    srv, port = torch_serving_handler.serve_background(handler, 0)
    rng = np.random.default_rng(SEED + 10)
    h, w = MAIN_HW
    # smooth content with noise, as a decoded frame: a gradient plus grain
    base = np.linspace(0, 200, w, dtype=np.float32)[None, :, None] + np.zeros((h, 1, 3))
    frames = [np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
              for _ in range(HANDLER_FRAMES)]
    answers, walls = [], []
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ping", timeout=30) as r:
            if r.status != 200 or json.loads(r.read()) != {"status": "Healthy"}:
                raise AssertionError("the health check did not answer")
        reset_launches()
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f).save(buf, format="PNG")
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predictions/pnp_vcve",
                                         data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                if r.status != 200 or r.headers["Content-Type"] != "image/png":
                    raise AssertionError(f"POST answered {r.status} {r.headers['Content-Type']}")
                answers.append(np.asarray(Image.open(io.BytesIO(r.read()))))
            walls.append(time.perf_counter() - t0)
        counts = dict(LAUNCHES)
    finally:
        srv.shutdown()
        srv.server_close()
    with torch.inference_mode():
        wants = [tensor2img(apis.restoration_inference(handler.model, f)) for f in frames]
    for got, want in zip(answers, wants):
        if got.shape != (h, w, 3) or not np.array_equal(got, want):
            raise AssertionError("a POST's PNG differs from apis.restoration_inference")
    gen_cfg = handler.model.cfg.model["generator"]
    expected = _launches_per_pass(HANDLER_FRAMES, gen_cfg["num_blocks"],
                                  gen_cfg.get("warp_impl", "padgather"))
    print(f"[handler] {HANDLER_FRAMES} POSTs of {h}x{w} PNGs: 200 image/png, equal as uint8 "
          f"to restoration_inference; request walls "
          f"{', '.join(f'{x:.3f}' for x in walls)} s (PNG decode and encode included); "
          f"launches {counts} (expected {expected}); /ping healthy")
    if counts != expected:
        raise AssertionError("the handler did not run every request through the kernels")
    return counts


def _block_form_generator(form, dev):
    """The training config's generator in a block form, through the builder
    and the restorer (``build_restorer``), with the parity fixture's weights
    where their names and shapes fit (the forms' own conv2 or conv1 keep
    their seeded init); returns the generator, its config and the count of
    tensors loaded out of all."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.checkpoint import read_state_dict
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(CONFIGS / "HR_davis_LR_128x128.py")
    gen_cfg = {**cfg.model["generator"], **BLOCK_FORMS[form]}
    model = build_restorer({**cfg.model, "generator": gen_cfg}, device=dev).generator
    own = model.state_dict()
    fit = {k: v for k, v in read_state_dict(ROOT / "tests/fixtures/parity/state_dict.npz").items()
           if k in own and own[k].shape == v.shape}
    model.load_state_dict(fit, strict=False)
    return model, gen_cfg, len(fit), len(own)


def phase_block_forms(dev, smi):
    """The training config in the block forms 'drt_woqp', one_layer=False and
    channel_first=False at full width: each kernel path against its plain
    path on one clip of 8 frames at 256x448 (TOL_MODEL), then a 720p clip
    of 8 frames, once to warm up and twice timed, with the last run's
    launch counts (the fused 'drt_woqp' on K3, the other two on K5); one_layer=False's gradients through the Functions
    (K5's Conv3x3Function among them) against the plain path. Returns the
    launches of each form's last 720p run, summed over the forms."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = FRAMES
    rng = np.random.default_rng(SEED + 11)
    small = _clip_inputs(rng, 1, t, *FORMS_HW, dev)
    big = _clip_inputs(rng, 1, t, *MAIN_HW, dev)
    total = {}
    for form in BLOCK_FORMS:
        model, gen_cfg, n_fit, n_all = _block_form_generator(form, dev)
        want = _launches_per_pass(t, gen_cfg["num_blocks"],
                                  fused_blocks=gen_cfg.get("one_layer", True)
                                  and gen_cfg.get("channel_first", True))
        with torch.inference_mode():
            reset_launches()
            got = model(**small)
            counts_small = dict(LAUNCHES)
            model.ops = PLAIN
            ref = model(**small)
            model.ops = KERNELS
            err = float((got - ref).abs().max())
            del got, ref
            # one untimed 720p clip first: the allocator's first 720p blocks
            # cost a quarter of a clip's time, which no later clip pays
            model(**big)
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                out = model(**big)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts = dict(LAUNCHES)
            if not want["drt_block"]:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(**big)
                    torch.cuda.synchronize()
        ok = bool(torch.isfinite(out).all()) and out.shape == (1, t, *MAIN_HW, 3)
        del out
        print(f"[forms] {form}: {n_fit} of {n_all} tensors from the parity fixture; kernel path "
              f"vs plain path, {t} frames {FORMS_HW[0]}x{FORMS_HW[1]} float32: max|diff| "
              f"{err:.3g} (<= {TOL_MODEL}); {smi}: {t} frames at {MAIN_HW[0]}x{MAIN_HW[1]} "
              f"float32 in {walls[0]:.3f} / {walls[1]:.3f} s = "
              f"{t / walls[0]:.3f} / {t / walls[1]:.3f} frames/s; launches {counts} "
              f"(expected {want})")
        if not ok or err > TOL_MODEL:
            raise AssertionError(f"{form}: kernel path disagrees with its plain path or 720p "
                                 "output not finite/of the expected shape")
        if counts != want or counts_small != want or (want["conv3x3"] and not counts["conv3x3"]):
            raise AssertionError(f"{form}: the forward did not run through the kernels")
        if not want["drt_block"]:
            _print_form_profile(form, prof, walls[-1])
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if form == "one_layer_false":
            _grad_check("forms grad", model, gen_cfg,
                        _launches_per_pass(GRAD_T, gen_cfg["num_blocks"], fused_blocks=False),
                        SEED + 12, dev)
        del model
        torch.cuda.empty_cache()
    return total


def _device_time(prof):
    """``(busy s, {kernel name: s})`` of the device in a profile (busy: the
    union of the kernels' intervals), or None where it recorded no device
    event."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        # the ProfilerStep annotation is mirrored on the device's timeline
        if e.device_type != DeviceType.CUDA or e.name.startswith("ProfilerStep"):
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) * 1e-6
    if not spans:
        return None
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy * 1e-6, by_name


def _print_form_profile(form, prof, wall_s):
    """Device time of one profiled 720p clip of an unfused block form: busy
    time and idle share against the unprofiled clip, K5's share and the
    port's kernels' share of the device time, the top kernels."""
    found = _device_time(prof)
    if found is None:
        print(f"[forms] {form}: profiler recorded no device events; breakdown not measured")
        return
    busy, by_name = found
    total = sum(by_name.values())
    k5 = sum(v for n, v in by_name.items() if "pnp::conv3x3_kernel" in n)
    ours = sum(v for n, v in by_name.items() if "pnp::" in n)
    print(f"[forms] {form}, one profiled 720p clip: device busy {busy:.4f} s, idle share "
          f"{max(0.0, 1 - busy / wall_s):.4f} of the unprofiled {wall_s:.4f} s clip; K5 "
          f"{k5:.4f} s = {k5 / total:.4f} of device time, K1-K5 {ours / total:.4f}, the rest "
          f"{total - ours:.4f} s (the partition path, ReLU, residual and premix as torch ops)")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[forms]   {v:.4f} s {v / total:.4f}  {name[:110]}")


def _print_breakdown(prof, window_s, steady_s):
    """Device time of the profiled iteration by kernel: the device's busy
    time and idle share in the profiled window and against an unprofiled
    iteration, K1-K4's share of the device time, the top kernels."""
    ours = ("warp_kernel", "input_conv_kernel", "drt_block_kernel", "head_kernel")
    found = _device_time(prof)
    if found is None:
        print("[train] profiler: no device events recorded; breakdown not measured")
        return
    busy, by_name = found
    total = sum(by_name.values())
    k = sum(v for n, v in by_name.items() if any(o in n for o in ours))
    print(f"[train] profiled iteration (resumed run, iteration {TRAIN_ITERS}): device busy "
          f"{busy:.4f} s; idle share {max(0.0, 1 - busy / window_s):.4f} of the profiled "
          f"{window_s:.4f} s, {max(0.0, 1 - busy / steady_s):.4f} of an unprofiled "
          f"{steady_s:.4f} s iteration; K1-K4 {k:.4f} s = {k / total:.4f} of device time "
          f"(forward and remat recompute); the rest {total - k:.4f} s (the Functions' plain "
          f"replay and its backward, the loss, Adam)")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[train]   {v:.4f} s {v / total:.4f}  {name[:110]}")


def _probe_check(tag, got, ref, rule):
    """Hold a probe kernel's output to its plain version's: "bitwise" (every
    tensor of a tuple), "rel" (max|diff| <= 1e-5 max|ref|) or "bf16"
    (phase 3's bf16 bounds). Returns max|diff|."""
    import torch

    torch.cuda.synchronize()
    if rule == "bf16":
        return _compare(tag, got, ref, torch.bfloat16, (0.02, 0.002))
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    err = max(float((g.double() - r.double()).abs().max()) for g, r in pairs)
    if rule == "bitwise":
        ok = all(g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r) for g, r in pairs)
        bound = "bitwise"
    else:
        scale = float(ref.double().abs().max())
        ok = bool(torch.isfinite(got).all()) and err <= 1e-5 * scale
        bound = f"<= 1e-5 max|ref| = {1e-5 * scale:.3g}"
    print(f"[probes] {tag}: max|diff| {err:.3g} ({bound})")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with its plain version")
    return err


def _probe_cases(int8, warp2, bisect):
    """One dict per stage of the three probe tools: the kernel it times, its
    TPU function, the timed call and its plain version on the same inputs,
    the comparison rule, one PyTorch call computing the same function (or
    None) and, where it gives the kernel's dtype, the part of the kernel's
    output it gives (held to it by the same rule), the reps the JAX file
    times over, and the work (bytes, operations by type) of this run's
    inputs (tools/torch_kernel_bounds.py)."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import probes as P
    import torch_kernel_bounds as kb

    cases = []

    def add(kernel, tpu, res, plain, rule, library, reps, work, out=None, lib_of=None):
        fn, args = res["fn"], res["args"]
        cases.append(dict(kernel=kernel, tpu=tpu, out=res["out"] if out is None else out,
                          kern=lambda: fn(*args), plain=plain, rule=rule, library=library,
                          lib_of=lib_of, reps=reps, work=work))

    # tools/int8_probe.py
    r = int8["bf16 matmul"]
    a, b = r["args"]
    m, k = a.shape
    n = b.shape[1]
    add("matmul", "k1 bf16 matmul (:70)", r, lambda: P.matmul_plain(a, b), "rel",
        lambda: torch.matmul(a, b), 100, kb.matmul_work(m, k, n, "bf16"))
    r = int8["int8 matmul"]
    aq, bq = r["args"]
    add("matmul", "k2 int8 matmul (:80)", r, lambda: P.matmul_plain(aq, bq), "bitwise",
        lambda: torch._int_mm(aq, bq), 100, kb.matmul_work(m, k, n, "int8", out_bytes=4),
        lib_of=lambda o: o)
    r = int8["quantize-in-kernel + int8 matmul"]
    a3, b3 = r["args"]

    def k3_plain():
        q, s = P.absmax_quantize_plain(a3)
        return P.matmul_plain(q, b3, s)

    add("matmul", "k3 K9 + int8 matmul (:100)", r, k3_plain, "bitwise", None, 100,
        kb.quantized_matmul_work(m, k, n))
    res_q = dict(fn=P.absmax_quantize, args=(a3,), out=None)
    add("absmax_quantize", "k3's quantize (:100)", res_q, lambda: P.absmax_quantize_plain(a3),
        "bitwise", None, 100, kb.quantize_work(a3.numel()), out=P.absmax_quantize(a3))
    r = int8["bf16 tap-conv (same geometry)"]  # K10's headline: it has a library call
    band_bf, w_bf = r["args"]
    c2 = band_bf.shape[2]
    rows, cols, cout = r["out"].shape
    x_cl = band_bf.permute(2, 0, 1)[None, :, :rows + 2, :cols + 2]  # NCHW view, channels last
    w_oihw = w_bf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    add("tapconv", "k5 bf16 tap conv (:148)", r, lambda: P.tapconv_plain(band_bf, w_bf, rows, cols),
        "rel", lambda: F.conv2d(x_cl, w_oihw), 50, kb.tapconv_work(rows, cols, c2, cout, "bf16"))

    r = int8["int8 tap-conv (strided slices)"]
    band, wq = r["args"]

    def k4_plain():
        q, s = P.absmax_quantize_plain(band)
        return P.tapconv_plain(q, wq, rows, cols, s)

    add("tapconv", "k4 K9 + int8 tap conv (:127)", r, k4_plain, "bitwise", None, 50,
        kb.quantized_tapconv_work(*band.shape[:2], rows, cols, c2, cout))
    add("absmax_quantize", "k4's quantize (:127)", dict(fn=P.absmax_quantize, args=(band,)),
        lambda: P.absmax_quantize_plain(band), "bitwise", None, 50,
        kb.quantize_work(band.numel()), out=P.absmax_quantize(band))
    # tools/warp_kernel_probe2.py
    r = warp2["band DMA floor (128-lane)"]
    src, oh, ow, y0, x0 = r["args"]
    add("window_copy", "probe_floor128 (:78)", r, lambda r=r: P.window_copy_plain(*r["args"]),
        "bitwise", lambda a=r["args"]: torch.mul(a[0][:, a[3]:a[3] + a[1], a[4]:a[4] + a[2]], 2),
        30, kb.copy_work(1, oh, oh, ow, src.shape[3]), lib_of=lambda o: o)
    r = warp2["matmul-select H + dense V"]
    xp, s_all, vm = r["args"]
    nb, nt, _, kw = s_all.shape
    add("mmsel", "probe_mmsel (:126)", r, lambda: P.mmsel_warp_plain(xp, s_all, vm), "bf16",
        None, 30, kb.mmsel_work(nb, nt, kw, xp.shape[3], vm.shape[2] + 7, nt * 128, vm.shape[2],
                                s_nnz=int((s_all != 0).sum()), vm_nnz=int((vm != 0).sum())))

    # tools/warp_bisect.py
    for name, r in bisect.items():
        form = name.rstrip("0123456789")
        x = r["args"][0]
        lanes = x.shape[3]
        if form == "fori":  # the library's (rows, 128, lanes) is columns 0..127 of the output
            _, s1, nbb, j0, w_out = r["args"]
            kw = s1.shape[3]
            add("mmsel", f"k_fori_dot({lanes}) (:105)", r,
                lambda r=r: P.mmsel_h_plain(*r["args"]), "bf16",
                lambda x=x, s1=s1, j0=j0, nbb=nbb, kw=kw:
                    torch.matmul(s1[0, 0], x[0, j0:j0 + 8 * nbb, :kw]),
                30, kb.mmsel_work(nbb, 1, kw, lanes, 8, w_out, s_bands=1,
                                  s_nnz=int((s1 != 0).sum())),
                lib_of=lambda o: o[0, :, :P.TILE])
        else:  # the period form repeats rows y0 .. y0 + period: a broadcast view
            _, oh, ow, y0, x0, *period = r["args"]
            period = period[0] if period else 0
            rows_in = min(period, oh) if period else oh
            add("window_copy", f"k_{form}({lanes}) (:{52 if form == 'dma' else 72})", r,
                lambda r=r: P.window_copy_plain(*r["args"]), "bitwise",
                lambda x=x, y0=y0, x0=x0, oh=oh, ow=ow, n=rows_in, c=lanes: torch.mul(
                    x[:, y0:y0 + n, x0:x0 + ow].unsqueeze(1).expand(-1, oh // n, -1, -1, -1),
                    2).reshape(1, oh, ow, c),
                30, kb.copy_work(1, rows_in, oh, ow, lanes), lib_of=lambda o: o)
    return cases


def _k5_geometry(dev, smi):
    """K10 in bf16 and int8 (with K9) at K5's 720p 64 -> 64 geometry, beside
    K5 and one cuDNN conv on the same frame, bf16: a measurement only."""
    import torch
    import torch.nn.functional as F

    from pnp_vcve_torch.kernels import KERNELS
    from pnp_vcve_torch.kernels import probes as P
    import torch_kernel_bounds as kb

    h, w, c = K5_GEOMETRY
    gen = torch.Generator().manual_seed(SEED + 12)
    band = torch.randn((h + 2, w + 2, c), generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn((3, 3, c, c), generator=gen) * 0.05).to(dev)
    w_bf = wt.to(torch.bfloat16)
    wq, _ = P.absmax_quantize(w_bf)
    q, s = P.absmax_quantize(band)
    _probe_check("tapconv bf16 at K5's geometry", P.tapconv(band, w_bf, h, w),
                 P.tapconv_plain(band, w_bf, h, w), "rel")
    _probe_check("tapconv int8 at K5's geometry", P.tapconv(q, wq, h, w, s),
                 P.tapconv_plain(q, wq, h, w, s), "bitwise")
    x = band[1:h + 1, 1:w + 1][None].contiguous()  # K5 pads the frame itself
    x_cl = band.permute(2, 0, 1)[None]
    w_oihw = w_bf.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    k5_w = wt[None]

    def k9_k10():
        q_, s_ = P.absmax_quantize(band)
        return P.tapconv(q_, wq, h, w, s_)

    calls = {
        "K10 bf16": lambda: P.tapconv(band, w_bf, h, w),
        "K10 int8 (s given)": lambda: P.tapconv(q, wq, h, w, s),
        "K9 + K10 int8": k9_k10,
        "K5 bf16 ('same' conv of the frame)": lambda: KERNELS.conv3x3(x, k5_w),
        "cuDNN F.conv2d bf16": lambda: F.conv2d(x_cl, w_oihw),
    }
    times = {k: _timed(f, 20) for k, f in calls.items()}
    for kind in ("bf16", "int8"):
        b_ms, by, t_bytes, t_ops = kb.bound(kb.tapconv_work(h, w, c, c, kind))
        print(f"[probes] K5's geometry {h}x{w}, {c} -> {c}: K10 {kind} bound {b_ms:.4f} ms "
              f"({by}; bytes {t_bytes:.4f}, ops {t_ops:.4f})")
    print(f"[probes] K5's geometry ({smi}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return times


def phase_probes(dev, smi):
    """Phase 12: the three probe tools at their full shapes on the card (the
    probe path: every launch of K6-K10 counted), then each stage's kernel
    against its plain version on the same inputs and timed beside it, the
    library call and the bound; K10 at K5's geometry."""
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_int8_probe
    import torch_kernel_bounds as kb
    import torch_warp_bisect
    import torch_warp_kernel_probe2

    from pnp_vcve_torch.kernels import probes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[probes] {smi}")
    probes.reset_launches()
    int8 = torch_int8_probe.main([])
    warp2 = torch_warp_kernel_probe2.main([])
    bisect = torch_warp_bisect.main(list(torch_warp_bisect.STAGES))
    torch.cuda.synchronize()
    counts = dict(probes.LAUNCHES)
    print(f"[probes] launches of the three tools: {counts}")
    failed = [k for res in (int8, warp2, bisect) for k, v in res.items() if v["out"] is None]
    if failed or not all(counts.values()):
        raise AssertionError(f"probe stages failed: {failed}; launches {counts}")
    rows = {}
    for c in _probe_cases(int8, warp2, bisect):
        tag = f"{c['kernel']}: {c['tpu']}"
        err = _probe_check(tag, c["out"], c["plain"](), c["rule"])
        if c["lib_of"]:
            _probe_check(f"{tag}: library call", c["library"](), c["lib_of"](c["out"]), c["rule"])
        p1, k1, k2, p2 = (_timed(f, c["reps"]) for f in (c["plain"], c["kern"], c["kern"],
                                                         c["plain"]))
        lib = _timed(c["library"], c["reps"]) if c["library"] else None
        b_ms, by, t_bytes, t_ops = kb.bound(c["work"])
        row = dict(tpu=c["tpu"], max_abs_err=err, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   bound_ms=b_ms, bound_by=by, library_ms=lib)
        rows.setdefault(c["kernel"], []).append(row)
        print(f"[time] {tag}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
              f"library {'none' if lib is None else f'{lib:.4f} ms'}; bound {b_ms:.4f} ms "
              f"({by}: bytes {t_bytes:.4f}, ops {t_ops:.4f}); {smi}")
    k5 = _k5_geometry(dev, smi)
    out = {}
    for name, rs in rows.items():  # the first stage is the headline, the rest forms
        out[name] = dict(max_abs_err=max(r["max_abs_err"] for r in rs),
                         **{k: rs[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")},
                         forms=rs, launches=counts[name])
    out["tapconv"]["k5_geometry_ms"] = k5
    return out


def main():
    sys.path.insert(0, str(ROOT))
    # deterministic cuBLAS for the resume check of phase 7; read when cuBLAS
    # starts, so set before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev, smi = phase_device()
    import torch

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    phase("2 build", phase_build)
    kern = phase("3 kernels", phase_kernels, dev)
    counts = phase("4 serving path", phase_main_path, dev)
    phase("5 model vs plain", phase_model_vs_plain, dev)
    phase("6 gradients", phase_grads, dev)
    train_counts = phase("7 training", phase_train, dev, smi)
    batched_counts = phase("8 batched serving", phase_batched, dev, smi)
    phase("9 serving curve", phase_curve)
    handler_counts = phase("10 handler", phase_handler, dev)
    forms_counts = phase("11 block forms", phase_block_forms, dev, smi)
    probe_rows = phase("12 probes", phase_probes, dev, smi)

    paths = {"serving_launches": counts, "batched_launches": batched_counts,
             "handler_launches": handler_counts, "train_launches": train_counts,
             "block_forms_launches": forms_counts}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
         "launches": sum(c[name] for c in paths.values()),
         **{k: c[name] for k, c in paths.items()}, **kern[name]}
        for name, (src, rep) in KERNEL_INFO.items()
    ] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "also_replaces": also,
         **probe_rows[name]}
        for name, (src, rep, also) in PROBE_INFO.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
