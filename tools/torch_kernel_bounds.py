#!/usr/bin/env python
"""The least time an NVIDIA H100 could take for the work of each B10 TPU probe
of the JAX package (ROADMAP Queue B), worked out from each function's own
shapes, with the Hopper kernel that ports it (K6-K13), and of two of the
model kernels on the tensor cores (K2, K3) at the flagship's 720p
frame. The model kernels' bounds (K1-K5) are computed by chip_smoke.py from
the inputs of its run, and so are the probe kernels' (phases 12 and 13),
through the work functions below (``conv_bounds`` for K2-K5).

A bound is the larger of two times: the bytes the function must move (each
input byte it reads once, each output written once) over the card's memory
rate, and the operations it does on those inputs over the card's peak rate
for their type. Rates are the H100 SXM's published dense peaks (NVIDIA's
data sheet): 3.35 TB/s HBM3, 67 TFLOP/s float32 on the CUDA cores, 989
TFLOP/s bf16, 495 TFLOP/s TF32 and 1,979 TOP/s int8 on the tensor cores,
at the full 700 W power limit. Operations of different types add their
times. A float32 convolution on the tensor cores runs as 3xTF32 (three TF32
products a multiply-add, to keep float32's accuracy), so its operations
bound is 3 x its FLOP over the TF32 rate.

The TPU probes are counted at the constants of their own files, as the
Hopper kernel's function: a window copy reads only its window (the TPU's
48-row band for 8 output rows was its layout's); a selection matmul needs
what its data needs, two taps a row of S and two terms a pixel of vm as
build_s and the probe's vm have them (the dense products the TPU ran are
given beside, as ``dense_ops``); the two-pass select is a gather of two
taps a pass (the TPU's 35 masked shifts had two non-zero terms); the
select and the block windows read the distinct input pixels their seeded
tables pick (the JAX file's draws; neighbouring taps and windows overlap,
so this is less than the taps times their size); elementwise blends count
as float32 operations.

    python tools/torch_kernel_bounds.py        # a markdown table, then one JSON line
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_warp_kernel_probe import X0, draw_inputs  # noqa: E402  (its seeded tables)

HBM_BYTES_S, F32_FLOP_S, BF16_TC_FLOP_S, INT8_TC_OP_S = 3.35e12, 67e12, 989e12, 1979e12
TF32_TC_FLOP_S = 495e12
# "tf32x3": float32 FLOP done as 3xTF32 on the tensor cores
RATE = {"f32": F32_FLOP_S, "bf16": BF16_TC_FLOP_S, "int8": INT8_TC_OP_S,
        "tf32x3": TF32_TC_FLOP_S / 3}
F32, BF16, INT8, I32 = 4, 2, 1, 4
TILE, BAND_ROWS = 128, 8  # the selection matmul's tile width and band height
SHIFTS, BAND = 35, 42     # the two-pass select: shifts a pass, band rows its V pass reaches


def n(*shape):
    out = 1
    for s in shape:
        out *= s
    return out


def copy_work(nb, rows_read, out_h, out_w, lanes):
    """K6: ``rows_read`` source rows of the window in, the output out, bf16;
    one float32 multiply a value."""
    return dict(bytes=nb * (rows_read + out_h) * out_w * lanes * BF16,
                ops={"f32": nb * out_h * out_w * lanes})


def mmsel_work(nb, nt, kw, c, nrows, out_w, dv=0, s_bands=None, s_nnz=None, vm_nnz=None):
    """K7: bands of ``nrows`` H rows (dv + 7 in the V mode, 8 in the H
    mode), S for each band (``s_bands`` = nb) or one for all (1), vm in the V
    mode. ``s_nnz`` and ``vm_nnz`` (the non-zeros of S and vm, default: all)
    give the operations the data needs; ``dense_ops`` the dense products."""
    s_bands = nb if s_bands is None else s_bands
    s_size, vm_size = s_bands * nt * TILE * kw, nb * nt * TILE * dv
    s_nnz = s_size if s_nnz is None else s_nnz
    vm_nnz = vm_size if vm_nnz is None else vm_nnz
    src = (BAND_ROWS * (nb - 1) + nrows) * (TILE * (nt - 1) + kw) * c * BF16
    h_uses = nb // s_bands * nrows * c  # each non-zero of S meets this many window values
    dense = {"bf16": 2 * s_size * h_uses, "f32": 2 * vm_size * BAND_ROWS * c}
    data = {"bf16": 2 * s_nnz * h_uses, "f32": 2 * vm_nnz * BAND_ROWS * c}
    return dict(bytes=src + s_size * BF16 + vm_size * F32 + nb * BAND_ROWS * out_w * c * BF16,
                ops={k: v for k, v in data.items() if v}, dense_ops={k: v for k, v in dense.items() if v})


def _distinct(hp, wp, taps):
    """The distinct pixels of an (hp, wp) image that ``taps`` (pairs of
    row and column index arrays) read."""
    seen = np.zeros((hp, wp), bool)
    for rows, cols in taps:
        seen[rows, cols] = True
    return int(seen.sum())


def gather2_work(shidx, dyidx, hp, wp, c, x0):
    """K11 on its tables ``shidx``, ``dyidx`` (nb, w): the distinct pixels
    of the padded input ``(hp, wp, c)`` bf16 that its live taps read (the
    taps of neighbouring columns and bands overlap), the ``(8 nb, w, c)``
    output, the six ``(nb, w)`` tables; two fused multiply-adds an H value
    (nine rows an output column) and two an output value. The taps are
    probes.gather2_plain's: H row ``d + j`` (j = 0..8) of band ri is input
    row ``8 ri + d + j``, read at columns ``x + k + x0`` and the next, each
    where its weight is live (its shift inside the TPU kernel's 35)."""
    k, d = np.asarray(shidx, np.int64), np.asarray(dyidx, np.int64)
    nb, w = k.shape
    ri, x = np.arange(nb)[:, None], np.arange(w)[None, :]
    a_live = ((k >= 0) & (k < SHIFTS), (k >= -1) & (k < SHIFTS - 1))
    b0, b1 = (d >= 0) & (d < SHIFTS), (d >= -1) & (d < SHIFTS - 1)
    taps = []
    for j in range(BAND_ROWS + 1):
        row_live = ((b0 & (j < BAND_ROWS)) | (b1 & (j > 0))) & (d + j >= 0) & (d + j < BAND)
        for t, live in enumerate(a_live):
            m = row_live & live
            taps.append(((BAND_ROWS * ri + d + j)[m], (x + k + x0 + t)[m]))
    return dict(bytes=_distinct(hp, wp, taps) * c * BF16 + nb * BAND_ROWS * w * c * BF16
                + 6 * nb * w * I32,
                ops={"f32": 2 * 2 * (BAND_ROWS + 1 + BAND_ROWS) * nb * w * c})


def block_windows_work(sy, sx, hp, wp, c):
    """K12 on its tables ``sy``, ``sx`` (one an 8x8 block): the distinct
    pixels of the padded input ``(hp, wp, c)`` bf16 that the blocks' two
    windows cover (at probes.block_windows_plain's clamped origins; the
    windows of different blocks overlap), the 8 x 8 out a block, the two
    int32 tables; an add and a multiply a value."""
    sy, sx = np.asarray(sy, np.int64), np.asarray(sx, np.int64)
    i = np.arange(BAND_ROWS)
    ya = np.clip(sy, 0, hp - BAND_ROWS - 1)[:, None, None] + i[None, :, None]
    xa = np.clip(sx, 0, wp - BAND_ROWS)[:, None, None] + i[None, None, :]
    xb = np.clip(sx + BAND_ROWS, 0, wp - BAND_ROWS)[:, None, None] + i[None, None, :]
    taps = [np.broadcast_arrays(ya, xa), np.broadcast_arrays(ya + 1, xb)]
    nblk = len(sy)
    return dict(bytes=_distinct(hp, wp, taps) * c * BF16 + nblk * (64 * c * BF16 + 2 * I32),
                ops={"f32": 2 * nblk * 64 * c})


def chunk_copy_work(hp, wp, lanes, write_out):
    """K13: the (hp, wp, lanes) bf16 array read once, and written once
    (write_out) or only the last chunk's first row (8, lanes)."""
    z = hp * wp * lanes * BF16
    return dict(bytes=z + (z if write_out else BAND_ROWS * lanes * BF16), ops={})


def matmul_work(m, k, n, kind, out_bytes=F32):
    """K8: (m, k) @ (k, n) in ``kind`` ("bf16" or "int8")."""
    elt = BF16 if kind == "bf16" else INT8
    return dict(bytes=(m * k + k * n) * elt + m * n * out_bytes, ops={kind: 2 * m * k * n})


def quantize_work(count):
    """K9: bf16 in, int8 and one float32 out; |x| and the max in the first
    pass, the divide and the rounding in the second."""
    return dict(bytes=count * (BF16 + INT8) + F32, ops={"f32": 4 * count})


def quantized_matmul_work(m, k, n):
    """k3 as one function (K9, then K8 in int8 with the scale): the bf16
    (m, k) read once, no int8 intermediate; K9's four float32 operations a
    value."""
    return dict(bytes=m * k * BF16 + k * n * INT8 + m * n * F32,
                ops={"int8": 2 * m * k * n, "f32": 4 * m * k})


def quantized_tapconv_work(bh, bw, rows, cols, cin, cout):
    """k4 as one function (K9, then K10 in int8): the whole bf16 (bh, bw,
    cin) band read once (its absmax reads all of it), no int8
    intermediate."""
    return dict(bytes=bh * bw * cin * BF16 + 9 * cin * cout * INT8 + rows * cols * cout * F32,
                ops={"int8": 2 * 9 * rows * cols * cin * cout, "f32": 4 * bh * bw * cin})


def tapconv_work(rows, cols, cin, cout, kind):
    """K10: the (rows + 2, cols + 2) part of the band it reads, 9 taps of
    weights, float32 out."""
    elt = BF16 if kind == "bf16" else INT8
    return dict(bytes=((rows + 2) * (cols + 2) * cin + 9 * cin * cout) * elt
                + rows * cols * cout * F32, ops={kind: 2 * 9 * rows * cols * cin * cout})


def conv3x3_work(b, h, w, cin, cout, kind, elt):
    """K5: b per-sample 'same' 3x3 convs, ``elt``-byte features in and out,
    the float32 kernels, biases and gains read once; ``kind`` "bf16" or
    "tf32x3" (float32 features on the tensor cores)."""
    return dict(bytes=b * h * w * (cin + cout) * elt + b * (9 * cin + 2) * cout * F32,
                ops={kind: 2 * 9 * b * h * w * cin * cout})


def conv_bounds(flop, nbytes):
    """A convolution's bounds in ms: its ``flop`` on the float32 CUDA cores,
    in 3xTF32 and on the bf16 tensor cores, and its ``nbytes`` over the
    memory rate."""
    return dict(f32_ms=flop / RATE["f32"] * 1e3, tf32x3_ms=flop / RATE["tf32x3"] * 1e3,
                bf16_ms=flop / RATE["bf16"] * 1e3, bytes_ms=nbytes / HBM_BYTES_S * 1e3)


def model_flop_per_pixel(label, c=64):
    """FLOP an output pixel of a model kernel at width c (2 a multiply-add),
    from the shapes: K2's parts (the 3-channel lr frame and 2 or 3 features),
    K3's two 3x3 convs and three 1x1 partition convs, K4's two convs."""
    return {
        "input_conv (backward, 3 parts)": 2 * 9 * (3 + 2 * c) * c,
        "input_conv (forward, 4 parts)": 2 * 9 * (3 + 3 * c) * c,
        "drt_block": 2 * (9 * c * c + 3 * c * c + 9 * c * c),
        "drt_block_select": 2 * (9 * c * c + 3 * c * c + 9 * c * c),
        "head": 2 * 9 * c * (c + 3),
        "conv3x3": 2 * 9 * c * c,
    }.get(label, 0)


def model_kernels(h=720, w=1280, c=64):
    """K2 and K3 at a frame of h x w, width c, b = 1: (label, Hopper kernel,
    FLOP, bytes by feature type). Bytes: K2 reads its parts and writes its
    output; K3 reads x and par and writes out; the weights are counted once."""
    px = h * w
    rows = []
    for n, tag in ((3, "backward"), (4, "forward")):
        label = f"input_conv ({tag}, {n} parts)"
        rows.append((label, "K2", model_flop_per_pixel(label, c) * px,
                     {e: px * (3 + (n - 1) * c + c) * e + 9 * (3 + (n - 1) * c) * c * e
                      for e in (F32, BF16)}))
    rows.append(("drt_block", "K3", model_flop_per_pixel("drt_block", c) * px,
                 {e: px * (2 * c + 3) * e + 21 * c * c * e for e in (F32, BF16)}))
    return rows


def probes():
    """B10 at the constants of each probe file: (item, function, work,
    Hopper kernel or None)."""
    rows = []
    # tools/warp_bisect.py:19-23: H, W = 64, 256; TILE 128; KW 184; WPAD 320
    H, W, KW = 64, 256, 184
    for lanes in (64, 128):
        rows.append(("B10", f"tools/warp_bisect.py:43 k_dma({lanes})",
                     copy_work(1, H, H, W, lanes), "K6"))
    rows.append(("B10", "tools/warp_bisect.py:67 k_nodma(64)", copy_work(1, 8, H, W, 64), "K6"))
    for lanes in (64, 128):  # S of ones: every entry a non-zero
        rows.append(("B10", f"tools/warp_bisect.py:84 k_fori_dot({lanes})",
                     mmsel_work(H // 8, 1, KW, lanes, 8, W, s_bands=1), "K7"))
    # tools/warp_kernel_probe.py:29-36 and warp_kernel_probe2.py:34-45: 720p, C 64,
    # B 8, WP 1344, BAND 48, HP 760, TILE 128, KW 184, NT 10, DV 40
    H, W, C, B, WP, HP, NT, DV = 720, 1280, 64, 8, 1344, 760, 10, 40
    NBY = H // B
    rows.append(("B10", "tools/warp_kernel_probe.py:68 probe_floor",
                 copy_work(1, H, H, W, C), "K6"))
    # K11 and K12 read what their seeded tables pick (the JAX file's draws)
    _, sy, sx, shidx, dyidx, *_ = draw_inputs(H, W, C, with_input=False)
    rows.append(("B10", "tools/warp_kernel_probe.py:123 probe_select",
                 gather2_work(shidx, dyidx, HP, WP, C, X0), "K11"))
    rows.append(("B10", "tools/warp_kernel_probe.py:177 probe_dma",
                 block_windows_work(sy, sx, HP, WP, C), "K12"))
    rows.append(("B10", "tools/warp_kernel_probe2.py:77 probe_floor128",
                 copy_work(1, H, H, W // 2, 2 * C), "K6"))
    rows.append(("B10", "tools/warp_kernel_probe2.py:125 probe_mmsel", mmsel_work(
        NBY, NT, KW, C, DV + B - 1, W, DV, s_nnz=2 * NBY * W, vm_nnz=2 * NBY * W), "K7"))
    # tools/dma_probe.py:12-17: H, W = 720, 1280; PF (HP, WP, 128) = (736, 656, 128) bf16
    HP, WP = 720 + 16, 1280 // 2 + 16
    for fn, line in (("run", 86), ("run_pipelined", 149)):
        for write_out in (False, True):
            rows.append(("B10", f"tools/dma_probe.py:{line} {fn}(write_out={write_out})",
                         chunk_copy_work(HP, WP, 128, write_out), "K13"))
    # tools/int8_probe.py:27-29: M, K, N = 4096, 128, 128; band (24, 656, 128); out 16 x 320
    M, K, N_, BH, BW, C2, ROWS, COLS = 4096, 128, 128, 24, 656, 128, 16, 320
    rows += [
        ("B10", "tools/int8_probe.py:70 k1 (bf16 matmul)", matmul_work(M, K, N_, "bf16"), "K8"),
        ("B10", "tools/int8_probe.py:80 k2 (int8 matmul)",
         matmul_work(M, K, N_, "int8", out_bytes=I32), "K8"),
        ("B10", "tools/int8_probe.py:100 k3's scaled int8 matmul alone (s given)",
         matmul_work(M, K, N_, "int8"), "K8"),
        ("B10", "tools/int8_probe.py:100 k3's quantize alone", quantize_work(M * K), "K9"),
        ("B10", "tools/int8_probe.py:100 k3 (quantize + int8 matmul)",
         quantized_matmul_work(M, K, N_), "K9 + K8"),
        ("B10", "tools/int8_probe.py:127 k4's quantize alone", quantize_work(BH * BW * C2), "K9"),
        ("B10", "K9 alone at K5's 720p geometry (722 x 1282 x 64 bf16)",
         quantize_work(722 * 1282 * 64), "K9"),
        ("B10", "tools/int8_probe.py:127 k4 (int8 tap conv)",
         quantized_tapconv_work(BH, BW, ROWS, COLS, C2, C2), "K9 + K10"),
        ("B10", "tools/int8_probe.py:148 k5 (bf16 tap conv)",
         tapconv_work(ROWS, COLS, C2, C2, "bf16"), "K10"),
    ]
    return rows


def bound(work):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms)."""
    t_bytes = work["bytes"] / HBM_BYTES_S * 1e3
    t_ops = sum(v / RATE[k] for k, v in work["ops"].items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def main():
    rows = []
    print("| item | TPU function | port | bytes | operations | bound ms (by) |")
    print("|---|---|---|---|---|---|")
    for item, fn, work, port in probes():
        ms, by, t_bytes, t_ops = bound(work)
        ops = ", ".join(f"{v:.4g} {k}" for k, v in work["ops"].items()) or "—"
        print(f"| {item} | `{fn}` | {port or 'to port'} | {work['bytes']:.4g} | {ops} | "
              f"{ms:.4g} ({by}) |")
        rows.append(dict(item=item, function=fn, port=port, bytes=work["bytes"], ops=work["ops"],
                         dense_ops=work.get("dense_ops"), bound_ms=ms, bound_by=by,
                         bytes_ms=t_bytes, ops_ms=t_ops))
    print()
    print("| kernel (720p, c = 64) | port | GFLOP | float32 CUDA cores ms | 3xTF32 ms | "
          "bf16 tensor cores ms | bytes ms f32 / bf16 |")
    print("|---|---|---|---|---|---|---|")
    model = []
    for label, port, flop, nbytes in model_kernels():
        b32, b16 = conv_bounds(flop, nbytes[F32]), conv_bounds(flop, nbytes[BF16])
        print(f"| {label} | {port} | {flop * 1e-9:.4g} | {b32['f32_ms']:.4g} | "
              f"{b32['tf32x3_ms']:.4g} | {b32['bf16_ms']:.4g} | {b32['bytes_ms']:.4g} / "
              f"{b16['bytes_ms']:.4g} |")
        model.append(dict(kernel=label, port=port, flop=flop, f32_ms=b32["f32_ms"],
                          tf32x3_ms=b32["tf32x3_ms"], bf16_ms=b32["bf16_ms"],
                          bytes_ms_f32=b32["bytes_ms"], bytes_ms_bf16=b16["bytes_ms"]))
    print(json.dumps({"bounds": rows, "model_kernels": model}))
    return rows


if __name__ == "__main__":
    main()
