#!/usr/bin/env python
"""The least time an NVIDIA H100 could take for the work of each B10 TPU probe
of the JAX package (ROADMAP Queue B), worked out from each function's own
shapes, with the Hopper kernel that ports it (K6-K10) or none yet. The model
kernels' bounds (K1-K5) are computed by chip_smoke.py from the inputs of
its run, and so are the probe kernels' (phase 12), through the work
functions below.

A bound is the larger of two times: the bytes the function must move (each
input byte it reads once, each output written once) over the card's memory
rate, and the operations it does on those inputs over the card's peak rate
for their type. Rates are the H100 SXM's published dense peaks (NVIDIA's
data sheet): 3.35 TB/s HBM3, 67 TFLOP/s float32 on the CUDA cores, 989
TFLOP/s bf16 and 1,979 TOP/s int8 on the tensor cores, at the full 700 W
power limit. Operations of different types add their times.

The TPU probes are counted at the constants of their own files. For the
ported ones the count is that of the Hopper kernel's function: a window copy
reads only its window (the TPU's 48-row band for 8 output rows was its
layout's); a selection matmul needs what its data needs, two taps a row of S
and two terms a pixel of vm as build_s and the probe's vm have them (the
dense products the TPU ran are given beside, as ``dense_ops``). The warp
probes still to port count as the tensor-core products the TPU ran them as;
elementwise selects and blends as float32 operations.

    python tools/torch_kernel_bounds.py        # a markdown table, then one JSON line
"""

import json

HBM_BYTES_S, F32_FLOP_S, BF16_TC_FLOP_S, INT8_TC_OP_S = 3.35e12, 67e12, 989e12, 1979e12
RATE = {"f32": F32_FLOP_S, "bf16": BF16_TC_FLOP_S, "int8": INT8_TC_OP_S}
F32, BF16, INT8, I32 = 4, 2, 1, 4
TILE, BAND_ROWS = 128, 8  # the selection matmul's tile width and band height


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
    H, W, C, B, WP, BAND, HP, NT, DV = 720, 1280, 64, 8, 1344, 48, 760, 10, 40
    NBY, NBX = H // B, W // B
    xp, out = n(HP, WP, C) * BF16, n(H, W, C) * BF16
    rows.append(("B10", "tools/warp_kernel_probe.py:68 probe_floor",
                 dict(bytes=xp + out, ops={"f32": n(H, W, C)}), None))
    rows.append(("B10", "tools/warp_kernel_probe.py:123 probe_select", dict(
        bytes=2 * n(NBY, W) * I32 + 4 * n(NBY, W) * F32 + xp + out,
        ops={"f32": NBY * 2 * 35 * (BAND + B) * W * C}), None))
    rows.append(("B10", "tools/warp_kernel_probe.py:177 probe_dma", dict(
        bytes=2 * n(NBY, NBX) * I32 + xp + out, ops={"f32": 2 * n(H, W, C)}), None))
    rows.append(("B10", "tools/warp_kernel_probe2.py:77 probe_floor128",
                 copy_work(1, H, H, W // 2, 2 * C), "K6"))
    rows.append(("B10", "tools/warp_kernel_probe2.py:125 probe_mmsel", mmsel_work(
        NBY, NT, KW, C, DV + B - 1, W, DV, s_nnz=2 * NBY * W, vm_nnz=2 * NBY * W), "K7"))
    # tools/dma_probe.py:12-17: H, W = 720, 1280; PF (HP, WP, 128) = (736, 656, 128) bf16
    HP, WP = 720 + 16, 1280 // 2 + 16
    z = n(HP, WP, 128) * BF16
    for fn, line in (("run", 86), ("run_pipelined", 149)):
        for write_out in (False, True):
            rows.append(("B10", f"tools/dma_probe.py:{line} {fn}(write_out={write_out})", dict(
                bytes=z + (z if write_out else n(8, 128) * BF16), ops={}), None))
    # tools/int8_probe.py:27-29: M, K, N = 4096, 128, 128; band (24, 656, 128); out 16 x 320
    M, K, N_, BH, BW, C2, ROWS, COLS = 4096, 128, 128, 24, 656, 128, 16, 320
    rows += [
        ("B10", "tools/int8_probe.py:70 k1 (bf16 matmul)", matmul_work(M, K, N_, "bf16"), "K8"),
        ("B10", "tools/int8_probe.py:80 k2 (int8 matmul)",
         matmul_work(M, K, N_, "int8", out_bytes=I32), "K8"),
        ("B10", "tools/int8_probe.py:100 k3 (quantize + int8 matmul)",
         quantized_matmul_work(M, K, N_), "K9 + K8"),
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
    print(json.dumps({"bounds": rows}))
    return rows


if __name__ == "__main__":
    main()
