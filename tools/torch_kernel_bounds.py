#!/usr/bin/env python
"""The least time an NVIDIA H100 could take for the work of each TPU kernel of
the JAX package that the port has not ported yet (ROADMAP Queue B: the B10
probes), worked out from each function's own shapes. The ported kernels'
bounds are computed by chip_smoke.py from the inputs of its run.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate, and
the operations it does on those inputs over the card's peak rate for their
type. Rates are the H100 SXM's published dense peaks (NVIDIA's data sheet):
3.35 TB/s HBM3, 67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16 and
1,979 TOP/s int8 on the tensor cores, at the full 700 W power limit.

The TPU probes are counted at the constants of their own files. Selection
matmuls of the warp probes count as the tensor-core products the TPU ran
them as; elementwise selects and blends as float32 operations.

    python tools/torch_kernel_bounds.py        # a markdown table, then one JSON line
"""

import json

HBM_BYTES_S, F32_FLOP_S, BF16_TC_FLOP_S, INT8_TC_OP_S = 3.35e12, 67e12, 989e12, 1979e12
RATE = {"f32": F32_FLOP_S, "bf16": BF16_TC_FLOP_S, "int8": INT8_TC_OP_S}
F32, BF16, INT8, I32 = 4, 2, 1, 4


def n(*shape):
    out = 1
    for s in shape:
        out *= s
    return out


def probes():
    """B10 at the constants of each probe file."""
    rows = []
    # tools/warp_bisect.py:19-23: H, W = 64, 256; BAND 48; TILE 128; KW 184; WPAD 320
    H, W, BAND, TILE, KW, WPAD = 64, 256, 48, 128, 184, 320
    for lanes in (64, 128):
        rows.append(("B10", f"tools/warp_bisect.py:43 k_dma({lanes})", dict(
            bytes=n(H + 40, WPAD, lanes) * BF16 + n(H, W, lanes) * BF16,
            ops={"f32": n(H, W, lanes)})))
    rows.append(("B10", "tools/warp_bisect.py:67 k_nodma(64)", dict(
        bytes=n(H, WPAD, 64) * BF16 + n(H, W, 64) * BF16, ops={"f32": n(H, W, 64)})))
    for lanes in (64, 128):
        rows.append(("B10", f"tools/warp_bisect.py:84 k_fori_dot({lanes})", dict(
            bytes=n(TILE, KW) * BF16 + n(H + 40, WPAD, lanes) * BF16 + n(H, W, lanes) * BF16,
            ops={"bf16": 2 * (H // 8) * BAND * TILE * KW * lanes})))
    # tools/warp_kernel_probe.py:29-36 and warp_kernel_probe2.py:34-45: 720p, C 64,
    # B 8, WP 1344, BAND 48, HP 760, TILE 128, KW 184, NT 10, DV 40
    H, W, C, B, WP, BAND, HP, TILE, KW, NT, DV = 720, 1280, 64, 8, 1344, 48, 760, 128, 184, 10, 40
    NBY, NBX = H // B, W // B
    xp, out = n(HP, WP, C) * BF16, n(H, W, C) * BF16
    rows.append(("B10", "tools/warp_kernel_probe.py:68 probe_floor",
                 dict(bytes=xp + out, ops={"f32": n(H, W, C)})))
    rows.append(("B10", "tools/warp_kernel_probe.py:123 probe_select", dict(
        bytes=2 * n(NBY, W) * I32 + 4 * n(NBY, W) * F32 + xp + out,
        ops={"f32": NBY * 2 * 35 * (BAND + B) * W * C})))
    rows.append(("B10", "tools/warp_kernel_probe.py:177 probe_dma", dict(
        bytes=2 * n(NBY, NBX) * I32 + xp + out, ops={"f32": 2 * n(H, W, C)})))
    rows.append(("B10", "tools/warp_kernel_probe2.py:77 probe_floor128", dict(
        bytes=n(HP, WP // 2, 2 * C) * BF16 + n(H, W // 2, 2 * C) * BF16,
        ops={"f32": n(H, W, C)})))
    rows.append(("B10", "tools/warp_kernel_probe2.py:125 probe_mmsel", dict(
        bytes=n(NBY, NT, TILE, KW) * BF16 + n(NBY, W, DV) * F32 + xp + out,
        ops={"bf16": 2 * NBY * NT * BAND * TILE * KW * C,
             "f32": 2 * NBY * DV * B * W * C})))
    # tools/dma_probe.py:12-17: H, W = 720, 1280; PF (HP, WP, 128) = (736, 656, 128) bf16
    HP, WP = 720 + 16, 1280 // 2 + 16
    z = n(HP, WP, 128) * BF16
    for fn, line in (("run", 86), ("run_pipelined", 149)):
        for write_out in (False, True):
            rows.append(("B10", f"tools/dma_probe.py:{line} {fn}(write_out={write_out})", dict(
                bytes=z + (z if write_out else n(8, 128) * BF16), ops={})))
    # tools/int8_probe.py:27-29: M, K, N = 4096, 128, 128; band (24, 656, 128); out 16 x 320
    M, K, N_, BH, BW, C2, ROWS, COLS = 4096, 128, 128, 24, 656, 128, 16, 320
    mm = 2 * M * K * N_
    rows += [
        ("B10", "tools/int8_probe.py:70 k1 (bf16 matmul)", dict(
            bytes=(M * K + K * N_) * BF16 + M * N_ * F32, ops={"bf16": mm})),
        ("B10", "tools/int8_probe.py:80 k2 (int8 matmul)", dict(
            bytes=(M * K + K * N_) * INT8 + M * N_ * I32, ops={"int8": mm})),
        ("B10", "tools/int8_probe.py:100 k3 (quantize + int8 matmul)", dict(
            bytes=M * K * BF16 + K * N_ * INT8 + M * N_ * F32,
            ops={"int8": mm, "f32": 4 * M * K})),
        ("B10", "tools/int8_probe.py:127 k4 (int8 tap conv)", dict(
            bytes=n(BH, BW, C2) * BF16 + n(3, 3, C2, C2) * INT8 + n(ROWS, COLS, C2) * F32,
            ops={"int8": 2 * 9 * ROWS * COLS * C2 * C2, "f32": 4 * n(BH, BW, C2)})),
        ("B10", "tools/int8_probe.py:148 k5 (bf16 tap conv)", dict(
            bytes=n(BH, BW, C2) * BF16 + n(3, 3, C2, C2) * BF16 + n(ROWS, COLS, C2) * F32,
            ops={"bf16": 2 * 9 * ROWS * COLS * C2 * C2})),
    ]
    return rows


def bound(work):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms)."""
    t_bytes = work["bytes"] / HBM_BYTES_S * 1e3
    t_ops = sum(v / RATE[k] for k, v in work["ops"].items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def main():
    rows = []
    print("| item | TPU function | bytes | operations | bound ms (by) |")
    print("|---|---|---|---|---|")
    for item, fn, work in probes():
        ms, by, t_bytes, t_ops = bound(work)
        ops = ", ".join(f"{v:.4g} {k}" for k, v in work["ops"].items()) or "—"
        print(f"| {item} | `{fn}` | {work['bytes']:.4g} | {ops} | {ms:.4g} ({by}) |")
        rows.append(dict(item=item, function=fn, bytes=work["bytes"], ops=work["ops"],
                         bound_ms=ms, bound_by=by, bytes_ms=t_bytes, ops_ms=t_ops))
    print(json.dumps({"bounds": rows}))
    return rows


if __name__ == "__main__":
    main()
