"""The probe kernels K6-K13: the TPU micro-benchmarks of ``tools/`` as
hand-written Hopper kernels (``csrc/probe_*.cu``; K7, both forms of K8
and of K10 on ``wgmma``, their operands copied by the tensor memory
accelerator (``csrc/tma.cuh``), K7's and K10's through
``csrc/wg_conv.cuh``'s rings; K9 one cooperative launch that reads its
input once), with their plain PyTorch versions. K7-K10
multiply on the matrix unit; K6 and K11-K13 move data. No model path runs
them; ``tools/torch_int8_probe.py``, ``tools/torch_warp_kernel_probe2.py``,
``tools/torch_warp_bisect.py``, ``tools/torch_warp_kernel_probe.py`` and
``tools/torch_dma_probe.py`` drive them.

======  ===================  ========================  =========================================
kernel  wrapper              source                    TPU functions (``pallas_call`` at)
======  ===================  ========================  =========================================
K6      ``window_copy``      ``csrc/probe_copy.cu``    warp_kernel_probe2.py ``probe_floor128``
                                                       (:78); warp_bisect.py ``k_dma`` (:52),
                                                       ``k_nodma`` (:72); warp_kernel_probe.py
                                                       ``probe_floor`` (:69)
K7      ``mmsel_warp``,      ``csrc/probe_mmsel.cu``   warp_kernel_probe2.py ``probe_mmsel``
        ``mmsel_h``                                    (:126); warp_bisect.py ``k_fori_dot`` (:105)
K8      ``matmul``           ``csrc/probe_matmul.cu``  int8_probe.py k1 (:70), k2 (:80), k3's
                                                       product (:100)
K9      ``absmax_quantize``  ``csrc/probe_matmul.cu``  int8_probe.py k3's and k4's quantize
K10     ``tapconv``          ``csrc/probe_tapconv.cu`` int8_probe.py k5 (:148); int8: k4 (:127)
K11     ``gather2``          ``csrc/probe_gather.cu``  warp_kernel_probe.py ``probe_select`` (:124)
K12     ``block_windows``    ``csrc/probe_blockdma.cu`` warp_kernel_probe.py ``probe_dma`` (:179)
K13     ``ring_copy``,       ``csrc/probe_ring.cu``    dma_probe.py ``run`` (:104),
        ``stream_copy``                                ``run_pipelined`` (:173)
======  ===================  ========================  =========================================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
checks device, dtype, shape, contiguity and 16-byte alignment, then launches
its kernel or raises. K13's persistent bulk-copy design takes its work as
a list of items; :func:`ring_schedule` and :func:`stream_grid` compute what
its wrappers hand the C entries, and :func:`ring_items` spells out the
items as the kernel decodes them. K7's and K10's persistent wgmma designs
do the same: :func:`mmsel_schedule` / :func:`mmsel_items`,
:func:`tapconv_schedule` / :func:`tapconv_items` and, for K10's int8 form,
:func:`tapconv8_schedule` / :func:`tapconv8_items`; :func:`matmul_tiles`
spells out K8's blocks and their depth chunks, :func:`absmax_schedule` /
:func:`absmax_walk` K9's grid, its blocks' slices and the order in which
each reads them. This module's ``LAUNCHES`` (apart from the model kernels'
``launch.LAUNCHES``) counts one per kernel call (K13 counts its two
kernels apart, K8 and K10 their bf16 and int8 forms, ``matmul`` and
``matmul_int8``, ``tapconv`` and ``tapconv_int8``); :func:`reset_launches`
zeroes it.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .build import library
from .launch import SMEM_MAX, call, on_cpu

__all__ = [
    "LAUNCHES", "reset_launches",
    "window_copy", "window_copy_plain", "mmsel_warp", "mmsel_warp_plain", "mmsel_h",
    "mmsel_h_plain", "build_s", "matmul", "matmul_plain", "absmax_quantize",
    "absmax_quantize_plain", "tapconv", "tapconv_plain", "gather2", "gather2_plain",
    "block_windows", "block_windows_plain", "ring_copy", "stream_copy", "ring_copy_plain",
    "timed", "bf16_from_numpy", "sm_count", "ring_schedule", "ring_items", "ring_stage_bytes",
    "stream_grid", "mmsel_schedule", "mmsel_items", "tapconv_schedule", "tapconv_items",
    "matmul_tiles", "matmul_tile_shape", "matmul8_smem", "tapconv8_schedule", "tapconv8_items",
    "tapconv8_smem", "gather2_items", "absmax_schedule", "absmax_walk",
]

TILE = 128       # output columns a tile of the selection matmul (rows of S)
BAND_ROWS = 8    # output rows a band
_KP = 192        # K7's depth: S's kw zero-padded to 12 k-steps of 16
_DV_MAX = 40     # K7's V terms at most
# K7's wgmma design, as csrc/probe_mmsel.cu has it
MMSEL_CHANNELS = 32         # channels an item (the product's N)
MMSEL_STAGES = 6            # window rows in flight
MMSEL_ROW_BYTES = _KP * MMSEL_CHANNELS * 2
MMSEL_S_IMAGE = 3 * TILE * 128  # S's image: three 64-tap blocks of 128-byte rows
MMSEL_BARRIERS = 2 * MMSEL_STAGES + 4
# K10's bf16 wgmma design, as csrc/probe_tapconv.cu has it
TAPCONV_COLS = 32           # output columns an item
TAPCONV_COUT = 64           # output channels an item
TAPCONV_STAGES = 6          # weight stages of 64 x 64 bf16
TAPCONV_BARRIERS = 2 * TAPCONV_STAGES + 4
# K10's int8 wgmma design (csrc/probe_tapconv.cu: tapconv8_wg): 64-channel
# (64-byte) chunks of the patch, each block's 64-channel output part of the
# weights resident
TAPCONV8_PIX = 64
# K8's bf16 wgmma design, as csrc/probe_matmul.cu has it: out tiles of
# MATMUL_TILE x MATMUL_TILE, the depth in chunks of MATMUL_CHUNK, a ring of
# MATMUL_STAGES stages of two 8 KB boxes; a block's shared memory
MATMUL_TILE = 64
MATMUL_CHUNK = 64
MATMUL_STAGES = 4
MATMUL_SMEM = 1024 + MATMUL_STAGES * 2 * MATMUL_TILE * 128 + 2 * MATMUL_STAGES * 8
# K8's int8 wgmma design (csrc/probe_matmul.cu: matmul8_wg): the same out
# tiles, the depth in chunks of MATMUL8_CHUNK bytes, A through a ring of
# MATMUL_STAGES 8 KB boxes, B's K-major image resident up to MATMUL8_MAXK
# (past it the mma.sync design's 128 x 64 tiles)
MATMUL8_CHUNK = 128
MATMUL8_MAXK = 2048
# K9 (csrc/probe_matmul.cu: absmax_quantize_kernel): blocks of AQ_THREADS,
# a block's slice in 16-byte vectors of 8 values, the first AQ_HOLD of it
# held in shared memory in chunks of AQ_CHUNK (a pair of vectors a
# thread), the rest read again in iterations of AQ_STEP; a block takes at
# least AQ_MIN_VECS vectors where the tensor allows
AQ_THREADS = 512
AQ_CHUNK = 2 * AQ_THREADS
AQ_HOLD = 7 * AQ_CHUNK
AQ_SMEM = 16 * AQ_HOLD
AQ_STEP = 2 * AQ_THREADS * 2
AQ_MIN_VECS = 512
_TYPE_CODE = {torch.bfloat16: 1, torch.int8: 2}

GATHER_SHIFTS = 35  # K11: the TPU kernel's masked sums run over 35 shifts a pass
GATHER_BAND = GATHER_SHIFTS - 1 + BAND_ROWS  # band rows K11's V pass can reach (42)
RING_SPLITS = (1, 2, 4)
RING_MAX_DEPTH = 9  # K13: a ring of depth + 1 stages, at most the TPU ring's 10 slots
# the bulk-copy design's constants, as csrc/probe_ring.cu has them
RING_STAGE_MAX = 49152  # K13: a stage's bytes at most
RING_BAR_BYTES = 256    # K13's room for its mbarriers and the items its stages hold
STREAM_BLOCKS_PER_SM = 8

LAUNCHES = {"window_copy": 0, "mmsel": 0, "matmul": 0, "matmul_int8": 0, "absmax_quantize": 0,
            "tapconv": 0, "tapconv_int8": 0, "gather2": 0, "block_windows": 0, "ring_copy": 0,
            "stream_copy": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _call(name, entry, device, *args):
    call(name, entry, device, *args, counts=LAUNCHES)


def _ceil_div(a, b):
    return -(-a // b)


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev):
    """The streaming multiprocessors of CUDA device ``dev``."""
    return _sms(torch.device(dev).index or 0)


def _cuda_args(name, tensors, dtypes):
    """Every tensor on one CUDA device with the dtype at its place in
    ``dtypes``, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise TypeError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return dev


# ---- K6: the scaled window copy ------------------------------------------------------------


def window_copy_plain(src, out_h, out_w, y0, x0, period=0):
    """``out[b, r, x] = 2 * src[b, y0 + (r % period if period else r), x0 + x]``."""
    r = torch.arange(out_h, device=src.device)
    return src[:, y0 + (r % period if period else r), x0:x0 + out_w] * 2


def window_copy(src, out_h, out_w, y0, x0, period=0):
    """K6. ``src (b, hs, ws, lanes)`` bfloat16, lanes % 8 == 0 on the card;
    returns ``(b, out_h, out_w, lanes)``. The window must lie inside src."""
    b, hs, ws, lanes = src.shape
    if (y0 < 0 or x0 < 0 or period < 0 or x0 + out_w > ws
            or y0 + (min(period, out_h) if period else out_h) > hs):
        raise ValueError(f"window_copy: window ({out_h}, {out_w}) at ({y0}, {x0}), period "
                         f"{period}, outside src {tuple(src.shape)}")
    if on_cpu(src):
        return window_copy_plain(src, out_h, out_w, y0, x0, period)
    _cuda_args("window_copy", [src], [torch.bfloat16])
    if lanes % 8:
        raise ValueError(f"window_copy: lanes must be a multiple of 8, got {lanes}")
    out = torch.empty((b, out_h, out_w, lanes), dtype=src.dtype, device=src.device)
    _call("window_copy", "pnp_window_copy", src.device, src, out, b, hs, ws, out_h, out_w, lanes,
         y0, x0, period)
    return out


# ---- K7: the selection-matmul warp ---------------------------------------------------------


def build_s(m0, w0, w1, kw=184):
    """(nb, w) taps -> (nb, w // 128, 128, kw) bfloat16 selection matrices:
    row o of tile tj holds w0 at column m0 - 128 tj and w1 one further
    (tools/warp_kernel_probe2.py: build_s, :150)."""
    nb, w = m0.shape
    nt = w // TILE
    m = m0.reshape(nb, nt, TILE) - (torch.arange(nt, device=m0.device) * TILE).reshape(1, nt, 1)
    iota = torch.arange(kw, device=m0.device, dtype=m.dtype)
    m = m[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=m0.device)
    s = torch.where(iota == m, w0.reshape(nb, nt, TILE, 1), zero)
    s = s + torch.where(iota == m + 1, w1.reshape(nb, nt, TILE, 1), zero)
    return s.to(torch.bfloat16)


def _mmsel_hband(src, s, nb, j0, nrows):
    """``hband (nb, nrows, nt * 128, c)`` bfloat16: the H pass on rows
    ``8 ri + j0 + j``, float32 sums of exact bf16 products, one rounding."""
    _, hs, ws, c = src.shape
    nt, kw = s.shape[1], s.shape[3]
    dev = src.device
    rows = torch.arange(nb, device=dev)[:, None] * BAND_ROWS + j0 + torch.arange(nrows, device=dev)
    cols = torch.arange(nt, device=dev)[:, None] * TILE + torch.arange(kw, device=dev)
    win = src[0][rows][:, :, cols].float()  # (nb, nrows, nt, kw, c)
    h = torch.einsum("btok,brtkc->brtoc", s.float().expand(nb, -1, -1, -1), win)
    return h.reshape(nb, nrows, nt * TILE, c).to(torch.bfloat16)


def mmsel_warp_plain(xp, s, vm):
    """The selection-matmul warp (tools/warp_kernel_probe2.py: _mmsel_kernel,
    :93). ``xp (1, hs, ws, c)`` bfloat16, ``s (nb, nt, 128, kw)`` bfloat16,
    ``vm (nb, 128 nt, dv)`` float32 -> ``(1, 8 nb, 128 nt, c)`` bfloat16:
    the H pass rounded to bfloat16 on rows 0 .. dv + 6 of each band, then
    ``sum_d vm[ri, x, d] * hband[d + i, x]`` in float32 in the order d = 0,
    1, ..., each term a fused multiply-add, as XLA compiles the TPU kernel's
    ``acc + h * w`` (the exact product added in float64, then rounded)."""
    nb, dv = s.shape[0], vm.shape[2]
    hb = _mmsel_hband(xp, s, nb, 0, dv + BAND_ROWS - 1).double()
    acc = torch.zeros((nb, BAND_ROWS) + hb.shape[2:], dtype=torch.float32, device=xp.device)
    for d in range(dv):
        acc = (acc.double() + hb[:, d:d + BAND_ROWS] * vm[:, None, :, d, None].double()).float()
    return acc.to(torch.bfloat16).reshape(1, nb * BAND_ROWS, *hb.shape[2:])


def mmsel_h_plain(x, s, nb, j0, out_w):
    """The H pass alone (tools/warp_bisect.py: k_fori_dot, :84): ``out[0,
    8 ri + i, o] = bf16(s[0, tj] @ x[0, 8 ri + j0 + i, 128 tj .. + kw])`` for
    o < 128 nt, zeros past it. ``s (1, nt, 128, kw)`` serves every band."""
    h = _mmsel_hband(x, s, nb, j0, BAND_ROWS)
    out = torch.zeros((1, nb * BAND_ROWS, out_w, x.shape[3]), dtype=torch.bfloat16, device=x.device)
    out[0, :, :h.shape[2]] = h.reshape(nb * BAND_ROWS, h.shape[2], x.shape[3])
    return out


def _waves_then_rows(options, sms):
    """Of ``(rows an item, items)`` pairs, the one whose items take the
    fewest rows a block (waves over ``sms`` times rows), the larger item on
    a tie."""
    return min(options, key=lambda o: (_ceil_div(o[1], sms) * o[0], -o[0]))


def mmsel_schedule(nb, nt, c, dv, v_mode, sms):
    """K7's work (csrc/probe_mmsel.cu): items of (band, tile, row group,
    32-channel part), the part fastest, ``items`` in all, dealt to ``grid``
    persistent blocks (one a SM) in turn. The V mode runs a band's ``dv +
    7`` H rows in one item; the H mode cuts a band's 8 rows into groups of
    ``rows_item`` (2, 4 or 8) so that the items fill the card.
    ``smem`` is a block's shared memory."""
    ncp = _ceil_div(c, MMSEL_CHANNELS)
    if v_mode:
        rows_item, nrows = BAND_ROWS, dv + BAND_ROWS - 1
    else:
        rows_item = _waves_then_rows(  # 2 at least: the kernel runs rows in pairs
            [(r, nb * nt * ncp * BAND_ROWS // r) for r in (8, 4, 2)], sms)[0]
        nrows = rows_item
    nrg = 1 if v_mode else BAND_ROWS // rows_item
    items = nb * nt * nrg * ncp
    slot = _ceil_div(MMSEL_S_IMAGE + (TILE * dv * 4 if v_mode else 0), 1024) * 1024
    return dict(ncp=ncp, rows_item=rows_item, nrg=nrg, nrows=nrows, items=items,
                grid=min(sms, items),
                smem=1024 + MMSEL_STAGES * MMSEL_ROW_BYTES + 2 * slot + 8 * MMSEL_BARRIERS)


def mmsel_items(nb, nt, c, dv, v_mode, sms):
    """K7's items as the kernel decodes them, per block: ``(band, tile, row
    group, channel part)`` in the order the block takes them."""
    sc = mmsel_schedule(nb, nt, c, dv, v_mode, sms)
    blocks = [[] for _ in range(sc["grid"])]
    for it in range(sc["items"]):
        rest, cp = divmod(it, sc["ncp"])
        rest, rg = divmod(rest, sc["nrg"])
        ri, tj = divmod(rest, nt)
        blocks[it % sc["grid"]].append((ri, tj, rg, cp))
    return blocks


def _mmsel_launch(src, s, vm, nb, j0, out_w):
    _, hs, ws, c = src.shape
    ns, nt, tile, kw = s.shape
    dev = _cuda_args("mmsel", [src, s] + ([vm] if vm is not None else []),
                     [torch.bfloat16, torch.bfloat16, torch.float32])
    if src.shape[0] != 1 or c % 8 or tile != TILE or not 1 <= kw <= _KP or ns not in (1, nb):
        raise ValueError(f"mmsel: need src (1, h, w, c % 8 == 0) and s ({nb} or 1, nt, 128, "
                         f"kw <= {_KP}); got {tuple(src.shape)}, {tuple(s.shape)}")
    if TILE * (nt - 1) + kw > ws:
        raise ValueError(f"mmsel: the last tile's window (to {TILE * (nt - 1) + kw}) passes src "
                         f"width {ws}")
    dv = 0
    if vm is not None:
        dv = vm.shape[2]
        if vm.shape != (nb, TILE * nt, dv) or not 1 <= dv <= _DV_MAX:
            raise ValueError(f"mmsel: need vm ({nb}, {TILE * nt}, dv <= {_DV_MAX}); got "
                             f"{tuple(vm.shape)}")
        if BAND_ROWS * (nb - 1) + dv + BAND_ROWS - 1 > hs:
            raise ValueError(f"mmsel: src has {hs} rows, the bands need "
                             f"{BAND_ROWS * (nb - 1) + dv + BAND_ROWS - 1}")
    elif j0 < 0 or BAND_ROWS * nb + j0 > hs or out_w < TILE * nt:
        raise ValueError(f"mmsel: {nb} bands from row {j0} or width {out_w} do not fit src "
                         f"{tuple(src.shape)}")
    out = torch.empty((1, nb * BAND_ROWS, out_w, c), dtype=torch.bfloat16, device=dev)
    s_band = 0 if ns == 1 else nt * TILE * kw  # one S for every band, or one a band
    sc = mmsel_schedule(nb, nt, c, dv, vm is not None, sm_count(dev))
    _call("mmsel", "pnp_mmsel", dev, src, s, vm, out, nb, nt, hs, ws, c, kw, s_band, TILE * kw, j0,
          dv, out_w, sc["rows_item"], sc["grid"])
    return out


def mmsel_warp(xp, s, vm):
    """K7 in the V mode (probe_mmsel): see :func:`mmsel_warp_plain`."""
    if on_cpu(xp):
        return mmsel_warp_plain(xp, s, vm)
    return _mmsel_launch(xp, s, vm, s.shape[0], 0, s.shape[1] * TILE)


def mmsel_h(x, s, nb, j0, out_w):
    """K7 in the H mode (k_fori_dot): see :func:`mmsel_h_plain`."""
    if on_cpu(x):
        return mmsel_h_plain(x, s, nb, j0, out_w)
    return _mmsel_launch(x, s, None, nb, j0, out_w)


# ---- K8 and K9: matrix product and per-tensor int8 quantization ----------------------------


def matmul_plain(a, b, scale=None):
    """``a @ b``: bfloat16 -> float32 (float32 sums), int8 -> int32 (exact,
    through float64), int8 with a one-element ``scale`` -> float32
    ``float(a @ b) * scale``."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float()
    acc = (a.double() @ b.double()).to(torch.int32)
    return acc if scale is None else acc.float() * scale


def matmul_tile_shape(dtype, k=0):
    """K8's ``(rows, columns, depth chunk)`` of a block's out tile: bf16 the
    wgmma design's (csrc/probe_matmul.cu: matmul_wg, 64 x 64, 64 deep), int8
    up to a depth of ``MATMUL8_MAXK`` the s8 wgmma design's (``matmul8_wg``:
    64 x 64, 128 bytes deep), past it the mma.sync design's
    (``matmul_kernel``: 128 x 64, 128 bytes)."""
    if dtype == torch.bfloat16:
        return MATMUL_TILE, MATMUL_TILE, MATMUL_CHUNK
    if k <= MATMUL8_MAXK:
        return MATMUL_TILE, MATMUL_TILE, MATMUL8_CHUNK
    return 128, 64, 128


def matmul_tiles(m, n, k, dtype=torch.bfloat16):
    """K8's blocks as its kernel takes them: ``[((m0, n0), [k0 of each depth
    chunk])]``, a block the out rows ``[m0, m0 + rows)`` and columns ``[n0,
    n0 + columns)`` of :func:`matmul_tile_shape`, its depth in chunks from
    each k0; zeros past m, n and k (the tensor maps' fill; int8's B image
    zeroed there)."""
    tm, tn, kc = matmul_tile_shape(dtype, k)
    chunks = list(range(0, k, kc))
    return [((m0, n0), chunks) for m0 in range(0, m, tm) for n0 in range(0, n, tn)]


def matmul8_smem(k):
    """The int8 wgmma design's dynamic shared memory a block at depth k: the
    alignment slack, A's ring of 8 KB boxes, B's resident K-major image (8
    KB a 128-deep chunk), the two 8 KB output boxes, the barriers (as
    csrc/probe_matmul.cu: m8::smem)."""
    chunk = MATMUL_TILE * MATMUL8_CHUNK
    return (1024 + MATMUL_STAGES * chunk + _ceil_div(k, MATMUL8_CHUNK) * chunk
            + 2 * MATMUL_TILE * 128 + 2 * MATMUL_STAGES * 8)


def matmul(a, b, scale=None):
    """K8. ``a (m, k)``, ``b (k, n)`` both bfloat16 (float32 out; the wgmma
    design) or both int8 (int32 out, or float32 with a float32 ``scale`` of
    one element in device memory; the s8 wgmma design, counted under
    ``matmul_int8``); m % 16 == 0, n % 8 == 0, k % 16 (bf16) or % 32 (int8)."""
    if on_cpu(a):
        return matmul_plain(a, b, scale)
    if a.dtype not in _TYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"matmul: need two bfloat16 or two int8 matrices, got {a.dtype}, {b.dtype}")
    if a.dtype == torch.bfloat16 and scale is not None:
        raise ValueError("matmul: a scale goes with int8 inputs")
    dev = _cuda_args("matmul", [a, b] + ([scale] if scale is not None else []),
                     [a.dtype, a.dtype, torch.float32])
    (m, k), (k2, n) = a.shape, b.shape
    step = 16 if a.dtype == torch.bfloat16 else 32
    if k2 != k or m % 16 or n % 8 or k % step or (scale is not None and scale.numel() != 1):
        raise ValueError(f"matmul: need (m % 16, k % {step}) @ (k, n % 8) and one scale; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    int_out = a.dtype == torch.int8 and scale is None
    out = torch.empty((m, n), dtype=torch.int32 if int_out else torch.float32, device=dev)
    name = "matmul" if a.dtype == torch.bfloat16 else "matmul_int8"
    _call(name, "pnp_matmul", dev, _TYPE_CODE[a.dtype], a, b, scale, out, m, n, k)
    return out


def absmax_quantize_plain(x):
    """``(q, s)``: ``s = max(max|x|, 1e-6) / 127`` (float32, one element),
    ``q = clip(round_half_even(x / s), -127, 127)`` int8. The divisions
    take tensor divisors: a Python scalar divisor on CUDA becomes a
    multiplication by its reciprocal, which is not IEEE division."""
    a = x.float()
    amax = torch.clamp_min(a.abs().max(), 1e-6)
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(a / s), -127, 127).to(torch.int8)
    return q, s.reshape(1)


def absmax_schedule(n, sms, blocks_per_sm):
    """K9's one launch over ``n`` values (n % 8 == 0): ``grid`` blocks, all
    resident (at most ``blocks_per_sm`` x ``sms``), each at least
    ``AQ_MIN_VECS`` vectors of 8 values where n allows; block b takes the
    ``per`` vectors from b per (even, so that a thread's pair of vectors
    lies in one block; the last block what remains, none empty); ``vectors``
    the tensor's 16-byte vectors, ``held`` a full block's vectors in shared
    memory."""
    n16 = n // 8
    grid = max(1, min(sms * blocks_per_sm, _ceil_div(n16, AQ_MIN_VECS)))
    per = _ceil_div(n16, grid)
    per += per % 2
    grid = _ceil_div(n16, per)
    return dict(grid=grid, per=per, vectors=n16, held=min(per, AQ_HOLD))


def absmax_walk(n, grid, per):
    """K9's blocks as its kernel decodes them, one dict a block: ``slice``
    ``(first, end)`` of its vectors; ``held`` the first ``min(len, AQ_HOLD)``
    in chunks of ``AQ_CHUNK`` (``[(first, count)]``, one bulk copy each);
    ``pass1`` the re-read vectors in the order pass one reads them
    (iterations of ``AQ_STEP`` forward), ``pass2`` the order pass two reads
    them again (the iterations backwards); within an iteration thread t's
    pair u is vectors base + 2 (u AQ_THREADS + t), + 1."""
    n16 = n // 8
    blocks = []
    for b in range(grid):
        v0 = b * per
        length = min(v0 + per, n16) - v0
        nheld = min(length, AQ_HOLD)
        chunks = [(v0 + c, min(AQ_CHUNK, nheld - c)) for c in range(0, nheld, AQ_CHUNK)]
        r0, end = v0 + nheld, v0 + length
        iters = [[p + e for u in range(2) for t in range(AQ_THREADS)
                  for p in [r0 + it * AQ_STEP + 2 * (u * AQ_THREADS + t)] for e in (0, 1)
                  if p + e < end]
                 for it in range(_ceil_div(end - r0, AQ_STEP))]
        blocks.append(dict(slice=(v0, end), held=chunks, pass1=[v for i in iters for v in i],
                           pass2=[v for i in reversed(iters) for v in i]))
    return blocks


@functools.cache
def _absmax_blocks_per_sm(index):
    """K9's blocks an SM of device ``index`` holds at its shared memory."""
    with torch.cuda.device(index):
        blocks = library().lib.pnp_absmax_blocks_per_sm()
    if blocks < 1:
        raise RuntimeError("absmax_quantize: the occupancy query failed or no block fits an SM")
    return blocks


def absmax_quantize(x):
    """K9, one launch. ``x`` bfloat16, numel % 8 == 0 on the card -> ``(q,
    s)`` as :func:`absmax_quantize_plain`, s in device memory."""
    if on_cpu(x):
        return absmax_quantize_plain(x)
    dev = _cuda_args("absmax_quantize", [x], [torch.bfloat16])
    if x.numel() == 0 or x.numel() % 8:
        raise ValueError(f"absmax_quantize: need a multiple of 8 values, got {x.numel()}")
    sc = absmax_schedule(x.numel(), sm_count(dev), _absmax_blocks_per_sm(dev.index or 0))
    parts = torch.empty(sc["grid"], dtype=torch.float32, device=dev)
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    s = torch.empty(1, dtype=torch.float32, device=dev)
    _call("absmax_quantize", "pnp_absmax_quantize", dev, x, x.numel(), parts, q, s, sc["grid"],
          sc["per"])
    return q, s


# ---- K10: the valid 3x3 tap conv -----------------------------------------------------------


def tapconv_plain(band, w, rows, cols, scale=None):
    """``out[r, c] = sum_{dy, dx < 3} band[dy + r, dx + c] @ w[dy, dx]``
    (float32, the taps in the TPU's order): bfloat16 with float32 sums, or
    int8 with exact int32 sums times the one-element ``scale``."""
    cin, cout = w.shape[2], w.shape[3]
    exact = band.dtype == torch.int8
    acc = torch.zeros((rows * cols, cout), dtype=torch.float64 if exact else torch.float32,
                      device=band.device)
    for dy in range(3):
        for dx in range(3):
            win = band[dy:dy + rows, dx:dx + cols].reshape(rows * cols, cin)
            acc = acc + (win.to(acc.dtype) @ w[dy, dx].to(acc.dtype))
    if exact:
        acc = acc.to(torch.int32).float() * scale
    return acc.reshape(rows, cols, cout)


def tapconv_schedule(rows, cols, cin, cout, sms):
    """K10's bf16 work (csrc/probe_tapconv.cu: tapconv_wg): items of ``4 nm``
    output rows x 32 columns x 64 output channels, the channel part
    fastest, dealt to ``grid`` persistent blocks (one a SM) in turn; ``nm``
    2, or 1 where the nm = 2 items would leave SMs idle. The input runs in
    ``chunks`` of 64 channels; ``smem`` is a block's shared memory (with
    each of the two consumer warpgroups' two output boxes of ``2 nm`` rows
    x 32 pixels x 32 float32 channels)."""
    ntx, ncp = _ceil_div(cols, TAPCONV_COLS), _ceil_div(cout, TAPCONV_COUT)

    def count(nm):
        return ntx * _ceil_div(rows, 4 * nm) * ncp

    nm = 2 if count(2) >= sms else 1
    th = 4 * nm
    items = count(nm)
    patch = _ceil_div((th + 2) * (TAPCONV_COLS + 2) * 128, 1024) * 1024  # a chunk's buffer
    return dict(nm=nm, tile_rows=th, ntx=ntx, nty=_ceil_div(rows, th), ncp=ncp,
                chunks=_ceil_div(cin, 64), items=items, grid=min(sms, items),
                smem=1024 + TAPCONV_STAGES * 64 * 128 + 2 * patch
                + 4 * 2 * nm * TAPCONV_COLS * 128 + 8 * TAPCONV_BARRIERS)


def tapconv_items(rows, cols, cin, cout, sms):
    """K10's bf16 items as the kernel decodes them, per block: ``(first row,
    first column, first output channel)`` of each, in the order the block
    takes them."""
    return _tap_items(tapconv_schedule(rows, cols, cin, cout, sms))


def _tap_items(sc):
    """The items of a K10 schedule ``sc`` (either form's) as its kernel
    decodes them: item it (the channel part fastest) to block it % grid."""
    blocks = [[] for _ in range(sc["grid"])]
    for it in range(sc["items"]):
        tt, cp = divmod(it, sc["ncp"])
        ty, tx = divmod(tt, sc["ntx"])
        blocks[it % sc["grid"]].append((ty * sc["tile_rows"], tx * TAPCONV_COLS,
                                        cp * TAPCONV_COUT))
    return blocks


def tapconv8_smem(nm, chunks):
    """A block of K10's int8 wgmma design: alignment slack, the resident
    weights (9 taps x ``chunks`` tiles of 64 x 64 int8), two patch buffers of
    ``(4 nm + 2) x 34`` 64-byte pixels, the two consumer warpgroups' two
    output boxes each (as :func:`tapconv_schedule`'s) and four barriers."""
    patch = _ceil_div((4 * nm + 2) * (TAPCONV_COLS + 2) * TAPCONV8_PIX, 1024) * 1024
    return (1024 + 9 * chunks * 64 * TAPCONV8_PIX + 2 * patch
            + 4 * 2 * nm * TAPCONV_COLS * 128 + 8 * 4)


def tapconv8_schedule(rows, cols, cin, cout, sms):
    """K10's int8 work (csrc/probe_tapconv.cu: tapconv8_wg): items as
    :func:`tapconv_schedule`'s (``4 nm`` rows x 32 columns x 64 output
    channels, the part fastest), the input in ``chunks`` of 64 channels;
    ``nm`` 2, or 1 where the nm = 2 items would leave SMs idle or their
    block would pass ``SMEM_MAX``; ``grid`` persistent blocks, a multiple
    of the ``ncp`` output parts, so that all a block's items share one part
    and its weights stay resident. ``nm`` 0 where even nm = 1 does not fit
    (cin above 256): the mma.sync design (``tapconv_kernel``), no grid."""
    ntx, ncp, nch = _ceil_div(cols, TAPCONV_COLS), _ceil_div(cout, TAPCONV_COUT), _ceil_div(cin, 64)

    def count(nm):
        return ntx * _ceil_div(rows, 4 * nm) * ncp

    fits = [nm for nm in (1, 2) if tapconv8_smem(nm, nch) <= SMEM_MAX]
    if not fits:
        return dict(nm=0, grid=0, ntx=ntx, ncp=ncp, chunks=nch, items=0, smem=0)
    nm = 2 if 2 in fits and count(2) >= sms else 1
    items = count(nm)
    return dict(nm=nm, tile_rows=4 * nm, ntx=ntx, nty=_ceil_div(rows, 4 * nm), ncp=ncp,
                chunks=nch, items=items, grid=min(items, max(1, sms // ncp) * ncp),
                smem=tapconv8_smem(nm, nch))


def tapconv8_items(rows, cols, cin, cout, sms):
    """K10's int8 items as the kernel decodes them, per block, as
    :func:`tapconv_items`: ``(first row, first column, first output
    channel)`` in the order the block takes them."""
    return _tap_items(tapconv8_schedule(rows, cols, cin, cout, sms))


def tapconv(band, w, rows, cols, scale=None):
    """K10. ``band (bh, bw, cin)`` with bh >= rows + 2, bw >= cols + 2, ``w
    (3, 3, cin, cout)``: both bfloat16 (no scale), or both int8 with a
    float32 ``scale`` of one element in device memory. Returns ``(rows,
    cols, cout)`` float32. On the card cin % 16 (bf16) or % 32 (int8),
    cout % 8 == 0."""
    bh, bw, cin = band.shape
    if w.shape[:3] != (3, 3, cin) or bh < rows + 2 or bw < cols + 2 or rows < 1 or cols < 1:
        raise ValueError(f"tapconv: need band (>= rows + 2, >= cols + 2, cin) and w (3, 3, cin, "
                         f"cout) for {rows} x {cols}; got {tuple(band.shape)}, {tuple(w.shape)}")
    if (band.dtype == torch.int8) != (scale is not None):
        raise ValueError("tapconv: int8 inputs take a scale, bfloat16 inputs none")
    if on_cpu(band):
        return tapconv_plain(band, w, rows, cols, scale)
    if band.dtype not in _TYPE_CODE:
        raise TypeError(f"tapconv: need bfloat16 or int8, got {band.dtype}")
    dev = _cuda_args("tapconv", [band, w] + ([scale] if scale is not None else []),
                     [band.dtype, band.dtype, torch.float32])
    cout = w.shape[3]
    step = 16 if band.dtype == torch.bfloat16 else 32
    if cin % step or cout % 8 or (scale is not None and scale.numel() != 1):
        raise ValueError(f"tapconv: need cin % {step} == 0, cout % 8 == 0 and one scale; got "
                         f"cin {cin}, cout {cout}")
    out = torch.empty((rows, cols, cout), dtype=torch.float32, device=dev)
    sched = tapconv_schedule if scale is None else tapconv8_schedule
    sc = sched(rows, cols, cin, cout, sm_count(dev))
    _call("tapconv" if scale is None else "tapconv_int8", "pnp_tapconv", dev,
          _TYPE_CODE[band.dtype], band, w, scale, out, bh, bw, cin, cout, rows, cols, sc["nm"],
          sc["grid"])
    return out


# ---- K11: the two-tap gather warp -----------------------------------------------------------


def _fma(a, w, acc):
    """float32 ``fma(a, w, acc)`` for bf16 ``a``, rounded once, as the card's
    ``__fmaf_rn``: the product is exact in float64 (8 x 24 bits), a two-sum
    gives the float64 sum's rounding error, and the sum rounded to odd in
    float64 (53 bits, 2 more than float32 needs) rounds to float32 as the
    exact sum would."""
    p, q = a.double() * w.double(), acc.double()
    s = p + q
    t = s - p
    e = (p - (s - t)) + (q - t)  # s + e == p + q exactly
    bits = s.view(torch.int64)
    # to odd: truncate toward zero (one ulp down where e points to zero),
    # then set the last bit where s was inexact
    bits = torch.where((e != 0) & ((e < 0) != (s < 0)), bits - 1, bits)
    bits = torch.where(e != 0, bits | 1, bits)
    return bits.view(torch.float64).float()


def gather2_plain(xp, shidx, wx0, wx1, dyidx, wy0, wy1, x0=15):
    """The two-pass gather warp (tools/warp_kernel_probe.py: _select_kernel,
    :88) as its two live terms a pass. ``xp (1, hp, wp, c)`` bf16, ``shidx``,
    ``dyidx (nb, w)`` int32, the weights ``(nb, w)`` float32 -> ``(1, 8 nb,
    w, c)`` bf16: ``h[j, x] = bf16(fma(xp[8 ri + j, col + 1], a1, fma(xp[8 ri
    + j, col], a0, 0)))`` with ``col = x + shidx + x0``, then ``out[8 ri + r,
    x] = bf16(fma(h[r + d + 1], b1, fma(h[r + d], b0, 0)))`` with ``d =
    dyidx``; a weight is zero where its shift lies outside the TPU kernel's
    35 (csrc/probe_gather.cu). Each term is a fused multiply-add in the TPU
    kernel's shift order, as XLA compiles its ``acc + sl * w``."""
    nb, w = shidx.shape
    src = xp[0]
    hp, wp, _ = src.shape
    dev = xp.device
    k, d = shidx.long(), dyidx.long()
    zero = torch.zeros((), device=dev)
    a0 = torch.where((k >= 0) & (k < GATHER_SHIFTS), wx0, zero)[:, None, :, None]
    a1 = torch.where((k >= -1) & (k < GATHER_SHIFTS - 1), wx1, zero)[:, None, :, None]
    b0 = torch.where((d >= 0) & (d < GATHER_SHIFTS), wy0, zero)[:, None, :, None]
    b1 = torch.where((d >= -1) & (d < GATHER_SHIFTS - 1), wy1, zero)[:, None, :, None]
    col = (torch.arange(w, device=dev) + k + x0)[:, None, :]  # (nb, 1, w): the a0 tap
    band_row = d[:, None, :] + torch.arange(BAND_ROWS + 1, device=dev)[None, :, None]
    live = ((band_row >= 0) & (band_row < GATHER_BAND))[..., None]  # rows a live V term reads
    row = (torch.arange(nb, device=dev)[:, None, None] * BAND_ROWS + band_row).clamp(0, hp - 1)
    p = src[row, col.clamp(0, wp - 1).expand_as(row)]  # (nb, 9, w, c)
    q = src[row, (col + 1).clamp(0, wp - 1).expand_as(row)]
    h = _fma(q, a1, _fma(p, a0, zero)).to(torch.bfloat16)
    h = torch.where(live, h, torch.zeros((), dtype=h.dtype, device=dev))
    out = _fma(h[:, 1:], b1, _fma(h[:, :-1], b0, zero)).to(torch.bfloat16)  # (nb, 8, w, c)
    return out.reshape(1, nb * BAND_ROWS, w, xp.shape[3])


GATHER_THREADS = 256  # K11's block: one thread a (band, column, 8 channels), band-major


def gather2_items(nb, w, c):
    """K11's work as its kernel decodes it (csrc/probe_gather.cu:
    gather2_kernel): per block, the ``(band, column, 8-channel vector)`` of
    each of its threads, the vector fastest, then the column, then the band."""
    nv = c // 8
    n = nb * w * nv
    return [[(i // nv // w, i // nv % w, i % nv)
             for i in range(b * GATHER_THREADS, min(n, (b + 1) * GATHER_THREADS))]
            for b in range(_ceil_div(n, GATHER_THREADS))]


def gather2(xp, shidx, wx0, wx1, dyidx, wy0, wy1, x0=15):
    """K11. See :func:`gather2_plain`. ``xp (1, hp, wp, c)`` bf16 with
    hp >= 8 nb + 34, wp >= w + x0 + 34 and x0 >= 1 (every tap a live weight
    reads lies inside xp), c % 8 == 0 on the card."""
    nb, w = shidx.shape
    _, hp, wp, c = xp.shape
    tables = (shidx, wx0, wx1, dyidx, wy0, wy1)
    if xp.shape[0] != 1 or any(t.shape != (nb, w) for t in tables):
        raise ValueError(f"gather2: need xp (1, hp, wp, c) and six (nb, w) tables; got "
                         f"{tuple(xp.shape)}, {[tuple(t.shape) for t in tables]}")
    if x0 < 1 or wp < w + x0 + GATHER_SHIFTS - 1 or hp < BAND_ROWS * (nb - 1) + GATHER_BAND:
        raise ValueError(f"gather2: xp {tuple(xp.shape)} does not hold the taps of {nb} bands "
                         f"of width {w} from column {x0} (need hp >= {8 * nb + 34}, wp >= "
                         f"{w + x0 + 34}, x0 >= 1)")
    if on_cpu(xp):
        return gather2_plain(xp, shidx, wx0, wx1, dyidx, wy0, wy1, x0)
    i32, f32 = torch.int32, torch.float32
    dev = _cuda_args("gather2", [xp, *tables], [torch.bfloat16, i32, f32, f32, i32, f32, f32])
    if c % 8:
        raise ValueError(f"gather2: channels must be a multiple of 8, got {c}")
    out = torch.empty((1, nb * BAND_ROWS, w, c), dtype=torch.bfloat16, device=dev)
    _call("gather2", "pnp_gather2", dev, xp, *tables, out, nb, hp, wp, w, c, x0)
    return out


# ---- K12: per-block window averages, block-major -------------------------------------------


def block_windows_plain(xp, sy, sx, h, w):
    """Per 8x8 block j of an ``(h, w)`` output (row-major over the blocks):
    ``0.5 * (xp[ya + r, xa + cc] + xp[ya + 1 + r, xb + cc])`` in float32,
    rounded to bf16, with ``ya = clamp(sy[j], 0, hp - 9)``, ``xa =
    clamp(sx[j], 0, wp - 8)``, ``xb = clamp(sx[j] + 8, 0, wp - 8)`` (the
    windows of tools/warp_kernel_probe.py: _dma_kernel, :145, as clamped
    dynamic slices), stored block-major as there: block j's 64 pixels
    row-major at flat pixel 64 j of the ``(1, h, w, c)`` output."""
    src = xp[0]
    hp, wp, c = src.shape
    i = torch.arange(BAND_ROWS, device=xp.device)
    ya = sy.long().clamp(0, hp - BAND_ROWS - 1)[:, None, None] + i[None, :, None]  # (n, 8, 1)
    xa = sx.long().clamp(0, wp - BAND_ROWS)[:, None, None] + i[None, None, :]      # (n, 1, 8)
    xb = (sx.long() + BAND_ROWS).clamp(0, wp - BAND_ROWS)[:, None, None] + i[None, None, :]
    a, b = src[ya, xa].float(), src[ya + 1, xb].float()  # (n, 8, 8, c)
    return ((a + b) * 0.5).to(torch.bfloat16).reshape(1, h, w, c)


def block_windows(xp, sy, sx, h, w):
    """K12. See :func:`block_windows_plain`. ``xp (1, hp, wp, c)`` bf16 with
    hp >= 9, wp >= 16; ``sy``, ``sx`` ``(h/8 * w/8,)`` int32; h and w
    multiples of 8; c % 8 == 0 on the card."""
    _, hp, wp, c = xp.shape
    nblk = (h // BAND_ROWS) * (w // BAND_ROWS)
    if (xp.shape[0] != 1 or h % BAND_ROWS or w % BAND_ROWS or nblk < 1 or sy.shape != (nblk,)
            or sx.shape != (nblk,) or hp < BAND_ROWS + 1 or wp < 2 * BAND_ROWS):
        raise ValueError(f"block_windows: need xp (1, >= 9, >= 16, c), an (h, w) output of 8x8 "
                         f"blocks and ({nblk},) tables; got {tuple(xp.shape)}, ({h}, {w}), "
                         f"{tuple(sy.shape)}, {tuple(sx.shape)}")
    if on_cpu(xp):
        return block_windows_plain(xp, sy, sx, h, w)
    dev = _cuda_args("block_windows", [xp, sy, sx], [torch.bfloat16, torch.int32, torch.int32])
    if c % 8:
        raise ValueError(f"block_windows: channels must be a multiple of 8, got {c}")
    out = torch.empty((1, h, w, c), dtype=torch.bfloat16, device=dev)
    _call("block_windows", "pnp_block_windows", dev, xp, sy, sx, out, nblk, hp, wp, c)
    return out


# ---- K13: the chunked copies ---------------------------------------------------------------


def ring_copy_plain(z, write_out=True):
    """What tools/dma_probe.py's kernels write: ``z`` itself, or (no
    write_out) the last 8-row chunk's first row, pixels 0..7: ``(1, 8,
    lanes)``."""
    if write_out:
        return z.clone()
    return z[:, BAND_ROWS * (z.shape[1] // BAND_ROWS - 1), :BAND_ROWS].clone()


def _copy_args(name, z):
    _, hp, wp, lanes = z.shape
    if z.shape[0] != 1 or hp < BAND_ROWS or hp % BAND_ROWS or wp < BAND_ROWS:
        raise ValueError(f"{name}: need z (1, hp, wp, lanes) with hp a multiple of 8 and wp >= 8; "
                         f"got {tuple(z.shape)}")
    if on_cpu(z):
        return None
    dev = _cuda_args(name, [z], [torch.bfloat16])
    if lanes % 8:
        raise ValueError(f"{name}: lanes must be a multiple of 8, got {lanes}")
    return dev


def _copy_out(z, write_out):
    shape = z.shape if write_out else (1, BAND_ROWS, z.shape[3])
    return torch.empty(shape, dtype=z.dtype, device=z.device)


def ring_stage_bytes(depth):
    """K13's stage: at most ``RING_STAGE_MAX`` bytes, a multiple of 128,
    with ``depth + 1`` of them and the barriers within ``SMEM_MAX``."""
    return min(RING_STAGE_MAX, (SMEM_MAX - RING_BAR_BYTES) // (depth + 1) // 128 * 128)


def ring_schedule(shape, split, depth, sms):
    """K13 ``ring_copy``'s work (csrc/probe_ring.cu) on an array of
    ``shape (1, hp, wp, lanes)``: each row of each chunk's ``split`` column
    segments (of the row's ``nvec`` 16-byte pieces) cut into ``pieces``
    equal ranges of at most a stage, ``items`` in all, dealt to ``grid``
    blocks (one a SM) in turn; ``smem`` a block's shared memory."""
    _, hp, wp, lanes = shape
    nvec = wp * lanes // 8
    stage = ring_stage_bytes(depth)
    pieces = _ceil_div(_ceil_div(nvec, split), stage // 16)
    items = hp // BAND_ROWS * split * BAND_ROWS * pieces
    return dict(nvec=nvec, stage_bytes=stage, pieces=pieces, items=items, grid=min(sms, items),
                smem=RING_BAR_BYTES + (depth + 1) * stage)


def ring_items(shape, split, depth, sms):
    """K13's items as the kernel decodes them, per block: ``(chunk,
    segment, row, first byte, end byte)``, the bytes within the row, in the
    order the block copies them."""
    sc = ring_schedule(shape, split, depth, sms)
    nvec, pieces = sc["nvec"], sc["pieces"]
    per_seg = BAND_ROWS * pieces
    blocks = [[] for _ in range(sc["grid"])]
    for i in range(sc["items"]):
        chunk, rem = divmod(i, split * per_seg)
        s, rem = divmod(rem, per_seg)
        r, p = divmod(rem, pieces)
        seg_lo = nvec * s // split
        length = nvec * (s + 1) // split - seg_lo
        lo, hi = seg_lo + length * p // pieces, seg_lo + length * (p + 1) // pieces
        blocks[i % sc["grid"]].append((chunk, s, r, 16 * lo, 16 * hi))
    return blocks


def stream_grid(sms):
    """K13 ``stream_copy``'s blocks: ``STREAM_BLOCKS_PER_SM`` a SM."""
    return STREAM_BLOCKS_PER_SM * sms


def ring_copy(z, split=1, write_out=True, depth=3):
    """K13, tools/dma_probe.py: run. Copies ``z (1, hp, wp, lanes)`` bf16 in
    chunks of 8 rows through a per-block ring of ``depth + 1`` shared-memory
    stages fed by TMA bulk loads and drained by TMA bulk stores, each
    chunk's rows in ``split`` (1, 2 or 4) column segments, persistent
    blocks taking the items in chunk order (:func:`ring_schedule`); returns
    :func:`ring_copy_plain`'s output."""
    if split not in RING_SPLITS or not 0 <= depth <= RING_MAX_DEPTH:
        raise ValueError(f"ring_copy: need split in {RING_SPLITS} and depth in 0..{RING_MAX_DEPTH}, "
                         f"got {split}, {depth}")
    dev = _copy_args("ring_copy", z)
    if dev is None:
        return ring_copy_plain(z, write_out)
    _, hp, wp, lanes = z.shape
    sc = ring_schedule(z.shape, split, depth, sm_count(dev))
    if sc["smem"] > SMEM_MAX:
        raise ValueError(f"ring_copy: {depth + 1} stages need {sc['smem']} bytes of shared memory "
                         f"a block, above {SMEM_MAX}")
    out = _copy_out(z, write_out)
    _call("ring_copy", "pnp_ring_copy", dev, z, out, hp, wp, lanes, split, depth, int(write_out),
          sc["grid"], sc["pieces"])
    return out


def stream_copy(z, write_out=True):
    """K13, tools/dma_probe.py: run_pipelined. The same copy as
    :func:`ring_copy` as a plain streamed copy: :func:`stream_grid` blocks
    walking the array in 16-byte pieces, streaming loads before stores."""
    dev = _copy_args("stream_copy", z)
    if dev is None:
        return ring_copy_plain(z, write_out)
    _, hp, wp, lanes = z.shape
    out = _copy_out(z, write_out)
    _call("stream_copy", "pnp_stream_copy", dev, z, out, hp, wp, lanes, int(write_out),
          stream_grid(sm_count(dev)))
    return out


# ---- what the probe tools share ------------------------------------------------------------


def timed(f, n):
    """``(mean milliseconds a call over n calls after one warm-up, the last
    output)``: CUDA events where the output lies on the card, the host clock
    elsewhere."""
    out = f()
    if (out[0] if isinstance(out, tuple) else out).device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            out = f()
        return (time.perf_counter() - t0) / n * 1e3, out
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, out


def bf16_from_numpy(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(torch.bfloat16)
