"""K2's and K4's wgmma designs at 64 channels (csrc/input_conv.cu:
input_conv_wg, csrc/head.cu: head_wg): what the CPU can check of them, and
on the card the kernels against their plain versions.

On the CPU: the weight images the wrapper packs for the kernels' bulk copies
and wgmma descriptors (``drt_stack.wg_image``: K2's per-sample parts with the
lr part's 32-byte k-block, K4's two-term W_hr; ``drt_stack.head_last_image``,
K4's c -> 3 stage as a GEMM operand) read back through index maps of their
own against ``tc_weights``' operands, bitwise, in both feature types and at
b = 1 and 4; each design's GEMMs emulated tile by tile over its walk (K2's
16 x 32 / 8 x 32 output tiles with float32's per-stage split sum, K4's 14 x
30 outputs of 16 x 32 stage-1 regions and its stage-2 GEMM on the permuted
channels) against ``input_conv_plain`` and ``head_plain`` within 1e-5, each
output pixel written once, and once each against JAX's XLA compositions
(``_xla_input_stack_compose``, ``_xla_head``); the walks' coverage; the width
dispatch (``launch.kernel_design``); and what the wrappers hand the C entries.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_tc_k2k4.py``): K2 (3 and 4 parts) and K4 at 64
channels, b = 1 and 4, a ragged size, float32 (TF32 off; max|diff| <= 1e-4
std) and bfloat16 (K2 max < 0.04 std, K4 < 0.02, mean < 0.002 std), one
counted launch each.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import launch as kl

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
C = 64
HEAD_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)  # the channels of a k-step as head_wg's A takes them


def _f(rng, *shape, k=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * k).astype(np.float32))


def _k2_args(rng, b, h, w, n_parts, gate):
    parts = [_f(rng, b, h, w, 3)] + [_f(rng, b, h, w, C) for _ in range(n_parts - 1)]
    kernel = _f(rng, 3, 3, 3 + C * (n_parts - 1), C, k=0.03)
    bias = _f(rng, C, k=0.1)
    g = torch.full((b,), float(gate))
    return parts, kernel, bias, kd.part_kernels(kernel, [p.shape[-1] for p in parts], b, g)


def _head_args(rng):
    return (_f(rng, 3, 3, C, C, k=0.03), _f(rng, C, k=0.1), _f(rng, 3, 3, C, 3, k=0.06),
            _f(rng, 3, k=0.1))


def _read(img, row_bytes):
    """The operand an image holds, read as the kernel's wgmma does through
    an index map of its own: row n of a tile is output n, and its input
    channel k of k-block kb sits in 16-byte chunk (k // vec) ^ s(n) at
    element k % vec, s(n) = n % 8 for 128-byte rows, (n // 4) % 2 for
    32-byte rows. ``img (..., KB, NW, n, per_row)`` -> ``(NW, ..., n, KB *
    per_row)``."""
    a = img.float().numpy() if img.dtype == BF16 else img.contiguous().numpy()
    *lead, kb, nw, n, per_row = a.shape
    vec = 16 // img.element_size()
    assert per_row * img.element_size() == row_bytes
    out = np.zeros((nw, *lead, n, kb * per_row), a.dtype)
    for row in range(n):
        s = row % 8 if row_bytes == 128 else (row // 4) % 2
        for k in range(per_row):
            j = (k // vec) ^ s
            src = a[..., row, j * vec + k % vec]  # (..., KB, NW)
            for b_ in range(kb):
                out[:, ..., row, b_ * per_row + k] = np.moveaxis(src[..., b_, :], -1, 0)
    return out


def _same_bits(got, want):
    want = want.float().numpy() if want.dtype == BF16 else want.numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k2_images_read_back_tc_weights(dtype, b):
    """Each part's per-sample taps, read back from the image through the
    kernel's addressing, are ``tc_weights``' operands, bitwise: the lr part
    one 32-byte k-block a tap (16 bfloat16 / 8 float32 channels, 32-byte
    swizzled), each 64-channel part one (bfloat16) or two (float32) 128-byte
    k-blocks, float32 as the TF32 head and tail."""
    rng = np.random.default_rng(b)
    parts, _, bias, ks = _k2_args(rng, b, 4, 4, 4, 1)
    parts = [p.to(dtype) for p in parts]
    ops, _, c = kd.input_conv_args(parts, ks, bias)
    imgs = kd._input_conv_weights(ops, c, dtype)
    nw, kb = (2, 2) if dtype == F32 else (1, 1)
    assert imgs[0].shape == (b, 9, 1, nw, C, 32 // imgs[0].element_size())
    _same_bits(_read(imgs[0], 32), ops[0])
    for img, op in zip(imgs[1:], ops[1:]):
        assert img.dtype == dtype and img.is_contiguous()
        assert img.shape == (b, 9, kb, nw, C, 128 // img.element_size())
        _same_bits(_read(img, 128), op)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k4_images_read_back(dtype):
    """W_hr's image holds ``tc_weights``' two terms (the TF32 head and tail,
    or bf16_split's hi and lo) bitwise, a (tap, k-block) a ring stage; W''s
    image holds column 3 tap + o of W_last (zero past 27) at row n and, at
    k-slot 8 s + l, channel 8 s + HEAD_ORDER[l], as tf32_split's head and
    tail, bitwise."""
    rng = np.random.default_rng(4)
    x = torch.zeros((1, 4, 4, C), dtype=dtype)
    hr_k, hr_b, last_k, last_b = _head_args(rng)
    ops = kd.head_args(x, hr_k, hr_b, last_k, last_b)
    whr, bhr, wl, bl = kd._head_weights(ops, last_k, C, dtype)
    kb = 2 if dtype == F32 else 1
    assert whr.shape == (9, kb, 2, C, 128 // whr.element_size()) and whr.dtype == dtype
    _same_bits(_read(whr, 128), ops[0])
    assert wl.shape == (2, 2, 32, 32) and wl.dtype == F32
    back = _read(wl, 128)  # (2 terms, 32 columns, 64 k-slots)
    want = np.zeros((32, C), np.float32)
    lk = last_k.numpy()
    for tap in range(9):
        for o in range(3):
            for s in range(8):
                for l_ in range(8):
                    want[3 * tap + o, 8 * s + l_] = lk[tap // 3, tap % 3, 8 * s + HEAD_ORDER[l_], o]
    hi, lo = kd.tf32_split(torch.from_numpy(want))
    _same_bits(back, torch.stack([hi, lo]))
    assert torch.equal(bhr, ops[1]) and torch.equal(bl, ops[3])


def _operand(img, row_bytes):
    """The value the kernel multiplies by: the read-back terms summed in
    float64 (head + tail, or hi + lo)."""
    return _read(img, row_bytes).astype(np.float64).sum(0)


def _emulate_k2(parts, imgs, bias, dtype):
    """K2's GEMM tile by tile over input_conv_wg's walk on the read-back
    operands: chunks in concat order (the lr frame zero-padded to one
    k-step, then 64 (bfloat16) or 32 (float32) channels a chunk), a ring
    stage a tap and chunk; float32 sums each stage apart in float32 and adds
    it to a float32 running sum, bfloat16 keeps one sum. Also counts the
    writes of each output pixel."""
    th, tw = kd.IC_TILE[dtype]
    xs = [p.double().numpy() for p in parts]
    b, h, w, _ = xs[0].shape
    wlr = _operand(imgs[0], 32)                         # (b, 9, 64, kp)
    wide = [_operand(i, 128) for i in imgs[1:]]         # (b, 9, 64, 64) each
    kp = wlr.shape[-1]
    kc = 32 if dtype == F32 else 64
    bias = bias.double().numpy()
    out = np.zeros((b, h, w, C))
    writes = np.zeros((b, h, w), np.int64)
    _, blocks = kd.wg_tile_walk(b, h, w, 132, kd.IC_TILE[dtype])

    def staged(x, s, y0, x0, ch):
        t = np.zeros((th + 2, tw + 2, ch))
        for i in range(th + 2):
            for j in range(tw + 2):
                y, xx = y0 - 1 + i, x0 - 1 + j
                if 0 <= y < h and 0 <= xx < w:
                    t[i, j, :x.shape[-1]] = x[s, y, xx]
        return t

    for tiles in blocks:
        for s, y0, x0 in tiles:
            acc = np.zeros((th, tw, C), np.float32 if dtype == F32 else np.float64)
            chunks = [(staged(xs[0], s, y0, x0, kp), wlr[s])]
            for x, wk in zip(xs[1:], wide):
                xt = staged(x, s, y0, x0, C)
                chunks += [(xt[..., c0:c0 + kc], wk[s][..., c0:c0 + kc]) for c0 in range(0, C, kc)]
            for xt, wk in chunks:
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    part = xt[dy:dy + th, dx:dx + tw] @ wk[tap].T
                    acc += part.astype(acc.dtype)
            o = acc.astype(np.float64) + bias
            o = np.where(o >= 0, o, 0.1 * o)
            for i in range(th):
                for j in range(tw):
                    y, xx = y0 + i, x0 + j
                    if y < h and xx < w:
                        out[s, y, xx] = o[i, j]
                        writes[s, y, xx] += 1
    return out, writes


def _rounded_kernels(ks, dtype):
    """The per-part kernels as the bfloat16 operands round them (float32:
    unchanged), for the plain version the emulation is held to."""
    return ks if dtype == F32 else [k.to(BF16).float() for k in ks]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("n_parts,gate", [(3, 1), (4, 0)])
def test_k2_wg_gemm_computes_the_conv(n_parts, gate, dtype):
    """K2's GEMM on the operands read back from its images, tile by tile
    over its walk (float32: 8 x 32 tiles, 32-channel chunks, each stage
    summed apart; bfloat16: 16 x 32, 64-channel chunks), gives
    ``input_conv_plain`` on the same operands within 1e-5 at a size no tile
    divides, each output pixel written once."""
    rng = np.random.default_rng(10 * n_parts + gate)
    b, h, w = 2, 19, 40
    parts, _, bias, ks = _k2_args(rng, b, h, w, n_parts, gate)
    ops, bias_f, c = kd.input_conv_args([p.to(dtype) for p in parts], ks, bias)
    imgs = kd._input_conv_weights(ops, c, dtype)
    got, writes = _emulate_k2(parts, imgs, bias_f, dtype)
    assert (writes == 1).all()
    want = kd.input_conv_plain(parts, _rounded_kernels(ks, dtype), bias)
    np.testing.assert_allclose(got, want.double().numpy(), atol=1e-5, rtol=0)


def _emulate_k4(x, whr_img, bhr, wl_img, blast):
    """K4 tile by tile over head_wg's walk on the read-back operands: stage
    1 on 16 x 32 regions of a zero-padded 18 x 34 x tile, h = lrelu(sums +
    b_hr) zero outside the image; stage 2 as the GEMM Z = h W' with A's
    k-slots on the permuted channels; y = b_last + sum_tap Z[pixel +
    tap][3 tap + o] on the 14 x 30 outputs. Counts each output's writes."""
    xs = x.double().numpy()
    b, h, w, _ = xs.shape
    whr = _operand(whr_img, 128)      # (9, 64 out, 64 in)
    wp = _operand(wl_img, 128)        # (32 columns, 64 k-slots)
    perm = np.array([8 * s + l_ for s in range(8) for l_ in HEAD_ORDER])
    bhr, blast = bhr.double().numpy(), blast.double().numpy()
    th, tw = kd.WG_TILE
    rh, rw = kd.WG_REGION
    out = np.zeros((b, h, w, 3))
    writes = np.zeros((b, h, w), np.int64)
    _, blocks = kd.wg_tile_walk(b, h, w, 132)
    for tiles in blocks:
        for s, y0, x0 in tiles:
            xp = np.zeros((rh + 2, rw + 2, C))
            for i in range(rh + 2):
                for j in range(rw + 2):
                    y, xx = y0 - 2 + i, x0 - 2 + j
                    if 0 <= y < h and 0 <= xx < w:
                        xp[i, j] = xs[s, y, xx]
            acc = np.zeros((rh, rw, C))
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                acc += xp[dy:dy + rh, dx:dx + rw] @ whr[tap].T
            ys = y0 - 1 + np.arange(rh)[:, None]
            xss = x0 - 1 + np.arange(rw)[None, :]
            inside = (ys >= 0) & (ys < h) & (xss >= 0) & (xss < w)
            hreg = acc + bhr
            hreg = np.where(inside[..., None], np.where(hreg >= 0, hreg, 0.1 * hreg), 0.0)
            z = hreg[..., perm] @ wp.T  # (16, 32, 32)
            for i in range(th):
                for j in range(tw):
                    y, xx = y0 + i, x0 + j
                    if y >= h or xx >= w:
                        continue
                    v = blast.copy()
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        v += z[i + dy, j + dx, 3 * tap:3 * tap + 3]
                    out[s, y, xx] = v
                    writes[s, y, xx] += 1
    return out, writes


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (2, 16, 31)])
def test_k4_wg_gemms_compute_the_head(b, h, w, dtype):
    """K4's two GEMMs on the operands read back from its images, tile by
    tile over its walk, give ``head_plain`` on the same operands (W_hr as
    its two terms' sum) within 1e-5, each output pixel written once."""
    rng = np.random.default_rng(10 * b + h)
    x = _f(rng, b, h, w, C)
    hr_k, hr_b, last_k, last_b = _head_args(rng)
    ops = kd.head_args(x.to(dtype), hr_k, hr_b, last_k, last_b)
    whr, bhr, wl, bl = kd._head_weights(ops, last_k, C, dtype)
    got, writes = _emulate_k4(x, whr, bhr, wl, bl)
    assert (writes == 1).all()
    hr_sum = ops[0].float().sum(0).transpose(-1, -2).reshape(3, 3, C, C)  # (9, in, out) as HWIO
    want = kd.head_plain(x, hr_sum, hr_b, last_k, last_b)
    np.testing.assert_allclose(got, want.double().numpy(), atol=1e-5, rtol=0)


def test_k2_wg_gemm_matches_xla_compose():
    """The emulated K2 (float32, 4 parts, the align gate set for one sample
    and not the other) against JAX's ``_xla_input_stack_compose`` with no
    blocks, on the same numpy inputs, within 1e-5."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.kernels.drt_stack import _xla_input_stack_compose

    rng = np.random.default_rng(7)
    b, h, w = 2, 12, 36
    parts, kernel, bias, _ = _k2_args(rng, b, h, w, 4, 0)
    gate = torch.tensor([1.0, 0.0])
    ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
    ops, bias_f, c = kd.input_conv_args(parts, ks, bias)
    got, _ = _emulate_k2(parts, kd._input_conv_weights(ops, c, F32), bias_f, F32)
    want = _xla_input_stack_compose(tuple(jnp.asarray(p.numpy()) for p in parts),
                                    jnp.asarray(kernel.numpy()), jnp.asarray(bias.numpy()), None,
                                    (), align_gate=jnp.asarray(gate.numpy() > 0.5))
    np.testing.assert_allclose(got, np.asarray(want, np.float64), atol=1e-5, rtol=0)


def test_k4_wg_gemms_match_xla_head():
    """The emulated K4 (float32) against JAX's ``_xla_head`` on the same
    numpy inputs, within 1e-5."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.kernels.drt_stack import _xla_head

    rng = np.random.default_rng(8)
    x = _f(rng, 1, 18, 40, C)
    head = _head_args(rng)
    ops = kd.head_args(x, *head)
    got, _ = _emulate_k4(x, *kd._head_weights(ops, head[2], C, F32))
    want = _xla_head(jnp.asarray(x.numpy()), tuple(jnp.asarray(a.numpy()) for a in head))
    np.testing.assert_allclose(got, np.asarray(want, np.float64), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tile", [kd.IC_TILE[F32], kd.IC_TILE[BF16], kd.WG_TILE])
@pytest.mark.parametrize("b,h,w", [(1, 720, 1280), (4, 256, 448), (1, 36, 52)])
def test_tile_walks_cover_every_pixel_once(b, h, w, tile):
    """K2's walks (8 x 32 float32, 16 x 32 bfloat16) and K4's (14 x 30) on
    an H100's 132 SMs: every output pixel lies in exactly one visited tile,
    no tile is visited twice, and the blocks' loads differ by at most one
    tile."""
    th, tw = tile
    grid, blocks = kd.wg_tile_walk(b, h, w, 132, tile)
    n_tiles = b * -(-h // th) * -(-w // tw)
    assert grid == min(n_tiles, 132) and len(blocks) == grid
    cover = np.zeros((b, h, w), np.int64)
    seen = set()
    for tiles in blocks:
        for s, y0, x0 in tiles:
            assert (s, y0, x0) not in seen
            seen.add((s, y0, x0))
            cover[s, y0:y0 + th, x0:x0 + tw] += 1
    assert len(seen) == n_tiles and (cover == 1).all()
    sizes = [len(t) for t in blocks]
    assert max(sizes) - min(sizes) <= 1


def test_width_dispatch():
    """64 channels take the wgmma designs of K2 and K4 (one launch) in both
    types; 8, 24, 128 and 192 the mma.sync designs: K2 one launch at every
    width, K4 one up to 144 and two above; a kernel without a wgmma design
    is refused."""
    for name, wide in (("input_conv", 1), ("head", 2)):
        for dtype in (F32, BF16):
            for c in (8, 24, 128):
                assert kl.kernel_design(name, c, dtype) == ("mma.sync", 1), (name, c)
            assert kl.kernel_design(name, 64, dtype) == ("wgmma", 1)
            assert kl.kernel_design(name, 192, dtype) == ("mma.sync", wide)
    with pytest.raises(ValueError, match="no wgmma design|not a kernel"):
        kl.kernel_design("conv3x3", 64, F32)


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wrappers_hand_the_entries_their_designs_weights(monkeypatch, c, dtype):
    """What the ops' CUDA implementations pass the C entries, captured on
    CPU tensors: at 64 channels the images (K2: the lr part's 32-byte rows
    and each part's 128-byte rows; K4: W_hr's image and W''s), at any other
    width ``tc_weights``' operands; no scratch for the head's one-launch
    form."""
    rng = np.random.default_rng(c)
    b, h, w = 2, 6, 10
    seen = {}

    def fake_launch(name, entry, out, *rest):
        seen.update(name=name, entry=entry, rest=rest)
        return out

    monkeypatch.setattr(kd, "launch", fake_launch)
    parts = [_f(rng, b, h, w, 3).to(dtype)] + [_f(rng, b, h, w, c).to(dtype) for _ in range(2)]
    kernel = _f(rng, 3, 3, 3 + 2 * c, c, k=0.03)
    ks = kd.part_kernels(kernel, [3, c, c], b)
    bias = _f(rng, c, k=0.1)
    kd._input_conv_kernel(parts, ks, bias)
    ops, bias_f, _ = kd.input_conv_args(parts, ks, bias)
    want = ([kd.wg_image(ops[0], 32)] + [kd.wg_image(k) for k in ops[1:]]) if c == 64 else ops
    assert seen["entry"] == "pnp_input_conv"
    passed = seen["rest"][4:7]  # after lr, p0, p1 and one absent part: wlr, w0, w1
    for got, exp in zip(passed, want):
        assert got.shape == exp.shape and torch.equal(got, exp)
    x = _f(rng, b, h, w, c).to(dtype)
    hr_k, hr_b, last_k, last_b = (_f(rng, 3, 3, c, c, k=0.03), _f(rng, c), _f(rng, 3, 3, c, 3),
                                  _f(rng, 3))
    kd._head_kernel(x, hr_k, hr_b, last_k, last_b)
    ops = kd.head_args(x, hr_k, hr_b, last_k, last_b)
    want = ([kd.wg_image(ops[0]), ops[1], kd.head_last_image(last_k), ops[3]] if c == 64
            else list(ops))
    assert seen["entry"] == "pnp_head"
    for got, exp in zip(seen["rest"][1:5], want):
        assert got.shape == exp.shape and torch.equal(got, exp)
    assert seen["rest"][5] is None  # one launch: no scratch for the hidden map


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _check(got, ref, dtype, bf16_max):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    sd = float(ref.std())
    diff = (got - ref).abs()
    if dtype == F32:
        assert float(diff.max()) <= 1e-4 * sd, (float(diff.max()), sd)
    else:
        assert float(diff.max()) < bf16_max * sd, (float(diff.max()), sd)
        assert float(diff.mean()) < 0.002 * sd, (float(diff.mean()), sd)


CARD_SIZES = [(1, 720, 1280), (4, 256, 448), (1, 36, 52), (3, 20, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_parts", [3, 4])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", CARD_SIZES)
def test_wg_input_conv_kernel(cuda, dtype, n_parts, b, h, w):
    gen = torch.Generator().manual_seed(h + w + n_parts)
    parts = [torch.randn((b, h, w, 3), generator=gen).to(cuda, dtype)] + [
        torch.randn((b, h, w, C), generator=gen).to(cuda, dtype) for _ in range(n_parts - 1)]
    kernel = (torch.randn((3, 3, 3 + C * (n_parts - 1), C), generator=gen) * 0.03).to(cuda)
    bias = (torch.randn((C,), generator=gen) * 0.1).to(cuda)
    gate = (torch.arange(b, device=cuda) % 2).float()  # the align gate set and not
    ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
    reset_launches()
    got = KERNELS.input_conv(parts, ks, bias)
    assert LAUNCHES["input_conv"] == 1 and sum(LAUNCHES.values()) == 1
    _check(got, PLAIN.input_conv([p.float() for p in parts], ks, bias), dtype, 0.04)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", CARD_SIZES)
def test_wg_head_kernel(cuda, dtype, b, h, w):
    gen = torch.Generator().manual_seed(h * w)
    x = torch.randn((b, h, w, C), generator=gen).to(cuda, dtype)
    head = ((torch.randn((3, 3, C, C), generator=gen) * 0.03).to(cuda),
            (torch.randn((C,), generator=gen) * 0.1).to(cuda),
            (torch.randn((3, 3, C, 3), generator=gen) * 0.06).to(cuda),
            (torch.randn((3,), generator=gen) * 0.1).to(cuda))
    reset_launches()
    got = KERNELS.head(x, *head)
    assert LAUNCHES["head"] == 1 and sum(LAUNCHES.values()) == 1
    _check(got, PLAIN.head(x.float(), *head), dtype, 0.02)
