"""K3 and K3s's wgmma design at 64 channels (csrc/drt_block.cu: drt_block_wg):
what the CPU can check of it, and on the card the kernels against their
plain versions.

On the CPU: the weight image the wrapper packs for the kernel's bulk copies
and wgmma descriptors (``drt_stack.wg_image``) read back through an index
map of its own against ``tc_weights``' operands, bitwise, in both feature
types and at b = 1 and 4; the kernel's two GEMMs emulated tile by tile on
those read-back operands (its 14 x 30 output tiles, 16 x 32 stage-1
regions, zero padding and partition gates) against ``drt_block_plain``
within 1e-5; the persistent tile walk covering every output pixel exactly
once (``drt_stack.wg_tile_walk``, the kernel's loop); the width dispatch
(``launch.kernel_design``); and the arguments the wrappers hand the C
entry: the images at 64 channels, ``tc_weights``' operands at any other
width.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_tc_k3.py``): K3 and K3s at 64 channels, b = 1 and 4,
a ragged size, float32 (TF32 off; max|diff| <= 1e-4 std) and bfloat16 (max
< 0.02 std, mean < 0.002 std), K3s with keyframe and non-keyframe samples
in one batch, one counted launch each.
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
TH, TW = kd.WG_TILE


def _block_args(rng, b, c=C):
    s = 0.03 * 8 / c ** 0.5

    def f(*shape, k=s):
        return torch.from_numpy((rng.standard_normal(shape) * k).astype(np.float32))

    return (f(b, 3, 3, c, c), f(b, c, k=0.1), torch.from_numpy(rng.random((b, c)).astype(
        np.float32)), f(c, 3, c), f(3, 3, c, c), f(c, k=0.1))


def _read_image(img, nw):
    """The operand a stage image holds, read as the kernel's wgmma does: row
    n of a 64 x 128-byte tile is output channel n, and its input channel k
    of k-block kb sits in 16-byte chunk (k // vec) ^ (n % 8) at element k %
    vec of it. ``img (..., KB, NW, 64, per_row)`` -> ``(NW, ..., 64, 64)``."""
    a = img.contiguous().numpy() if img.dtype != BF16 else img.float().numpy()
    *lead, kb, nw_, n, per_row = a.shape
    assert nw_ == nw and n == C and kb * per_row == C
    vec = 16 // img.element_size()
    out = np.zeros((nw, *lead, n, kb * per_row), a.dtype)
    for row in range(n):
        for k in range(per_row):
            j = (k // vec) ^ (row % 8)
            src = a[..., row, j * vec + k % vec]  # (..., KB, NW)
            for b_ in range(kb):
                out[:, ..., row, b_ * per_row + k] = np.moveaxis(src[..., b_, :], -1, 0)
    return out


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_wg_image_reads_back_tc_weights(dtype, b):
    """Every tap of W2, PK and W1, read back from the image through the
    kernel's K-major 128-byte-swizzled addressing, is ``tc_weights``'
    operand, bitwise: bfloat16 one term (one k-block a tap), float32 the
    TF32 head and tail (two 32-channel k-blocks a tap)."""
    rng = np.random.default_rng(b)
    x = torch.zeros((b, 4, 4, C), dtype=dtype)
    par = torch.zeros((b, 4, 4, 3), dtype=dtype)
    w2, _, _, pk, w1, _ = kd.drt_block_args(x, par, *_block_args(rng, b))
    nw = 2 if dtype == F32 else 1
    kb = 2 if dtype == F32 else 1
    for ops, lead in ((w2, (b, 9)), (pk, (3,)), (w1, (9,))):
        img = kd.wg_image(ops)
        assert img.dtype == dtype and img.is_contiguous()
        assert img.shape == (*lead, kb, nw, C, 128 // img.element_size())
        back = _read_image(img, nw)
        want = ops.float().numpy() if dtype == BF16 else ops.numpy()
        assert back.shape == want.shape
        assert np.array_equal(back.view(np.int32), want.view(np.int32))


def _operand(img, nw):
    """The value the kernel multiplies by: the read-back terms summed, in
    float64 (head + tail for float32)."""
    return _read_image(img, nw).astype(np.float64).sum(0)


def _emulate(x, par, w2i, b2, g, pki, w1i, b1, nw):
    """K3's GEMMs tile by tile as drt_block_wg computes them, in float64 on
    the read-back operands; also counts the writes of each output pixel."""
    xs, ps = x.double().numpy(), par.double().numpy()
    w2, pk, w1 = _operand(w2i, nw), _operand(pki, nw), _operand(w1i, nw)  # (.., n, k)
    b2, g, b1 = b2.double().numpy(), g.double().numpy(), b1.double().numpy()
    b, h, w, _ = xs.shape
    out = np.zeros_like(xs)
    writes = np.zeros((b, h, w), np.int64)
    rh, rw = kd.WG_REGION
    grid, blocks = kd.wg_tile_walk(b, h, w, 132)
    for tiles in blocks:
        for s, y0, x0 in tiles:
            xp = np.zeros((rh + 2, rw + 2, C))  # the staged x tile, zero outside the image
            pp = np.zeros((rh, rw, 3))          # the region's gates
            for i in range(rh + 2):
                for j in range(rw + 2):
                    y, xx = y0 - 2 + i, x0 - 2 + j
                    if 0 <= y < h and 0 <= xx < w:
                        xp[i, j] = xs[s, y, xx]
                        if 1 <= i <= rh and 1 <= j <= rw:
                            pp[i - 1, j - 1] = ps[s, y, xx]
            acc = np.zeros((rh, rw, C))
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                acc += xp[dy:dy + rh, dx:dx + rw] @ w2[s, tap].T
            acc = (acc + b2[s]) * g[s]
            centre = xp[1:rh + 1, 1:rw + 1]
            for r in range(3):
                acc += (centre * pp[..., r:r + 1]) @ pk[r].T
            ys = y0 - 1 + np.arange(rh)[:, None]
            xss = x0 - 1 + np.arange(rw)[None, :]
            inside = (ys >= 0) & (ys < h) & (xss >= 0) & (xss < w)
            hreg = np.where(inside[..., None], np.maximum(acc, 0.0), 0.0)
            o = np.zeros((TH, TW, C))
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                o += hreg[dy:dy + TH, dx:dx + TW] @ w1[tap].T
            for i in range(TH):
                for j in range(TW):
                    y, xx = y0 + i, x0 + j
                    if y < h and xx < w:
                        out[s, y, xx] = xs[s, y, xx] + o[i, j] + b1
                        writes[s, y, xx] += 1
    return out, writes


@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (2, 16, 31)])
def test_wg_gemms_compute_the_block(b, h, w):
    """The kernel's two GEMMs on the operands read back from its images,
    tile by tile over its walk (stage 1 on 16 x 32 regions of a zero-padded
    18 x 34 x tile, g * (conv + b2), the gated partition taps, h zero
    outside the image; stage 2 on 14 x 30 outputs), give ``drt_block_plain``
    within 1e-5, each output pixel written once."""
    rng = np.random.default_rng(10 * b + h)
    x = torch.from_numpy(rng.standard_normal((b, h, w, C)).astype(np.float32))
    par = torch.from_numpy((rng.random((b, h, w, 3)) > 0.5).astype(np.float32))
    args = _block_args(rng, b)
    w2, b2, g, pk, w1, b1 = kd.drt_block_args(x, par, *args)
    got, writes = _emulate(x, par, kd.wg_image(w2), b2, g, kd.wg_image(pk), kd.wg_image(w1), b1,
                           nw=2)
    assert (writes == 1).all()
    want = kd.drt_block_plain(x, par, *args)
    np.testing.assert_allclose(got, want.double().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,h,w", [(1, 720, 1280), (4, 256, 448), (1, 36, 52)])
def test_wg_tile_walk_covers_every_pixel_once(b, h, w):
    """On an H100's 132 SMs the persistent blocks take tiles k, k + grid,
    ...: every output pixel of every sample lies in exactly one visited
    tile, and no tile is visited twice."""
    grid, blocks = kd.wg_tile_walk(b, h, w, 132)
    n_tiles = b * -(-h // TH) * -(-w // TW)
    assert grid == min(n_tiles, 132) and len(blocks) == grid
    cover = np.zeros((b, h, w), np.int64)
    seen = set()
    for tiles in blocks:
        for s, y0, x0 in tiles:
            assert (s, y0, x0) not in seen
            seen.add((s, y0, x0))
            cover[s, y0:y0 + TH, x0:x0 + TW] += 1
    assert len(seen) == n_tiles and (cover == 1).all()
    # the blocks' loads differ by at most one tile
    sizes = [len(t) for t in blocks]
    assert max(sizes) - min(sizes) <= 1


def test_width_dispatch():
    """64 channels take the wgmma design (one launch) in both types; every
    other width the mma.sync design, one launch up to the one-launch width
    (168 float32, 384 bfloat16) and two above; K3s only at 64."""
    want = {8: (("mma.sync", 1), ("mma.sync", 1)), 24: (("mma.sync", 1), ("mma.sync", 1)),
            64: (("wgmma", 1), ("wgmma", 1)), 128: (("mma.sync", 1), ("mma.sync", 1)),
            216: (("mma.sync", 2), ("mma.sync", 1)), 392: (("mma.sync", 2), ("mma.sync", 2))}
    for c, (f32, bf16) in want.items():
        assert kl.kernel_design("drt_block", c, F32) == f32, c
        assert kl.kernel_design("drt_block", c, BF16) == bf16, c
    assert kl.kernel_design("drt_block_select", 64, BF16) == ("wgmma", 1)
    with pytest.raises(ValueError, match="K3s takes 64 channels only"):
        kl.kernel_design("drt_block_select", 128, F32)


@pytest.mark.parametrize("c,select", [(64, False), (64, True), (128, False)])
def test_wrapper_hands_the_entry_its_designs_weights(monkeypatch, c, select):
    """What the op's CUDA implementation passes the C entry, captured on CPU
    tensors: at 64 channels the images of ``wg_image`` (K3 and K3s), at any
    other width ``tc_weights``' operands; no scratch for the one-launch
    forms."""
    rng = np.random.default_rng(c)
    b, h, w = 2, 6, 10
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    par = torch.ones((b, h, w, 3))
    args = _block_args(rng, b, c)
    seen = {}

    def fake_launch(name, entry, out, *rest):
        seen.update(name=name, entry=entry, rest=rest)
        return out

    monkeypatch.setattr(kd, "launch", fake_launch)
    if select:
        kd._drt_block_select_kernel(x, par, *args, torch.zeros_like(x), torch.tensor([1.0, 0.0]))
    else:
        kd._drt_block_kernel(x, par, *args)
    ops = kd.drt_block_args(x, par, *args)
    passed = seen["rest"][2:8]  # after x and par: w2, b2, g, pk, w1, b1
    want = [kd.wg_image(ops[0]), ops[1], ops[2], kd.wg_image(ops[3]), kd.wg_image(ops[4]),
            ops[5]] if c == 64 else list(ops)
    assert seen["entry"] == ("pnp_drt_block_select" if select else "pnp_drt_block")
    for got, exp in zip(passed, want):
        assert got.shape == exp.shape and torch.equal(got, exp)
    if not select:
        assert seen["rest"][8] is None  # one launch: no scratch for h


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


def _check(got, ref, dtype):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    sd = float(ref.std())
    diff = (got - ref).abs()
    if dtype == F32:
        assert float(diff.max()) <= 1e-4 * sd, (float(diff.max()), sd)
    else:
        assert float(diff.max()) < 0.02 * sd, (float(diff.max()), sd)
        assert float(diff.mean()) < 0.002 * sd, (float(diff.mean()), sd)


def _case(dev, dtype, b, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, C), generator=gen).to(dev, dtype)
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    s = 0.03
    blk = ((torch.randn((b, 3, 3, C, C), generator=gen) * s).to(dev),
           (torch.randn((b, C), generator=gen) * 0.1).to(dev),
           torch.rand((b, C), generator=gen).to(dev),
           (torch.randn((C, 3, C), generator=gen) * s).to(dev),
           (torch.randn((3, 3, C, C), generator=gen) * s).to(dev),
           (torch.randn((C,), generator=gen) * 0.1).to(dev))
    return x, par, blk


CARD_SIZES = [(1, 720, 1280), (4, 256, 448), (1, 36, 52), (3, 20, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", CARD_SIZES)
def test_wg_drt_block_kernel(cuda, dtype, b, h, w):
    x, par, blk = _case(cuda, dtype, b, h, w, seed=h + w)
    reset_launches()
    got = KERNELS.drt_block(x, par, *blk)
    assert LAUNCHES["drt_block"] == 1 and sum(LAUNCHES.values()) == 1
    _check(got, PLAIN.drt_block(x.float(), par.float(), *blk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", CARD_SIZES[1:])
def test_wg_drt_block_select_kernel(cuda, dtype, b, h, w):
    """K3s with keyframe and non-keyframe samples in one batch: out as K3's
    plain version, new_last_key bitwise the select of its own out."""
    x, par, blk = _case(cuda, dtype, b, h, w, seed=h * w)
    last_key = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)).to(cuda, dtype)
    is_key = (torch.arange(b, device=cuda) % 2 == 0).float()
    if b > 1:
        assert 0 < float(is_key.sum()) < b
    reset_launches()
    out, new_lk = KERNELS.drt_block_select(x, par, *blk, last_key, is_key)
    assert LAUNCHES["drt_block_select"] == 1 and sum(LAUNCHES.values()) == 1
    _check(out, PLAIN.drt_block(x.float(), par.float(), *blk), dtype)
    assert torch.equal(new_lk, torch.where(is_key.reshape(-1, 1, 1, 1) > 0.5, out, last_key))
