"""K5's wgmma design at 64 -> 64 (csrc/conv3x3.cu: conv3x3_wg) and K8's
bf16 wgmma design (csrc/probe_matmul.cu: matmul_wg): what the CPU can check
of them, and on the card the kernels against their plain versions.

On the CPU: K5's per-sample weight images (``drt_stack.wg_image`` of
``conv3x3_args``' taps) read back through an index map of their own against
``conv3x3_args``' operands, bitwise, at b = 1 and 2 in both feature types;
K5's GEMMs emulated tile by tile over its walk (16 x 32 bfloat16 or 12 x 32
float32 output tiles, 64- or 32-channel chunks, the bias-and-gain epilogue)
against ``conv3x3_plain`` within 1e-5, at sizes no tile divides, each output
pixel written once, and once against JAX's ``conv3x3_pallas`` in interpret
mode; the walk's coverage; the dispatch by widths (``launch.kernel_design``:
64 -> 64 to wgmma, every other pair to mma.sync) and what the wrapper hands
the C entry. K8's blocks and depth chunks (``probes.matmul_tiles``, both
designs) emulated against ``matmul_plain``: int8 bitwise, bf16 within 1e-5
of max|ref|, at the probe's 4096 x 128 x 128 and ragged shapes; and what its
wrapper hands the C entry.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_wg_k5k8.py``): K5 at 64 -> 64, b = 1 and 2, 720p and
36 x 52, float32 (TF32 off; max|diff| <= 1e-4 std) and bfloat16 (max < 0.04
std, mean < 0.002 std), one counted launch each, its mma.sync yardstick
and the other staging of its input; K8 in every form against its plain version (bf16 within 1e-5 of
max|ref|, int8 bitwise) and against the library call's output
(``torch.matmul``, ``torch._int_mm``), one counted launch each.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
from pnp_vcve_torch.kernels import conv_block as kc
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import launch as kl
from pnp_vcve_torch.kernels import probes as P

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
C = 64
# chip_smoke.py's CONV_RAGGED_CHANNELS: every pair but 64 -> 64 keeps mma.sync
CONV_PAIRS = [(ci, co) for ci in (3, 8, 64, 131) for co in (8, 64, 128)]


def _f(rng, *shape, k=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * k).astype(np.float32))


def _k5_args(rng, b, h, w):
    return (_f(rng, b, h, w, C), _f(rng, b, 3, 3, C, C, k=0.03), _f(rng, b, C, k=0.1),
            torch.from_numpy(rng.random((b, C)).astype(np.float32)))


def _read(img):
    """The taps an image holds, read as the kernel's wgmma does through an
    index map of its own: row n of a 128-byte-row tile is output channel n,
    and its input channel k of k-block kb sits in 16-byte chunk (k // vec)
    ^ (n % 8) at element k % vec. ``img (b, 9, KB, NW, 64, per_row)`` ->
    ``(NW, b, 9, 64, KB * per_row)``."""
    a = img.float().numpy() if img.dtype == BF16 else img.contiguous().numpy()
    b, taps, kb, nw, n, per_row = a.shape
    vec = 16 // img.element_size()
    assert per_row * img.element_size() == 128
    out = np.zeros((nw, b, taps, n, kb * per_row), a.dtype)
    for row in range(n):
        for k in range(per_row):
            src = a[..., row, ((k // vec) ^ (row % 8)) * vec + k % vec]  # (b, 9, KB, NW)
            for b_ in range(kb):
                out[:, :, :, row, b_ * per_row + k] = np.moveaxis(src[:, :, b_, :], -1, 0)
    return out


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k5_images_read_back_conv3x3_args(dtype, b):
    """The per-sample taps, read back from the image through the kernel's
    addressing, are ``conv3x3_args``' operands, bitwise: one (bfloat16) or
    two (float32) 128-byte k-blocks a tap, float32 as the TF32 head and
    tail; the bias and the gain pass as they are."""
    rng = np.random.default_rng(b)
    x, k, bias, g = _k5_args(rng, b, 4, 4)
    x = x.to(dtype)
    wk, bf, gf = kc.conv3x3_args(x, k, bias, g)
    img, bf2, gf2 = kc.conv3x3_operands(x, k, bias, g)
    nw, kb = (2, 2) if dtype == F32 else (1, 1)
    assert img.dtype == dtype and img.is_contiguous()
    assert img.shape == (b, 9, kb, nw, C, 128 // img.element_size())
    got, want = _read(img), (wk.float() if dtype == BF16 else wk).numpy()
    assert got.shape == want.shape and np.array_equal(got.view(np.int32), want.view(np.int32))
    assert torch.equal(bf, bf2) and torch.equal(gf, gf2)


def _emulate_k5(x, img, bias, gain, dtype):
    """K5's GEMM tile by tile over conv3x3_wg's walk on the read-back
    operands (the float32 head and tail summed): a (rows + 2) x 34 chunk tile
    zero-filled outside the image, a chunk of 64 (bfloat16) or 32 (float32)
    channels a k-block, a tap's GEMM each; the epilogue gain * (sums +
    bias). Also counts the writes of each output pixel."""
    th, tw = kd.K5_TILE[dtype]
    xs = x.double().numpy()
    b, h, w, _ = xs.shape
    wk = _read(img).astype(np.float64).sum(0)  # (b, 9, 64 out, 64 in)
    kc_ = 32 if dtype == F32 else 64
    bias, gain = bias.double().numpy(), gain.double().numpy()
    out = np.zeros((b, h, w, C))
    writes = np.zeros((b, h, w), np.int64)
    _, blocks = kd.wg_tile_walk(b, h, w, 132, kd.K5_TILE[dtype])
    for tiles in blocks:
        for s, y0, x0 in tiles:
            xt = np.zeros((th + 2, tw + 2, C))
            ys, xs_ = slice(max(y0 - 1, 0), min(y0 + th + 1, h)), slice(max(x0 - 1, 0),
                                                                        min(x0 + tw + 1, w))
            xt[ys.start - y0 + 1:ys.stop - y0 + 1, xs_.start - x0 + 1:xs_.stop - x0 + 1] = \
                xs[s, ys, xs_]
            acc = np.zeros((th, tw, C))
            for c0 in range(0, C, kc_):
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    acc += xt[dy:dy + th, dx:dx + tw, c0:c0 + kc_] @ wk[s, tap][:, c0:c0 + kc_].T
            o = gain[s] * (acc + bias[s])
            hh, ww = min(th, h - y0), min(tw, w - x0)
            out[s, y0:y0 + hh, x0:x0 + ww] = o[:hh, :ww]
            writes[s, y0:y0 + hh, x0:x0 + ww] += 1
    return out, writes


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", [(1, 20, 40), (2, 19, 33)])
def test_k5_wg_gemm_computes_the_conv(b, h, w, dtype):
    """K5's GEMM on the operands read back from its image, tile by tile over
    its walk with the bias-and-gain epilogue, gives ``conv3x3_plain`` on the
    same operands (bfloat16: the features and the kernels rounded as the
    kernel takes them) within 1e-5, at sizes no tile divides, each output
    pixel written once."""
    rng = np.random.default_rng(10 * b + h)
    x, k, bias, g = _k5_args(rng, b, h, w)
    xk = x.to(dtype)
    img, bf, gf = kc.conv3x3_operands(xk, k, bias, g)
    got, writes = _emulate_k5(xk.float(), img, bf, gf, dtype)
    assert (writes == 1).all()
    k_used = k if dtype == F32 else k.to(BF16).float()
    want = kc.conv3x3_plain(xk.float(), k_used, bias, g)
    np.testing.assert_allclose(got, want.double().numpy(), atol=1e-5, rtol=0)


def test_k5_wg_gemm_matches_jax_conv3x3_pallas():
    """The emulated K5 (float32, two samples) against JAX's
    ``conv3x3_pallas`` (interpret mode on the CPU), its output times the
    gain, on the same numpy inputs, within 1e-5."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from pnp_vcve_tpu.kernels import conv3x3_pallas

    rng = np.random.default_rng(5)
    x, k, bias, g = _k5_args(rng, 2, 16, 36)
    img, bf, gf = kc.conv3x3_operands(x, k, bias, g)
    got, _ = _emulate_k5(x, img, bf, gf, F32)
    with pltpu.force_tpu_interpret_mode():
        jax_out = conv3x3_pallas(*(jnp.asarray(t.numpy()) for t in (x, k, bias)), th=8)
    want = np.asarray(jax_out, np.float64) * g.double().numpy()[:, None, None, :]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", [(1, 720, 1280), (2, 36, 52), (4, 256, 448), (1, 17, 33)])
def test_k5_walk_covers_every_pixel_once(b, h, w, dtype):
    """K5's walk on an H100's 132 SMs: every output pixel lies in exactly
    one visited tile (16 x 32 bfloat16, 12 x 32 float32), no tile is
    visited twice, and the blocks' loads differ by at most one tile."""
    th, tw = kd.K5_TILE[dtype]
    grid, blocks = kd.wg_tile_walk(b, h, w, 132, kd.K5_TILE[dtype])
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


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k5_dispatch_by_widths(dtype):
    """64 -> 64 takes K5's wgmma design, every other pair of widths the
    mma.sync design, one launch each, in both types."""
    for ci, co in CONV_PAIRS + [(64, 24), (24, 64)]:
        want = ("wgmma", 1) if (ci, co) == (64, 64) else ("mma.sync", 1)
        assert kl.kernel_design("conv3x3", co, dtype, c_in=ci) == want, (ci, co)


@pytest.mark.parametrize("ci,co", [(64, 64), (64, 128), (3, 64), (131, 8)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_k5_wrapper_hands_the_entry_its_designs_weights(monkeypatch, dtype, ci, co):
    """What the op's CUDA implementation passes the C entry, captured on
    CPU tensors: x, at 64 -> 64 the wgmma design's image, at any other pair
    ``conv3x3_args``' taps, the float32 bias and gain (zeros and ones where
    none are given), the output and the sizes."""
    rng = np.random.default_rng(ci + co)
    b, h, w = 2, 6, 10
    seen = {}

    def fake_launch(name, entry, out, *rest):
        seen.update(name=name, entry=entry, out=out, rest=rest)
        return out

    monkeypatch.setattr(kc, "launch", fake_launch)
    x = _f(rng, b, h, w, ci).to(dtype)
    k = _f(rng, b, 3, 3, ci, co, k=0.03)
    bias, g = _f(rng, b, co), torch.from_numpy(rng.random((b, co)).astype(np.float32))
    kc._conv3x3_kernel(x, k, bias, g)
    wk = kc.conv3x3_args(x, k, bias, g)[0]
    want = kd.wg_image(wk) if (ci, co) == (64, 64) else wk
    assert seen["name"] == "conv3x3" and seen["entry"] == "pnp_conv3x3"
    got_x, got_w, got_b, got_g, got_out, *sizes = seen["rest"]
    assert got_x is x and got_out is seen["out"] and got_out.shape == (b, h, w, co)
    assert got_w.shape == want.shape and torch.equal(got_w, want)
    assert torch.equal(got_b, bias) and torch.equal(got_g, g) and got_b.dtype == F32
    assert sizes == [b, h, w, ci, co]
    kc._conv3x3_kernel(x, k, None, None)
    assert torch.equal(seen["rest"][2], torch.zeros((b, co)))
    assert torch.equal(seen["rest"][3], torch.ones((b, co)))


# ---- K8 ---------------------------------------------------------------------

# (m, k, n): the probe's; ragged (no tile or chunk divides m, n or k); a
# depth of more chunks than the bf16 ring's stages
MATMUL_SHAPES = {"probe": (4096, 128, 128), "ragged": (80, 96, 72), "deep": (64, 320, 64)}


def _emulate_k8(a, b, scale):
    """K8 block by block over ``probes.matmul_tiles``: each block's out rows
    and columns, its depth chunk by chunk, zeros past m, n and k; bf16 sums
    in float64, int8 in int64 (exact), the scale in float32 as the epilogue
    applies it. Counts each output's writes."""
    (m, k), n = a.shape, b.shape[1]
    tm, tn, kc_ = P.matmul_tile_shape(a.dtype)
    exact = a.dtype == torch.int8
    an = a.numpy().astype(np.int64) if exact else a.float().double().numpy()
    bn = b.numpy().astype(np.int64) if exact else b.float().double().numpy()
    out = np.zeros((m, n), np.int64 if exact else np.float64)
    writes = np.zeros((m, n), np.int64)
    for (m0, n0), chunks in P.matmul_tiles(m, n, k, a.dtype):
        acc = np.zeros((tm, tn), out.dtype)
        for k0 in chunks:
            at = np.zeros((tm, kc_), out.dtype)
            bt = np.zeros((kc_, tn), out.dtype)
            sa = an[m0:m0 + tm, k0:k0 + kc_]
            sb = bn[k0:k0 + kc_, n0:n0 + tn]
            at[:sa.shape[0], :sa.shape[1]] = sa
            bt[:sb.shape[0], :sb.shape[1]] = sb
            acc += at @ bt
        hh, ww = min(tm, m - m0), min(tn, n - n0)
        out[m0:m0 + hh, n0:n0 + ww] = acc[:hh, :ww]
        writes[m0:m0 + hh, n0:n0 + ww] += 1
    if exact:
        res = torch.from_numpy(out.astype(np.int32))
        return (res if scale is None else res.float() * scale), writes
    return torch.from_numpy(out), writes


def _k8_inputs(dtype, m, k, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == BF16:
        return (P.bf16_from_numpy(rng.standard_normal((m, k)).astype(np.float32), "cpu"),
                P.bf16_from_numpy((rng.standard_normal((k, n)) * 0.05).astype(np.float32),
                                  "cpu"))
    return (torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)),
            torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)))


@pytest.mark.parametrize("form", ["bf16", "int8", "int8_scale"])
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES))
def test_k8_tiles_compute_the_product(form, shape):
    """K8's blocks and depth chunks (bf16: the wgmma design's 64 x 64 tiles
    and 64-deep chunks; int8: the s8 wgmma design's 64 x 64 and 128), each
    output written once, give ``matmul_plain``: int8 bitwise (with and
    without the scale), bf16 within 1e-5 of max|ref|."""
    m, k, n = MATMUL_SHAPES[shape]
    dtype = BF16 if form == "bf16" else torch.int8
    a, b = _k8_inputs(dtype, m, k, n, m + k + n)
    scale = torch.tensor([0.0123], dtype=F32) if form == "int8_scale" else None
    got, writes = _emulate_k8(a, b, scale)
    assert (writes == 1).all()
    want = P.matmul_plain(a, b, scale)
    if dtype == BF16:
        err = float((got - want.double()).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_k8_tiles_fill_the_card_in_one_wave():
    """At the probe's 4096 x 128 x 128 the bf16 design runs 128 blocks (one
    wave on 132 SMs), each the whole depth in two chunks, both in flight in
    its ring; the int8 design 128 too, each the whole depth in one chunk."""
    tiles = P.matmul_tiles(4096, 128, 128, BF16)
    assert len(tiles) == 128 and all(len(ch) == 2 for _, ch in tiles)
    tiles8 = P.matmul_tiles(4096, 128, 128, torch.int8)
    assert 2 <= P.MATMUL_STAGES and len(tiles8) == 128 and all(len(ch) == 1 for _, ch in tiles8)
    assert P.MATMUL_SMEM <= kl.SMEM_MAX


@pytest.mark.parametrize("form", ["bf16", "int8", "int8_scale"])
def test_k8_wrapper_hands_the_entry(monkeypatch, form):
    """What ``probes.matmul`` passes the C entry on a CUDA-looking call: the
    type code (1 bf16, 2 int8), a, b, the scale or None, the output (float32,
    or int32 for int8 without a scale) and m, n, k."""
    m, k, n = 32, 64, 24
    dtype = BF16 if form == "bf16" else torch.int8
    a, b = _k8_inputs(dtype, m, k, n, 3)
    scale = torch.tensor([0.5], dtype=F32) if form == "int8_scale" else None
    seen = {}
    monkeypatch.setattr(P, "on_cpu", lambda x: False)
    monkeypatch.setattr(P, "_call", lambda name, entry, dev, *args: seen.update(
        name=name, entry=entry, args=args))
    out = P.matmul(a, b, scale)
    code, ga, gb, gs, gout, *sizes = seen["args"]
    assert seen["name"] == ("matmul" if dtype == BF16 else "matmul_int8")
    assert seen["entry"] == "pnp_matmul"
    assert code == (1 if dtype == BF16 else 2) and ga is a and gb is b and gs is scale
    assert gout is out and out.shape == (m, n)
    assert out.dtype == (torch.int32 if form == "int8" else F32)
    assert sizes == [m, n, k]


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
        assert float(diff.max()) < 0.04 * sd, (float(diff.max()), sd)
        assert float(diff.mean()) < 0.002 * sd, (float(diff.mean()), sd)


def _card_k5(dev, dtype, b, h, w):
    gen = torch.Generator().manual_seed(b * h + w)
    return (torch.randn((b, h, w, C), generator=gen).to(dev, dtype),
            (torch.randn((b, 3, 3, C, C), generator=gen) * 0.03).to(dev),
            (torch.randn((b, C), generator=gen) * 0.1).to(dev),
            torch.rand((b, C), generator=gen).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", [(1, 720, 1280), (2, 720, 1280), (1, 36, 52), (2, 36, 52)])
def test_wg_conv3x3_kernel(cuda, dtype, b, h, w):
    x, k, bias, g = _card_k5(cuda, dtype, b, h, w)
    reset_launches()
    got = KERNELS.conv3x3(x, k, bias, g)
    assert LAUNCHES["conv3x3"] == 1 and sum(LAUNCHES.values()) == 1
    _check(got, PLAIN.conv3x3(x.float(), k, bias, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_conv3x3_mma_sync_yardstick(cuda, dtype):
    """The mma.sync design at 64 -> 64 through its own entry (chip_smoke.py's
    yardstick) holds the same bounds, and counts nowhere."""
    x, k, bias, g = _card_k5(cuda, dtype, 2, 36, 52)
    wk, bf, gf = kc.conv3x3_args(x, k, bias, g)
    out = torch.empty_like(x)
    reset_launches()
    kl.call("conv3x3", "pnp_conv3x3_mma_sync", cuda, 0 if dtype == F32 else 1, x, wk, bf, gf,
            out, *x.shape, C, counts={"conv3x3": 0})
    assert sum(LAUNCHES.values()) == 0
    _check(out, PLAIN.conv3x3(x.float(), k, bias, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("b,h,w", [(1, 720, 1280), (2, 36, 52)])
def test_conv3x3_wg_other_input_staging(cuda, dtype, b, h, w):
    """The wgmma design with the other staging of its input chunks (bf16 by
    tensor-map boxes, zeros outside the image from the map; float32 by
    cp.async) through its own entry holds the same bounds, and counts
    nowhere."""
    x, k, bias, g = _card_k5(cuda, dtype, b, h, w)
    ops = kc.conv3x3_operands(x, k, bias, g)
    out = torch.empty_like(x)
    reset_launches()
    kl.call("conv3x3", "pnp_conv3x3_wg_alt_staging", cuda, 0 if dtype == F32 else 1, x, *ops, out,
            *x.shape, C, counts={"conv3x3": 0})
    assert sum(LAUNCHES.values()) == 0
    _check(out, PLAIN.conv3x3(x.float(), k, bias, g), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "int8", "int8_scale"])
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES))
def test_matmul_kernel_forms(cuda, form, shape):
    m, k, n = MATMUL_SHAPES[shape]
    dtype = BF16 if form == "bf16" else torch.int8
    a, b = (t.to(cuda) for t in _k8_inputs(dtype, m, k, n, m + k + n))
    scale = torch.tensor([0.0123], dtype=F32, device=cuda) if form == "int8_scale" else None
    P.reset_launches()
    got = P.matmul(a, b, scale)
    torch.cuda.synchronize()
    assert P.LAUNCHES["matmul" if dtype == BF16 else "matmul_int8"] == 1
    assert sum(P.LAUNCHES.values()) == 1
    want = P.matmul_plain(a, b, scale)
    if dtype == BF16:
        tol = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol
        assert float((torch.matmul(a, b).float() - got).abs().max()) <= tol + 2 ** -8 * float(
            got.abs().max())  # the library's own bf16 output rounding
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)
        if scale is None and n % 16 == 0:  # cuBLASLt's int8 product refuses the ragged n
            assert torch.equal(torch._int_mm(a, b), got)
