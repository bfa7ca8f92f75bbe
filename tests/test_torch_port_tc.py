"""K2 and K3 on the tensor cores (csrc/tc_conv.cuh): what the CPU can check of
them, and on the card the kernels against their plain versions.

On the CPU: the 3xTF32 split the wrappers apply to the float32 weights
(``drt_stack.tf32_split``), the weight operands they hand the kernels per
feature type (``tc_weights``, ``drt_block_args``, ``input_conv_args``), held
to the plain versions by an emulation of the kernels' GEMMs on those
operands, the choice between the one- and the two-launch forms
(``launch.launch_form``), and K3's and K4's plain versions at the widths
that take the two-launch form (216 and 192) against the JAX package's XLA
compositions (``_xla_block_compose``, ``_xla_head``; the JAX package's own
tests pin those to its Pallas kernels), and the 3xTF32 bound of
tools/torch_kernel_bounds.py.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_tc.py``; JAX is imported only by the CPU tests): K2
(3 and 4 parts), K3 and K3s against their plain versions in float32 (TF32
off) and bfloat16 at a ragged size and widths 8, 24, 64, 128 and 216 (K3s
at 64 only), K3's bfloat16 two-launch form at 392 and K4's at 192, under
the bounds of
tests/test_torch_port_kernels.py: float32 max|diff| <= 1e-4 std, bfloat16
max < 0.02 std (K2 0.04) and mean < 0.002 std.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import launch as kl

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_tf32_split_head_and_tail():
    """The head has its low 13 mantissa bits zero and so has the tail (it is
    rounded to TF32); head + tail is the float to 2^-21 relative. The
    three-product sum hi*hi + hi*lo + lo*hi, each product exact in float32
    (11 x 11 significant bits) and summed in float32, is the float64
    product to 2^-20 relative, where one TF32 product misses by ~2^-11."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    ah, al = kd.tf32_split(a)
    bh, bl = kd.tf32_split(b)
    for t in (ah, al, bh, bl):
        assert bool(((_bits(t) & 0x1FFF) == 0).all())
    a64, b64 = a.double(), b.double()
    assert float(((ah.double() + al.double() - a64).abs() / a64.abs()).max()) <= 2.0 ** -21
    exact = a64 * b64
    three = (ah * bh + ah * bl + al * bh).double()  # float32 products and sums
    rel = ((three - exact).abs() / exact.abs()).max()
    assert float(rel) <= 2.0 ** -20
    assert float(((ah * bh).double() - exact).abs().div(exact.abs()).max()) > 2.0 ** -14


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_tc_weights_per_type(dtype):
    """bfloat16: one operand, each tap transposed and rounded to bfloat16.
    float32: two, the split's head and tail of each transposed tap."""
    rng = np.random.default_rng(1)
    taps = torch.from_numpy(rng.standard_normal((2, 9, 24, 40)).astype(np.float32))
    got = kd.tc_weights(taps, dtype)
    want = taps.transpose(-1, -2)
    if dtype == BF16:
        assert got.dtype == BF16 and got.shape == (1, 2, 9, 40, 24)
        assert torch.equal(got[0], want.to(BF16))
    else:
        hi, lo = kd.tf32_split(want)
        assert got.dtype == F32 and got.shape == (2, 2, 9, 40, 24)
        assert torch.equal(_bits(got[0]), _bits(hi)) and torch.equal(_bits(got[1]), _bits(lo))


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _taps_conv(x, taps):
    """'same' 3x3 conv of ``x (b, h, w, ci)`` with transposed taps ``(b, 9,
    co, ci)`` or ``(9, co, ci)``, tap t = 3 dy + dx read at (y + dy - 1,
    x + dx - 1): the kernels' GEMM, here in float64."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = 0
    for t in range(9):
        dy, dx = divmod(t, 3)
        win = xp[:, dy:dy + h, dx:dx + w]
        k = taps[:, t] if taps.dim() == 4 else taps[t].expand(b, -1, -1)
        out = out + torch.einsum("bhwi,boi->bhwo", win, k)
    return out


def _operand(stack):
    """The value a kernel multiplies by: head + tail (float32) or the
    bfloat16 weights, in float64."""
    return stack.double().sum(0)


@pytest.mark.parametrize("c", [8, 24, 64])
def test_drt_block_operands_compute_the_block(c):
    """K3's GEMMs emulated on ``drt_block_args``'s float32 operands (the
    gain applied to conv + b2, then the gated partition taps) give
    ``drt_block_plain`` within 1e-5: the layout of every operand."""
    rng = np.random.default_rng(c)
    b, h, w = 2, 10, 14
    s = 0.03 * 8 / c ** 0.5
    x = _rand(rng, b, h, w, c)
    par = torch.from_numpy((rng.random((b, h, w, 3)) > 0.5).astype(np.float32))
    args = (_rand(rng, b, 3, 3, c, c, scale=s), _rand(rng, b, c, scale=0.1),
            torch.from_numpy(rng.random((b, c)).astype(np.float32)),
            _rand(rng, c, 3, c, scale=s), _rand(rng, 3, 3, c, c, scale=s), _rand(rng, c, scale=0.1))
    w2, b2, g, pk, w1, b1 = kd.drt_block_args(x, par, *args)
    xd = x.double()
    acc = (_taps_conv(xd, _operand(w2)) + b2.double()[:, None, None]) * g.double()[:, None, None]
    pkd = _operand(pk)
    for r in range(3):
        acc = acc + torch.einsum("bhwi,oi->bhwo", xd * par[..., r:r + 1].double(), pkd[r])
    hmid = torch.relu(acc)
    out = xd + _taps_conv(hmid, _operand(w1)) + b1.double()
    want = kd.drt_block_plain(x, par, *args)
    np.testing.assert_allclose(out.numpy(), want.double().numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_parts", [3, 4])
def test_input_conv_operands_compute_the_conv(n_parts):
    """K2's GEMM emulated on ``input_conv_args``'s float32 operands (the lr
    frame zero-padded to one k-step, 8 channels) gives ``input_conv_plain``
    within 1e-5."""
    rng = np.random.default_rng(n_parts)
    b, h, w, c = 2, 10, 14, 24
    parts = [_rand(rng, b, h, w, 3)] + [_rand(rng, b, h, w, c) for _ in range(n_parts - 1)]
    kernel = _rand(rng, 3, 3, 3 + c * (n_parts - 1), c, scale=0.05)
    gate = torch.tensor([1.0, 0.0])
    ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
    bias = _rand(rng, c, scale=0.1)
    tks, biasf, _ = kd.input_conv_args(parts, ks, bias)
    assert tks[0].shape == (2, b, 9, c, 8) and bool((tks[0][..., 3:] == 0).all())
    acc = biasf.double()
    for p, k in zip([F.pad(parts[0], (0, 5))] + parts[1:], tks):
        acc = acc + _taps_conv(p.double(), _operand(k))
    out = F.leaky_relu(acc, 0.1)
    want = kd.input_conv_plain(parts, ks, bias)
    np.testing.assert_allclose(out.numpy(), want.double().numpy(), atol=1e-5, rtol=0)


def test_bf16_operands_round_as_the_plain_version():
    """In bfloat16 the kernels multiply by the weights rounded to bfloat16
    (the plain version's ``.to(x.dtype)``, JAX's ``astype``), with the gain
    and the biases apart in float32."""
    rng = np.random.default_rng(5)
    b, h, w, c = 1, 6, 10, 16
    x = _rand(rng, b, h, w, c).to(BF16)
    par = torch.ones((b, h, w, 3), dtype=BF16)
    args = (_rand(rng, b, 3, 3, c, c), _rand(rng, b, c), _rand(rng, b, c), _rand(rng, c, 3, c),
            _rand(rng, 3, 3, c, c), _rand(rng, c))
    w2, b2, g, pk, w1, b1 = kd.drt_block_args(x, par, *args)
    assert (w2.dtype, pk.dtype, w1.dtype) == (BF16, BF16, BF16)
    assert (b2.dtype, g.dtype, b1.dtype) == (F32, F32, F32)
    assert torch.equal(w2[0], args[0].reshape(b, 9, c, c).transpose(-1, -2).to(BF16))
    assert torch.equal(pk[0], args[3].permute(1, 2, 0).to(BF16))
    assert torch.equal(g, args[2]) and torch.equal(b2, args[1])


def test_launch_form_per_kernel_width_and_type():
    """One launch up to ONE_LAUNCH_WIDTH, two above (K3: 168 float32 /
    384 bfloat16; K4: 144 in both); K2 and K3s always one; only widths that
    are not multiples of 8 are refused (and K3s at anything but 64)."""
    form = kl.launch_form
    for c, f32, bf16 in ((8, 1, 1), (64, 1, 1), (168, 1, 1), (176, 2, 1), (216, 2, 1),
                         (384, 2, 1), (392, 2, 2), (1024, 2, 2)):
        assert (form("drt_block", c, F32), form("drt_block", c, BF16)) == (f32, bf16), c
    for c, n in ((64, 1), (144, 1), (152, 2), (184, 2), (192, 2), (512, 2)):
        assert form("head", c, F32) == form("head", c, BF16) == n
    assert form("input_conv", 1024, F32) == form("drt_block_select", 64, BF16) == 1
    with pytest.raises(ValueError, match="not a multiple of 8"):
        form("drt_block", 220, F32)
    with pytest.raises(ValueError, match="K3s takes 64 channels only"):
        form("drt_block_select", 216, F32)


def test_bounds_tool_gives_the_three_bounds():
    """tools/torch_kernel_bounds.py: K2's and K3's 720p work (c = 64) over
    the float32 CUDA cores, in 3xTF32 (three TF32 products a multiply-add
    over 495 TFLOP/s) and on the bf16 tensor cores: K3's 158.5 GFLOP are
    2.366, 0.961 and 0.160 ms."""
    import importlib
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    kb = importlib.import_module("torch_kernel_bounds")
    rows = {label: (flop, nbytes) for label, _, flop, nbytes in kb.model_kernels()}
    flop, nbytes = rows["drt_block"]
    assert flop == 2 * 21 * 64 * 64 * 720 * 1280
    b = kb.conv_bounds(flop, nbytes[4])
    assert b["tf32x3_ms"] == pytest.approx(3 * flop / 495e12 * 1e3)
    assert (round(b["f32_ms"], 3), round(b["tf32x3_ms"], 3), round(b["bf16_ms"], 3)) == (
        2.366, 0.961, 0.160)
    assert set(rows) == {"input_conv (backward, 3 parts)", "input_conv (forward, 4 parts)",
                         "drt_block"}


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def test_drt_block_216_matches_xla_compose(rng):
    """K3's plain version at 216 channels (above the float32 one-launch
    width) against ``_xla_block_compose`` at 16x32, float32, atol 2e-5
    (sums of 216 x 9 terms in another order)."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.kernels.drt_stack import _xla_block_compose

    b, h, w, c = 1, 16, 32, 216
    s = 0.03 * 8 / c ** 0.5
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    par = ((rng.random((b, h, w, 3)) > 0.5) / 255.0).astype(np.float32)
    f = lambda *sh, k=s: (rng.standard_normal(sh) * k).astype(np.float32)  # noqa: E731
    blk = dict(dyn_kernels=f(b, 3, 3, c, c), dyn_biases=f(b, c, k=0.1),
               gamma=rng.random((b, c)).astype(np.float32), par_kernel=f(c, 3, c),
               conv1_kernel=f(3, 3, c, c), conv1_bias=f(c, k=0.1))
    want = _xla_block_compose(jnp.asarray(x), jnp.asarray(par),
                              [{k: jnp.asarray(v) for k, v in blk.items()}])
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = kd.drt_block_plain(t(x), t(par), t(blk["dyn_kernels"]), t(blk["dyn_biases"]),
                             t(blk["gamma"]), t(blk["par_kernel"]), t(blk["conv1_kernel"]),
                             t(blk["conv1_bias"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_head_192_matches_xla_head(rng):
    """K4's plain version at 192 channels (above its one-launch width)
    against ``_xla_head`` at 16x32, float32, atol 2e-5."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.kernels.drt_stack import _xla_head

    b, h, w, c = 1, 16, 32, 192
    s = 0.03 * 8 / c ** 0.5
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    head = [(rng.standard_normal((3, 3, c, c)) * s).astype(np.float32),
            (rng.standard_normal((c,)) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, c, 3)) * 2 * s).astype(np.float32),
            (rng.standard_normal((3,)) * 0.1).astype(np.float32)]
    want = _xla_head(jnp.asarray(x), tuple(jnp.asarray(a) for a in head))
    got = kd.head_plain(torch.from_numpy(x), *map(torch.from_numpy, head))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# ---- on the card -------------------------------------------------------------

CARD_WIDTHS = [8, 24, 64, 128, 216]
RAGGED = (2, 20, 36)  # no multiple of the 8 x 16 tile
DTYPES = [F32, BF16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _check(got, ref, dtype, max_rel=0.02, mean_rel=0.002):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    assert bool(torch.isfinite(got).all())
    sd = float(ref.std())
    diff = (got - ref).abs()
    if dtype == F32:
        assert float(diff.max()) <= 1e-4 * sd, (float(diff.max()), sd)
    else:
        assert float(diff.max()) < max_rel * sd, (float(diff.max()), sd)
        assert float(diff.mean()) < mean_rel * sd, (float(diff.mean()), sd)


def _block_case(gen, dev, dtype, b, h, w, c):
    s = 0.03 * 8 / c ** 0.5

    def wt(*shape, k=s):
        return (torch.randn(shape, generator=gen) * k).to(dev)

    x = torch.randn((b, h, w, c), generator=gen).to(dev, dtype)
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    blk = (wt(b, 3, 3, c, c), wt(b, c, k=0.1), torch.rand((b, c), generator=gen).to(dev),
           wt(c, 3, c), wt(3, 3, c, c), wt(c, k=0.1))
    return x, par, blk


def _launched_once(name, fn):
    reset_launches()
    out = fn()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CARD_WIDTHS)
def test_drt_block_tc_kernel(cuda, c, dtype):
    b, h, w = RAGGED
    x, par, blk = _block_case(torch.Generator().manual_seed(c), cuda, dtype, b, h, w, c)
    got = _launched_once("drt_block", lambda: KERNELS.drt_block(x, par, *blk))
    _check(got, PLAIN.drt_block(x.float(), par.float(), *blk), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_drt_block_select_tc_kernel(cuda, dtype):
    b, h, w = RAGGED
    gen = torch.Generator().manual_seed(64)
    x, par, blk = _block_case(gen, cuda, dtype, b, h, w, 64)
    last_key = torch.randn((b, h, w, 64), generator=gen).to(cuda, dtype)
    is_key = torch.tensor([1.0, 0.0], device=cuda)
    out, new_lk = _launched_once(
        "drt_block_select", lambda: KERNELS.drt_block_select(x, par, *blk, last_key, is_key))
    _check(out, PLAIN.drt_block(x.float(), par.float(), *blk), dtype)
    assert torch.equal(new_lk, torch.where(is_key.reshape(-1, 1, 1, 1) > 0.5, out, last_key))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", CARD_WIDTHS)
@pytest.mark.parametrize("n_parts", [3, 4])
def test_input_conv_tc_kernel(cuda, n_parts, c, dtype):
    b, h, w = RAGGED
    gen = torch.Generator().manual_seed(100 + c)
    parts = [torch.randn((b, h, w, 3), generator=gen).to(cuda, dtype)] + [
        torch.randn((b, h, w, c), generator=gen).to(cuda, dtype) for _ in range(n_parts - 1)]
    kernel = (torch.randn((3, 3, 3 + c * (n_parts - 1), c), generator=gen)
              * 0.03 * 8 / c ** 0.5).to(cuda)
    bias = (torch.randn((c,), generator=gen) * 0.1).to(cuda)
    ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b,
                         torch.tensor([1.0, 0.0], device=cuda))
    got = _launched_once("input_conv", lambda: KERNELS.input_conv(parts, ks, bias))
    _check(got, PLAIN.input_conv([p.float() for p in parts], ks, bias), dtype, 0.04)


@pytest.mark.cuda
def test_two_launch_forms(cuda):
    """K3's bfloat16 two-launch form (392 channels) and K4's at 192 in both
    types: one counted call each."""
    b, h, w = RAGGED
    gen = torch.Generator().manual_seed(392)
    x, par, blk = _block_case(gen, cuda, BF16, 1, h, w, 392)
    assert kl.launch_form("drt_block", 392, BF16) == 2
    got = _launched_once("drt_block", lambda: KERNELS.drt_block(x, par, *blk))
    _check(got, PLAIN.drt_block(x.float(), par.float(), *blk), BF16)
    for dtype in DTYPES:
        c, s = 192, 0.03 * 8 / 192 ** 0.5
        x = torch.randn((b, h, w, c), generator=gen).to(cuda, dtype)
        hd = ((torch.randn((3, 3, c, c), generator=gen) * s).to(cuda),
              (torch.randn((c,), generator=gen) * 0.1).to(cuda),
              (torch.randn((3, 3, c, 3), generator=gen) * 2 * s).to(cuda),
              (torch.randn((3,), generator=gen) * 0.1).to(cuda))
        got = _launched_once("head", lambda: KERNELS.head(x, *hd))
        _check(got, PLAIN.head(x.float(), *hd), dtype)
