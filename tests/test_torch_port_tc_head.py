"""K4 and K5 on the tensor cores (csrc/tc_conv.cuh's GEMM loop, shared with
K2): what the CPU can check of them, and on the card the kernels against
their plain versions.

On the CPU: the operands the wrappers hand the kernels in each feature type
(``conv_block.conv3x3_args``, ``drt_stack.head_args``), multiplied out in
float64 as the kernels' GEMMs take them, give the plain versions: K5's
unscaled per-sample taps (rows padded from c_in to a multiple of 8) with
the gain applied after the bias, K4's W_hr as two terms (the 3xTF32 split,
or bfloat16's hi + lo) and its float32 hidden map. Why two bfloat16 terms:
an emulation of the head's bfloat16 arithmetic against float32, at the
bounds of the card tests. K4's plain version at 64 channels and at its
one-launch width against the JAX package's ``_xla_head``. No Pallas
interpret mode: these run in a few seconds.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_tc_head.py``): K5 at c_in in {3, 8, 64, 131} and
c_out in {8, 64, 128} with two samples' own kernels, K4 at
test_torch_port_tc.py's widths, at its one-launch width (144) and above it
(152, 192: two launches), each in float32 (TF32 off) and bfloat16 against
its plain version in float32, one counted launch each, under
test_torch_port_tc.py's bounds (bfloat16 max 0.02 std, K5's 0.04 as in
tests/test_torch_port_kernels.py, mean 0.002 std).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pnp_vcve_torch.kernels import KERNELS, PLAIN
from pnp_vcve_torch.kernels import conv_block as kc
from pnp_vcve_torch.kernels import drt_stack as kd
from test_torch_port_tc import (  # noqa: F401  (cuda: the card fixture)
    CARD_WIDTHS, DTYPES, RAGGED, _check, _launched_once, _operand, _rand, _taps_conv, cuda)

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
CONV_IN, CONV_OUT = [3, 8, 64, 131], [8, 64, 128]


def _round_up8(c):
    return -(-c // 8) * 8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c_in", CONV_IN)
def test_conv3x3_operands_compute_the_conv(c_in, dtype):
    """K5's GEMM emulated on ``conv3x3_args``'s operands: the per-sample
    taps unscaled (bfloat16: rounded as the plain version rounds them),
    each row zero-padded from c_in to a multiple of 8; g * (conv + b) gives
    ``conv3x3_plain`` (on the bfloat16 weights' values in bfloat16) within
    1e-5: the gain after the bias, not folded into the weights."""
    rng = np.random.default_rng(c_in)
    b, h, w, c_out = 2, 10, 14, 24
    x = _rand(rng, b, h, w, c_in).to(dtype)
    k = _rand(rng, b, 3, 3, c_in, c_out, scale=0.5 / c_in ** 0.5)  # outputs ~1.5 std
    bias, g = _rand(rng, b, c_out, scale=0.1), _rand(rng, b, c_out)
    wk, bf, gf = kc.conv3x3_args(x, k, bias, g)
    wc = _round_up8(c_in)
    assert wk.dtype == dtype and wk.shape == (1 if dtype == BF16 else 2, b, 9, c_out, wc)
    assert bool((wk[..., c_in:] == 0).all())
    assert torch.equal(bf, bias) and torch.equal(gf, g)
    taps = k.reshape(b, 9, c_in, c_out).transpose(-1, -2)
    if dtype == BF16:
        assert torch.equal(wk[0, ..., :c_in], taps.to(BF16))
        k = k.to(BF16).float()  # the values the plain version multiplies by
    xd = F.pad(x.double(), (0, wc - c_in))
    out = (_taps_conv(xd, _operand(wk)) + bias.double()[:, None, None]) * g.double()[:, None, None]
    want = kc.conv3x3_plain(x.float(), k, bias, g)
    np.testing.assert_allclose(out.numpy(), want.double().numpy(), atol=1e-5, rtol=0)


def test_conv3x3_args_refuse_what_the_kernel_cannot_take():
    """c_out must be a multiple of 8; kernels, biases and gains one per
    sample."""
    x, z = torch.zeros((2, 8, 8, 19)), torch.zeros
    with pytest.raises(ValueError, match="c_out % 8"):
        kc.conv3x3_args(x, z((2, 3, 3, 19, 12)), z((2, 12)), z((2, 12)))
    with pytest.raises(ValueError, match="c_out % 8"):
        kc.conv3x3_args(x, z((1, 3, 3, 19, 16)), z((2, 16)), z((2, 16)))
    with pytest.raises(ValueError, match="biases and gamma"):
        kc.conv3x3_args(x, z((2, 3, 3, 19, 16)), z((2, 16)), z((16,)))


def _head_case(rng, c, b=1, h=10, w=14):
    s = 0.03 * 8 / c ** 0.5
    return [_rand(rng, b, h, w, c), _rand(rng, 3, 3, c, c, scale=s), _rand(rng, c, scale=0.1),
            _rand(rng, 3, 3, c, 3, scale=2 * s), _rand(rng, 3, scale=0.1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 64])
def test_head_operands_compute_the_head(c, dtype):
    """K4's stage 1 emulated on ``head_args``'s two W_hr terms (float32:
    tf32_split's head and tail; bfloat16: hi = W rounded, lo = the rest
    rounded), the hidden map kept in float64 as the kernel keeps it in
    float32, then conv_last on the float32 W_last: ``head_plain`` in
    float32 within 1e-5 (float32) / 1e-4 (bfloat16: the two terms hold
    W_hr to ~2^-17)."""
    rng = np.random.default_rng(40 + c)
    x, hr_k, hr_b, last_k, last_b = _head_case(rng, c)
    x = x.to(dtype)
    whr, bhr, wl, bl = kd.head_args(x, hr_k, hr_b, last_k, last_b)
    assert whr.dtype == dtype and whr.shape == (2, 9, c, c)
    assert (bhr.dtype, wl.dtype, bl.dtype) == (F32, F32, F32)
    taps = hr_k.reshape(9, c, c).transpose(-1, -2)
    if dtype == BF16:
        hi, lo = taps.to(BF16), (taps - taps.to(BF16).float()).to(BF16)
        assert torch.equal(whr[0], hi) and torch.equal(whr[1], lo)
        assert float((_operand(whr) - taps.double()).abs().max()) <= 2.0 ** -16 * float(
            taps.abs().max())
    hidden = F.leaky_relu(_taps_conv(x.double(), _operand(whr)) + bhr.double(), 0.1)
    out = _taps_conv(hidden, wl.double().transpose(-1, -2)) + bl.double()
    want = kd.head_plain(x.float(), hr_k, hr_b, last_k, last_b)
    np.testing.assert_allclose(out.numpy(), want.double().numpy(),
                               atol=1e-5 if dtype == F32 else 1e-4, rtol=0)


def test_head_bf16_needs_two_weight_terms():
    """The design choice behind K4's bfloat16 W_hr, on chip_smoke.py's head
    case (64 channels, weights 0.03 and 0.06, a bfloat16 frame): with W_hr
    rounded to one bfloat16 term, a float32 hidden map and the output
    rounded to bfloat16, the mean error against float32 is above 0.8 of the
    card's bound (0.002 std; the output's own rounding is ~0.57 of it); with
    two terms, hi + lo, it stays below 0.65."""
    rng = np.random.default_rng(0)
    c, h, w = 64, 48, 96
    r = lambda *s, k=1.0: torch.from_numpy(rng.standard_normal(s) * k)  # noqa: E731
    x = r(1, h, w, c).to(BF16).double()
    hr_k, hr_b, last_k, last_b = r(3, 3, c, c, k=0.03), r(c, k=0.1), r(3, 3, c, 3, k=0.06), r(
        3, k=0.1)

    def head(w_hr):
        y = F.conv2d(x.permute(0, 3, 1, 2), w_hr.permute(3, 2, 0, 1), padding=1)
        y = F.leaky_relu(y + hr_b[:, None, None], 0.1)
        y = F.conv2d(y, last_k.permute(3, 2, 0, 1), padding=1) + last_b[:, None, None]
        return y

    ref = head(hr_k)
    hi = hr_k.to(BF16).double()
    lo = (hr_k - hi).to(BF16).double()
    bound = 0.002 * float(ref.std())
    one, two = (float((head(w_hr).to(BF16).double() - ref).abs().mean()) / bound
                for w_hr in (hi, hi + lo))
    assert one > 0.8 and two < 0.65, (one, two)


@pytest.mark.parametrize("c", [64, 144])
def test_head_matches_xla_head(c):
    """K4's plain version at the flagship's 64 channels and at its
    one-launch width (144) against ``_xla_head`` at 16x32, float32, atol
    2e-5."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.kernels.drt_stack import _xla_head

    rng = np.random.default_rng(c)
    x, *hd = _head_case(rng, c, 1, 16, 32)
    want = _xla_head(jnp.asarray(x.numpy()), tuple(jnp.asarray(a.numpy()) for a in hd))
    got = kd.head_plain(x, *hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


# ---- on the card -------------------------------------------------------------

HEAD_WIDTHS = sorted({*CARD_WIDTHS, 144, 152, 192})  # 144 the one-launch width; above, two


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c_out", CONV_OUT)
@pytest.mark.parametrize("c_in", CONV_IN)
def test_conv3x3_tc_kernel(cuda, c_in, c_out, dtype):
    b, h, w = RAGGED
    gen = torch.Generator().manual_seed(200 + c_in + c_out)
    x = torch.randn((b, h, w, c_in), generator=gen).to(cuda, dtype)
    k = (torch.randn((b, 3, 3, c_in, c_out), generator=gen) * 0.24 / c_in ** 0.5).to(cuda)
    bias = (torch.randn((b, c_out), generator=gen) * 0.1).to(cuda)
    g = torch.rand((b, c_out), generator=gen).to(cuda)
    got = _launched_once("conv3x3", lambda: KERNELS.conv3x3(x, k, bias, g))
    _check(got, PLAIN.conv3x3(x.float(), k, bias, g), dtype, 0.04)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", HEAD_WIDTHS)
def test_head_tc_kernel(cuda, c, dtype):
    """One counted call at every width: one launch up to 144 channels, two
    through a float32 scratch above."""
    b, h, w = RAGGED
    gen = torch.Generator().manual_seed(300 + c)
    s = 0.03 * 8 / c ** 0.5
    x = torch.randn((b, h, w, c), generator=gen).to(cuda, dtype)
    hd = ((torch.randn((3, 3, c, c), generator=gen) * s).to(cuda),
          (torch.randn((c,), generator=gen) * 0.1).to(cuda),
          (torch.randn((3, 3, c, 3), generator=gen) * 2 * s).to(cuda),
          (torch.randn((3,), generator=gen) * 0.1).to(cuda))
    got = _launched_once("head", lambda: KERNELS.head(x, *hd))
    _check(got, PLAIN.head(x.float(), *hd), dtype)
