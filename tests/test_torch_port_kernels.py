"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:
``python -m pytest -m cuda --noconftest tests/test_torch_port_kernels.py``
(``--noconftest``: ``tests/conftest.py`` sets JAX up for the CPU tests, and
these tests do not need JAX). Elsewhere
every test skips (the card is looked for inside the ``cuda`` fixture, never
at import, so all workers collect the same tests).

Each kernel runs in float32 and in bfloat16 on the same values as its plain
version, which runs in float32 with TF32 off. In training each kernel runs
inside its ``torch.autograd.Function``, whose gradients are the plain
version's: they are held to plain autograd's at 1e-5 of the largest
gradient (cuDNN's weight gradients sum with atomics, in no fixed order). Bounds: float32
max|diff| <= 1e-4 std(ref) (sums in another order); bfloat16 max < 0.02 std
and mean < 0.002 std, the bounds of the JAX package's TPU kernels against
their float32 references (tests/test_tpu_parity.py:43-51), with the warp at
0.08 / 0.01 (:71) and the input conv's max at 0.04 std (:137): its leaky-ReLU
output reaches ~9.6 std, where bfloat16's own rounding of the output (half
an ulp) is already 0.019-0.038 std.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
from pnp_vcve_torch.kernels import drt_stack as kd

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SHAPES = [(2, 20, 36), (1, 64, 128)]  # a ragged size (no multiple of the 8x16 tile) and an aligned one
DTYPES = [torch.float32, torch.bfloat16]


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
    assert torch.isfinite(got).all()
    sd = float(ref.std()) or 1.0
    diff = (got - ref).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4 * sd, f"max|diff| {float(diff.max()):.3g}, std {sd:.3g}"
    else:
        assert float(diff.max()) < max_rel * sd, f"max|diff| {float(diff.max()):.3g}, std {sd:.3g}"
        assert float(diff.mean()) < mean_rel * sd


def _feat(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)


def _w(gen, shape, dev, scale):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_kernel(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(0)
    b, h, w = shape
    x = _feat(gen, (b, h, w, 64), dtype, cuda)
    flow = (torch.rand((b, h, w, 2), generator=gen) * 48 - 24).to(cuda, dtype)
    got = KERNELS.flow_warp(x, flow)
    _check(got, PLAIN.flow_warp(x.float(), flow.float()), dtype, 0.08, 0.01)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_parts", [3, 4])
def test_input_conv_kernel(cuda, shape, dtype, n_parts):
    gen = torch.Generator().manual_seed(1)
    b, h, w = shape
    parts = [_feat(gen, (b, h, w, 3), dtype, cuda)] + [
        _feat(gen, (b, h, w, 64), dtype, cuda) for _ in range(n_parts - 1)
    ]
    kernel = _w(gen, (3, 3, 3 + 64 * (n_parts - 1), 64), cuda, 0.03)
    bias = _w(gen, (64,), cuda, 0.1)
    gate = torch.tensor([1.0, 0.0][:b], device=cuda)
    ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b, gate)
    got = KERNELS.input_conv(parts, ks, bias)
    _check(got, PLAIN.input_conv([p.float() for p in parts], ks, bias), dtype, 0.04)


def _block(gen, b, dev):
    return (
        _w(gen, (b, 3, 3, 64, 64), dev, 0.03), _w(gen, (b, 64), dev, 0.1),
        torch.rand((b, 64), generator=gen).to(dev), _w(gen, (64, 3, 64), dev, 0.03),
        _w(gen, (3, 3, 64, 64), dev, 0.03), _w(gen, (64,), dev, 0.1),
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_drt_block_kernel(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(2)
    b, h, w = shape
    x = _feat(gen, (b, h, w, 64), dtype, cuda)
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(cuda, dtype)
    params = _block(gen, b, cuda)
    got = KERNELS.drt_block(x, par, *params)
    _check(got, PLAIN.drt_block(x.float(), par.float(), *params), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_head_kernel(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(3)
    b, h, w = shape
    x = _feat(gen, (b, h, w, 64), dtype, cuda)
    hr_k, hr_b = _w(gen, (3, 3, 64, 64), cuda, 0.03), _w(gen, (64,), cuda, 0.1)
    last_k, last_b = _w(gen, (3, 3, 64, 3), cuda, 0.06), _w(gen, (3,), cuda, 0.1)
    got = KERNELS.head(x, hr_k, hr_b, last_k, last_b)
    _check(got, PLAIN.head(x.float(), hr_k, hr_b, last_k, last_b), dtype)


# (c_in, c_out): the model's 64 -> 64; the 3-channel frame and 19 channels
# (one value at a time); c_out 8 and 136 (a narrow output group, and two
# groups of 64 plus a tail of 8)
CONV_CHANNELS = [(64, 64), (3, 64), (8, 8), (64, 8), (19, 136)]


@pytest.mark.parametrize("channels", CONV_CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_kernel(cuda, shape, dtype, channels):
    """K5 with different kernels, biases and gains per sample, one launch.
    bfloat16 max at 0.04 std, as the input conv's: the output reaches 5.5
    std, where bfloat16's own half-ulp rounding is 0.0207 std."""
    gen = torch.Generator().manual_seed(12)
    b, h, w = shape
    c_in, c_out = channels
    x = _feat(gen, (b, h, w, c_in), dtype, cuda)
    k, bias = _w(gen, (b, 3, 3, c_in, c_out), cuda, 0.03), _w(gen, (b, c_out), cuda, 0.1)
    g = torch.rand((b, c_out), generator=gen).to(cuda)
    reset_launches()
    got = KERNELS.conv3x3(x, k, bias, g)
    assert LAUNCHES["conv3x3"] == 1 and sum(LAUNCHES.values()) == 1
    _check(got, PLAIN.conv3x3(x.float(), k, bias, g), dtype, 0.04)


def test_conv3x3_refuses_what_it_cannot_take(cuda):
    """c_out must be a multiple of 8; kernels and biases one per sample."""
    x = torch.zeros((2, 8, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="c_out % 8"):
        KERNELS.conv3x3(x, torch.zeros((2, 3, 3, 16, 12), device=cuda))
    with pytest.raises(ValueError, match="c_out % 8"):
        KERNELS.conv3x3(x, torch.zeros((1, 3, 3, 16, 16), device=cuda))


def test_model_kernel_path_matches_plain_path(cuda):
    """PnPVCVE at the flagship width (2 blocks), kernel path against plain
    path; the launch counts show every step went through the kernels."""
    from pnp_vcve_torch.core.builder import build_generator

    model = build_generator(
        dict(type="PnPVCVE", mid_channels=64, num_blocks=2, num_experts=3), device=cuda
    )
    rng = np.random.default_rng(4)
    b, t, h, w = 1, 4, 38, 54  # pads to 40 x 56
    fb = rng.uniform(-20, 20, (b, t, h // 8 + 1, w // 8 + 1, 4)).astype(np.float32)
    mvs = np.repeat(np.repeat(fb, 8, axis=2), 8, axis=3)[:, :, :h, :w]
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0, 66.0]], np.float32),
        mvs=mvs,
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=((rng.random((b, t, h, w, 3)) > 0.5) / 255.0).astype(np.float32),
    )
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in inputs.items()}
    with torch.inference_mode():
        reset_launches()
        got = model(**inputs)
        counts = dict(LAUNCHES)
        model.ops = PLAIN
        want = model(**inputs)
    assert counts == {"warp": 2 * t, "warp_block": 0, "input_conv": 2 * t,
                      "drt_block": 2 * 2 * t, "drt_block_select": 0, "head": t, "conv3x3": 0}
    assert got.shape == (b, t, h, w, 3)
    assert float((got - want).abs().max()) <= 3e-3


BLOCK_SHAPES = [(2, 40, 56), (1, 64, 128)]  # K1b needs multiples of 8


@pytest.mark.parametrize("max_mv", [16.0, None])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_warp_block_kernel(cuda, shape, dtype, max_mv):
    """K1b on block-constant flows up to +-24 px (the 'pf' clamp bites) and
    on a field that is not block-constant (each block reads its top-left
    pixel)."""
    gen = torch.Generator().manual_seed(8)
    b, h, w = shape
    x = _feat(gen, (b, h, w, 64), dtype, cuda)
    fb = torch.rand((b, h // 8, w // 8, 2), generator=gen) * 48 - 24
    flow = fb.repeat_interleave(8, 1).repeat_interleave(8, 2)
    flow[:, 1::8] += 0.5  # not the top-left row: read by no block
    flow = flow.to(cuda, dtype)
    reset_launches()
    got = KERNELS.flow_warp_block(x, flow, max_mv)
    assert LAUNCHES["warp_block"] == 1
    _check(got, PLAIN.flow_warp_block(x.float(), flow.float(), max_mv), dtype, 0.08, 0.01)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_drt_block_select_kernel(cuda, shape, dtype):
    """K3s: out as K3's; new_last_key bitwise the select of its own out, one
    keyframe sample and one not."""
    gen = torch.Generator().manual_seed(9)
    b, h, w = shape
    x = _feat(gen, (b, h, w, 64), dtype, cuda)
    last_key = _feat(gen, (b, h, w, 64), dtype, cuda)
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(cuda, dtype)
    params = _block(gen, b, cuda)
    is_key = torch.tensor([1.0, 0.0][:b], device=cuda)
    for key in (is_key, 1.0 - is_key):
        reset_launches()
        out, new_lk = KERNELS.drt_block_select(x, par, *params, last_key, key)
        assert LAUNCHES["drt_block_select"] == 1 and sum(LAUNCHES.values()) == 1
        _check(out, PLAIN.drt_block(x.float(), par.float(), *params), dtype)
        want = torch.where(key.reshape(-1, 1, 1, 1) > 0.5, out, last_key)
        assert torch.equal(new_lk.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_drt_block_select_function_grads(cuda):
    """K3s through its Function launches once and gives plain autograd's
    gradients through both outputs."""
    gen = torch.Generator().manual_seed(10)
    b, h, w = 2, 20, 36

    def t(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(cuda).requires_grad_(True)

    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).float().to(cuda)
    args = [t((b, h, w, 64)), par, t((b, 3, 3, 64, 64), 0.03), t((b, 64), 0.1), t((b, 64)),
            t((64, 3, 64), 0.03), t((3, 3, 64, 64), 0.03), t((64,), 0.1), t((b, h, w, 64)),
            torch.tensor([1.0, 0.0], device=cuda)]
    wrt = [a for a in args if a.requires_grad]
    g = [torch.randn((b, h, w, 64), generator=gen).to(cuda) for _ in range(2)]
    reset_launches()
    got = torch.autograd.grad(KERNELS.drt_block_select(*args), wrt, g)
    torch.cuda.synchronize()
    assert LAUNCHES["drt_block_select"] == 1 and sum(LAUNCHES.values()) == 1
    want = torch.autograd.grad(PLAIN.drt_block_select(*args), wrt, g)
    for a, r in zip(got, want):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_model_pf_kernel_path_matches_plain_path(cuda):
    """The serving model (warp_impl='pf', 64 channels, 2 blocks) through
    K1b, K2, K3, K3s and K4 against its plain path, MVs up to +-24 px."""
    from pnp_vcve_torch.core.builder import build_generator

    model = build_generator(dict(type="PnPVCVE", mid_channels=64, num_blocks=2, num_experts=3,
                                 use_pallas_kernels=True, warp_impl="pf"), device=cuda)
    rng = np.random.default_rng(11)
    b, t, h, w = 2, 4, 48, 64
    fb = rng.uniform(-24, 24, (b, t, h // 8, w // 8, 4)).astype(np.float32)
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0, 66.0], [66.0, 80.0, 66.0, 66.0]], np.float32),
        mvs=np.repeat(np.repeat(fb, 8, axis=2), 8, axis=3),
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=((rng.random((b, t, h, w, 3)) > 0.5) / 255.0).astype(np.float32),
    )
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in inputs.items()}
    with torch.inference_mode():
        reset_launches()
        got = model(**inputs)
        counts = dict(LAUNCHES)
        model.ops = PLAIN
        want = model(**inputs)
    assert counts == {"warp": 0, "warp_block": 2 * t, "input_conv": 2 * t, "drt_block": 2 * t,
                      "drt_block_select": 2 * t, "head": t, "conv3x3": 0}
    assert float((got - want).abs().max()) <= 3e-3


def _grad_case(name, gen, b, h, w, dev):
    """(kernel call, plain call, the inputs) of one kernel in float32, with
    every weight and feature that training differentiates needing a gradient."""
    def t(shape, scale=1.0, grad=True):
        return (torch.randn(shape, generator=gen) * scale).to(dev).requires_grad_(grad)

    x = t((b, h, w, 64))
    if name == "warp":
        flow = (torch.rand((b, h, w, 2), generator=gen) * 48 - 24).to(dev)
        return KERNELS.flow_warp, PLAIN.flow_warp, [x, flow]
    if name == "input_conv":
        parts = [t((b, h, w, 3)), x, t((b, h, w, 64)), t((b, h, w, 64))]
        kernel = t((3, 3, 3 + 192, 64), 0.03)
        gate = torch.tensor([1.0, 0.0][:b], device=dev)

        def call(op):
            return lambda *a: op(list(a[:4]), kd.part_kernels(a[4], [3, 64, 64, 64], b, gate), a[5])
        return call(KERNELS.input_conv), call(PLAIN.input_conv), [*parts, kernel, t((64,), 0.1)]
    if name == "drt_block":
        par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).float().to(dev)
        return KERNELS.drt_block, PLAIN.drt_block, [
            x, par, t((b, 3, 3, 64, 64), 0.03), t((b, 64), 0.1), t((b, 64)),
            t((64, 3, 64), 0.03), t((3, 3, 64, 64), 0.03), t((64,), 0.1)]
    if name == "conv3x3":
        return KERNELS.conv3x3, PLAIN.conv3x3, [
            x, t((b, 3, 3, 64, 64), 0.03), t((b, 64), 0.1), t((b, 64))]
    return KERNELS.head, PLAIN.head, [
        x, t((3, 3, 64, 64), 0.03), t((64,), 0.1), t((3, 3, 64, 3), 0.06), t((3,), 0.1)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["warp", "input_conv", "drt_block", "head", "conv3x3"])
def test_kernel_function_grads(cuda, shape, name):
    """Through its Function a kernel launches once in the forward and none
    in the backward, and the gradients of every input equal plain
    autograd's."""
    b, h, w = shape
    kern, plain, args = _grad_case(name, torch.Generator().manual_seed(5), b, h, w, cuda)
    wrt = [a for a in args if a.requires_grad]
    reset_launches()
    y = kern(*args)
    grad_out = torch.randn(y.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    got = torch.autograd.grad(y, wrt, grad_out)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    want = torch.autograd.grad(plain(*args), wrt, grad_out)
    _check(y.detach(), plain(*[a.detach() for a in args]), torch.float32)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_model_grads_kernel_path_match_plain_path(cuda):
    """PnPVCVE at the flagship width (2 blocks): one Charbonnier loss through
    the kernels and through the plain path gives every parameter the same
    gradient within 1e-3 of its largest entry; remat relaunches each forward
    kernel once in the backward."""
    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.train.losses import charbonnier_loss

    model = build_generator(
        dict(type="PnPVCVE", mid_channels=64, num_blocks=2, num_experts=3), device=cuda
    )
    rng = np.random.default_rng(7)
    b, t, h, w = 2, 3, 24, 32
    fb = rng.uniform(-12, 12, (b, t, h // 8, w // 8, 4)).astype(np.float32)
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0], [66.0, 80.0, 66.0]], np.float32),
        mvs=np.repeat(np.repeat(fb, 8, axis=2), 8, axis=3),
        base_qps=np.full((b, t), 25 / 255.0, np.float32),
        par_map=((rng.random((b, t, h, w, 3)) > 0.5) / 255.0).astype(np.float32),
    )
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in inputs.items()}
    gt = torch.from_numpy(rng.random((b, t, h, w, 3), np.float32)).to(cuda)
    grads = {}
    for ops in (KERNELS, PLAIN):
        model.ops = ops
        model.zero_grad()
        reset_launches()
        charbonnier_loss(model(**inputs), gt).backward()
        torch.cuda.synchronize()
        if ops is KERNELS:
            counts = dict(LAUNCHES)
        grads[ops is KERNELS] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert counts == {"warp": 4 * t, "warp_block": 0, "input_conv": 4 * t, "drt_block": 8 * t,
                      "drt_block_select": 0, "head": 2 * t, "conv3x3": 0}
    for n, g in grads[True].items():
        ref = grads[False][n]
        assert float((g - ref).abs().max()) <= 1e-3 * float(ref.abs().max()), n


# ---- the probe kernels K6-K10 (kernels/probes.py) --------------------------------------------
# Each against its plain version on the same inputs, at a ragged size and at
# the full shapes of its TPU probe. Bounds: K6, K8 and K10 in int8 and K9
# bitwise (copies, exact int32 sums, the same IEEE division and rounding);
# K8 and K10 in bf16 max|diff| <= 1e-5 max|ref| (float32 sums in another
# order); K7 the bf16 bounds above (its H pass rounds to bf16 a float32 sum
# taken in another order).


def _probe_launches(name):
    from pnp_vcve_torch.kernels import probes

    assert probes.LAUNCHES[name] == 1 and sum(probes.LAUNCHES.values()) == 1


def _bf16(gen, shape, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev, torch.bfloat16)


def _int8(gen, shape, dev):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)


# (src shape, out_h, out_w, y0, x0, period): ragged; k_nodma; probe_floor128
COPY_CASES = [((2, 30, 50, 24), 10, 40, 3, 5, 0), ((1, 64, 320, 64), 64, 256, 16, 32, 8),
              ((1, 760, 672, 128), 720, 640, 16, 16, 0)]


@pytest.mark.parametrize("case", COPY_CASES)
def test_window_copy_kernel(cuda, case):
    from pnp_vcve_torch.kernels import probes

    shape, oh, ow, y0, x0, period = case
    src = _bf16(torch.Generator().manual_seed(20), shape, cuda)
    probes.reset_launches()
    got = probes.window_copy(src, oh, ow, y0, x0, period)
    _probe_launches("window_copy")
    torch.cuda.synchronize()
    assert torch.equal(got, probes.window_copy_plain(src, oh, ow, y0, x0, period))


# (nb, nt, kw, c, dv): ragged (a short depth, 16 channels, 13 V terms); the
# probe's 720p warp
MMSEL_CASES = [(3, 2, 100, 16, 13), (90, 10, 184, 64, 40)]


@pytest.mark.parametrize("case", MMSEL_CASES)
def test_mmsel_warp_kernel(cuda, case):
    """K7, V mode: a dense random S (any depth's products, not only two
    taps) and dense random vm at the ragged size; build_s's S at 720p."""
    from pnp_vcve_torch.kernels import probes

    gen = torch.Generator().manual_seed(21)
    nb, nt, kw, c, dv = case
    xp = _bf16(gen, (1, 8 * (nb - 1) + dv + 7 + 5, 128 * (nt - 1) + kw + 9, c), cuda)
    w = 128 * nt
    if nb == 90:
        m0 = (torch.arange(w) + 32)[None] + torch.randint(-17, 18, (nb, w), generator=gen)
        s = probes.build_s(m0.to(cuda), torch.rand((nb, w), generator=gen).to(cuda),
                           torch.rand((nb, w), generator=gen).to(cuda))
    else:
        s = _bf16(gen, (nb, nt, 128, kw), cuda, 0.1)
    vm = torch.rand((nb, w, dv), generator=gen).to(cuda)
    probes.reset_launches()
    got = probes.mmsel_warp(xp, s, vm)
    _probe_launches("mmsel")
    _check(got, probes.mmsel_warp_plain(xp, s, vm), torch.bfloat16)


@pytest.mark.parametrize("lanes,hw", [(16, (24, 300)), (64, (64, 256)), (128, (64, 256))])
def test_mmsel_h_kernel(cuda, lanes, hw):
    """K7, H mode (k_fori_dot): one dense S for every band, columns past the
    tile zeros."""
    from pnp_vcve_torch.kernels import probes

    gen = torch.Generator().manual_seed(22)
    h, w = hw
    x = _bf16(gen, (1, h + 40, w + 64, lanes), cuda)
    s = _bf16(gen, (1, 1, 128, 184), cuda, 0.1)
    probes.reset_launches()
    got = probes.mmsel_h(x, s, h // 8, 16, w)
    _probe_launches("mmsel")
    assert not got[..., 128:, :].any()
    _check(got, probes.mmsel_h_plain(x, s, h // 8, 16, w), torch.bfloat16)


# (m, k, n): ragged (no multiple of the 128 x 64 block tile); the probe's
MATMUL_CASES = [(48, 96, 24), (4096, 128, 128)]


@pytest.mark.parametrize("form", ["bf16", "int8", "int8_scaled"])
@pytest.mark.parametrize("case", MATMUL_CASES)
def test_matmul_kernel(cuda, case, form):
    from pnp_vcve_torch.kernels import probes

    gen = torch.Generator().manual_seed(23)
    m, k, n = case
    if form == "bf16":
        a, b, scale = _bf16(gen, (m, k), cuda), _bf16(gen, (k, n), cuda), None
    else:
        a, b = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
        scale = torch.tensor([0.0123], device=cuda) if form == "int8_scaled" else None
    probes.reset_launches()
    got = probes.matmul(a, b, scale)
    _probe_launches("matmul" if form == "bf16" else "matmul_int8")
    ref = probes.matmul_plain(a, b, scale)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if form == "bf16":
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", [(37, 8), (4096, 128), (24, 656, 128)])
def test_absmax_quantize_kernel(cuda, shape):
    """K9: q and s bitwise, on normal values and on values on the rounding
    ties of x / s."""
    from pnp_vcve_torch.kernels import probes

    gen = torch.Generator().manual_seed(24)
    for x in (_bf16(gen, shape, cuda), (torch.randint(-254, 255, shape, generator=gen) / 2.0)
              .to(cuda, torch.bfloat16)):
        probes.reset_launches()
        q, s = probes.absmax_quantize(x)
        _probe_launches("absmax_quantize")
        q_ref, s_ref = probes.absmax_quantize_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(s, s_ref) and torch.equal(q, q_ref)


# (band, rows, cols, cout): ragged (no multiple of the 16 x 16 tile, a
# narrow output group); the probe's; K5's 720p geometry, 64 -> 64
TAPCONV_CASES = [((9, 23, 64), 5, 19, 24), ((24, 656, 128), 16, 320, 128),
                 ((722, 1282, 64), 720, 1280, 64)]


@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("case", TAPCONV_CASES)
def test_tapconv_kernel(cuda, case, form):
    from pnp_vcve_torch.kernels import probes

    gen = torch.Generator().manual_seed(25)
    band_shape, rows, cols, cout = case
    cin = band_shape[2]
    if form == "bf16":
        band, w, scale = (_bf16(gen, band_shape, cuda), _bf16(gen, (3, 3, cin, cout), cuda, 0.05),
                          None)
    else:
        band, w = _int8(gen, band_shape, cuda), _int8(gen, (3, 3, cin, cout), cuda)
        scale = torch.tensor([0.0123], device=cuda)
    probes.reset_launches()
    got = probes.tapconv(band, w, rows, cols, scale)
    _probe_launches("tapconv" if form == "bf16" else "tapconv_int8")
    ref = probes.tapconv_plain(band, w, rows, cols, scale)
    torch.cuda.synchronize()
    if form == "bf16":
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert torch.equal(got, ref)


def test_probe_kernels_refuse_what_they_cannot_take(cuda):
    """Each wrapper raises on a dtype, a shape or a layout its kernel does
    not take (it never runs the plain version on a CUDA tensor)."""
    from pnp_vcve_torch.kernels import probes

    a = torch.zeros((32, 48), dtype=torch.int8, device=cuda)  # k % 32 != 0
    with pytest.raises(ValueError, match="matmul"):
        probes.matmul(a, torch.zeros((48, 16), dtype=torch.int8, device=cuda))
    with pytest.raises(TypeError, match="matmul"):
        probes.matmul(a.float(), torch.zeros((48, 16), device=cuda))
    band = torch.zeros((6, 20, 16), dtype=torch.int8, device=cuda)  # cin % 32 != 0
    with pytest.raises(ValueError, match="tapconv"):
        probes.tapconv(band, torch.zeros((3, 3, 16, 16), dtype=torch.int8, device=cuda), 4, 18,
                       torch.ones(1, device=cuda))
    x = torch.zeros((1, 40, 64, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        probes.window_copy(x.transpose(1, 2), 8, 8, 0, 0)
    with pytest.raises(TypeError, match="absmax_quantize"):
        probes.absmax_quantize(torch.zeros(16, device=cuda))


# ---- every width: K1, K1b, K2, K3, K3s and K4 at c != 64 ---------------------------------------

WIDTHS = [8, 24, 128]  # one narrow group; a group of 24; two full groups (one block an SM)


def _width_case(name, c, dtype, gen, dev):
    """(kernel call, plain call in float32 on the same values, bf16 bounds)
    for model kernel ``name`` at width ``c`` on a ragged frame."""
    b, h, w = (2, 40, 56) if name == "warp_block" else SHAPES[0]
    x = _feat(gen, (b, h, w, c), dtype, dev)
    if name in ("warp", "warp_block"):
        fb = torch.rand((b, -(-h // 8), -(-w // 8), 2), generator=gen) * 48 - 24
        flow = fb.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w].to(dev, dtype)
        if name == "warp":
            return (lambda: KERNELS.flow_warp(x, flow),
                    lambda: PLAIN.flow_warp(x.float(), flow.float()), (0.08, 0.01))
        return (lambda: KERNELS.flow_warp_block(x, flow, 16.0),
                lambda: PLAIN.flow_warp_block(x.float(), flow.float(), 16.0), (0.08, 0.01))
    if name.startswith("input_conv"):
        n_parts = int(name[-1])
        parts = [_feat(gen, (b, h, w, 3), dtype, dev)] + [x] + [
            _feat(gen, (b, h, w, c), dtype, dev) for _ in range(n_parts - 2)]
        kernel = _w(gen, (3, 3, 3 + c * (n_parts - 1), c), dev, 0.24 / c ** 0.5)
        bias = _w(gen, (c,), dev, 0.1)
        ks = kd.part_kernels(kernel, [p.shape[-1] for p in parts], b,
                             torch.tensor([1.0, 0.0], device=dev))
        return (lambda: KERNELS.input_conv(parts, ks, bias),
                lambda: PLAIN.input_conv([p.float() for p in parts], ks, bias), (0.04, 0.002))
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).to(dev, dtype)
    s = 0.24 / c ** 0.5  # 0.03 at c = 64
    blk = (_w(gen, (b, 3, 3, c, c), dev, s), _w(gen, (b, c), dev, 0.1),
           torch.rand((b, c), generator=gen).to(dev), _w(gen, (c, 3, c), dev, s),
           _w(gen, (3, 3, c, c), dev, s), _w(gen, (c,), dev, 0.1))
    if name == "drt_block":
        return (lambda: KERNELS.drt_block(x, par, *blk),
                lambda: PLAIN.drt_block(x.float(), par.float(), *blk), (0.02, 0.002))
    hd = (_w(gen, (3, 3, c, c), dev, s), _w(gen, (c,), dev, 0.1),
          _w(gen, (3, 3, c, 3), dev, 2 * s), _w(gen, (3,), dev, 0.1))
    return (lambda: KERNELS.head(x, *hd), lambda: PLAIN.head(x.float(), *hd), (0.02, 0.002))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("name", ["warp", "warp_block", "input_conv3", "input_conv4", "drt_block",
                                  "head"])
def test_model_kernels_at_width(cuda, name, c, dtype):
    """Each model kernel at a width other than 64 against its plain version,
    under the bounds of its 64-channel test; one launch each."""
    kern, plain, bounds = _width_case(name, c, dtype, torch.Generator().manual_seed(30 + c), cuda)
    reset_launches()
    got = kern()
    assert sum(LAUNCHES.values()) == 1
    _check(got, plain(), dtype, *bounds)


def test_model_kernels_refuse_a_width_they_cannot_take(cuda):
    """A width that is not a multiple of 8 raises before any launch; a wide
    one does not (K4 at 256 runs its two-launch form)."""
    z = lambda *s: torch.zeros(s, device=cuda)  # noqa: E731
    x = z(1, 8, 8, 12)
    calls = {
        "warp": lambda: KERNELS.flow_warp(x, z(1, 8, 8, 2)),
        "input_conv": lambda: KERNELS.input_conv(
            [z(1, 8, 8, 3), x], [z(1, 3, 3, 3, 12), z(1, 3, 3, 12, 12)], z(12)),
        "drt_block": lambda: KERNELS.drt_block(x, z(1, 8, 8, 3), z(1, 3, 3, 12, 12), z(1, 12),
                                               z(1, 12), z(12, 3, 12), z(3, 3, 12, 12), z(12)),
        "head": lambda: KERNELS.head(x, z(3, 3, 12, 12), z(12), z(3, 3, 12, 3), z(3)),
    }
    reset_launches()
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: width 12 is not a multiple of 8"):
            call()
    assert sum(LAUNCHES.values()) == 0
    out = KERNELS.head(z(1, 8, 8, 256), z(3, 3, 256, 256), z(256), z(3, 3, 256, 3), z(3))
    torch.cuda.synchronize()
    assert out.shape == (1, 8, 8, 3) and LAUNCHES["head"] == 1


@pytest.mark.parametrize("warp_impl", ["padgather", "block8"])
@pytest.mark.parametrize("c", [8, 128])
def test_model_kernel_path_at_width(cuda, c, warp_impl):
    """PnPVCVE at mid_channels 8 and 128 (2 blocks, 2 experts), kernel path
    against plain path within 3e-3; every step through the kernels."""
    from pnp_vcve_torch.core.builder import build_generator

    torch.manual_seed(c)
    model = build_generator(dict(type="PnPVCVE", mid_channels=c, num_blocks=2, num_experts=2,
                                 use_pallas_kernels=True, warp_impl=warp_impl), device=cuda)
    rng = np.random.default_rng(c)
    b, t, h, w = 1, 4, 40, 56
    fb = rng.uniform(-20, 20, (b, t, h // 8, w // 8, 4)).astype(np.float32)
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), np.float32), qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0, 66.0]], np.float32),
        mvs=np.repeat(np.repeat(fb, 8, axis=2), 8, axis=3),
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=((rng.random((b, t, h, w, 3)) > 0.5) / 255.0).astype(np.float32))
    inputs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda) for k, v in inputs.items()}
    with torch.inference_mode():
        reset_launches()
        got = model(**inputs)
        counts = dict(LAUNCHES)
        model.ops = PLAIN
        want = model(**inputs)
    k1 = "warp" if warp_impl == "padgather" else "warp_block"
    assert counts == {"warp": 0, "warp_block": 0, **{k1: 2 * t}, "input_conv": 2 * t,
                      "drt_block": 2 * 2 * t, "drt_block_select": 0, "head": t, "conv3x3": 0}
    assert float((got - want).abs().max()) <= 3e-3


# ---- K11-K13: the probes that move data ----------------------------------------------------------


# (nb, w, c): ragged (24 channels, a width off the 128 tile); the probe's 720p
GATHER_CASES = [(3, 200, 24), (90, 1280, 64)]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_gather2_kernel(cuda, case):
    """K11 bitwise to its plain version (the same fused multiply-adds), on
    shifts inside the TPU's 35 and a few past both ends."""
    from pnp_vcve_torch.kernels import probes

    nb, w, c = case
    gen = torch.Generator().manual_seed(40)
    xp = _bf16(gen, (1, 8 * nb + 40, w + 64, c), cuda)
    shidx = torch.randint(-2, 37, (nb, w), generator=gen, dtype=torch.int32).to(cuda)
    dyidx = torch.randint(-2, 37, (nb, w), generator=gen, dtype=torch.int32).to(cuda)
    wts = [torch.rand((nb, w), generator=gen).to(cuda) for _ in range(4)]
    probes.reset_launches()
    got = probes.gather2(xp, shidx, wts[0], wts[1], dyidx, wts[2], wts[3])
    _probe_launches("gather2")
    torch.cuda.synchronize()
    want = probes.gather2_plain(xp, shidx, wts[0], wts[1], dyidx, wts[2], wts[3])
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (hp, wp, h, w, c): ragged; the probe's 720p
BLOCK_WINDOW_CASES = [(50, 90, 24, 40, 16), (760, 1344, 720, 1280, 64)]


@pytest.mark.parametrize("case", BLOCK_WINDOW_CASES)
def test_block_windows_kernel(cuda, case):
    """K12 bitwise to its plain version, block-major, some windows clamped."""
    from pnp_vcve_torch.kernels import probes

    hp, wp, h, w, c = case
    gen = torch.Generator().manual_seed(41)
    xp = _bf16(gen, (1, hp, wp, c), cuda)
    n = (h // 8) * (w // 8)
    sy = torch.randint(-4, hp - 5, (n,), generator=gen, dtype=torch.int32).to(cuda)
    sx = torch.randint(-12, wp - 4, (n,), generator=gen, dtype=torch.int32).to(cuda)
    probes.reset_launches()
    got = probes.block_windows(xp, sy, sx, h, w)
    _probe_launches("block_windows")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16),
                       probes.block_windows_plain(xp, sy, sx, h, w).view(torch.int16))


# (hp, wp, lanes): ragged (a last strip of 2 pixels, 24 lanes); the probe's PF array
RING_CASES = [(40, 22, 24), (736, 656, 128)]


@pytest.mark.parametrize("depth", [0, 3, 9])
@pytest.mark.parametrize("write_out", [False, True])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("case", RING_CASES)
def test_ring_copy_kernel(cuda, case, split, write_out, depth):
    """K13's ring: the identity, or the last chunk's first row, bitwise."""
    from pnp_vcve_torch.kernels import probes

    z = _bf16(torch.Generator().manual_seed(42), (1, *case), cuda)
    probes.reset_launches()
    got = probes.ring_copy(z, split, write_out, depth)
    _probe_launches("ring_copy")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), probes.ring_copy_plain(z, write_out).view(torch.int16))


@pytest.mark.parametrize("write_out", [False, True])
@pytest.mark.parametrize("case", RING_CASES)
def test_stream_copy_kernel(cuda, case, write_out):
    """K13's streamed copy, bitwise."""
    from pnp_vcve_torch.kernels import probes

    z = _bf16(torch.Generator().manual_seed(43), (1, *case), cuda)
    probes.reset_launches()
    got = probes.stream_copy(z, write_out)
    _probe_launches("stream_copy")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), probes.ring_copy_plain(z, write_out).view(torch.int16))
