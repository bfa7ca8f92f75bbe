"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:
``python -m pytest -m cuda --noconftest tests/test_torch_port_kernels.py``
(``--noconftest``: ``tests/conftest.py`` sets JAX up for the CPU tests, and
these tests do not need JAX). Elsewhere
every test skips (the card is looked for inside the ``cuda`` fixture, never
at import, so all workers collect the same tests).

Each kernel runs in float32 and in bfloat16 on the same values as its plain
version, which runs in float32 with TF32 off. Bounds: float32
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
    assert counts == {"warp": 2 * t, "input_conv": 2 * t, "drt_block": 2 * 2 * t, "head": t}
    assert got.shape == (b, t, h, w, 3)
    assert float((got - want).abs().max()) <= 3e-3
