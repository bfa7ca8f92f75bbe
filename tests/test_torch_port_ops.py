"""The port's ops and its kernels' plain PyTorch versions against the JAX
package, on the CPU in float32 (atol 1e-5: float32 rounding of sums taken in
another order).

The JAX reference of each kernel is its XLA composition, which the JAX
package's own tests pin to the Pallas kernels in interpret mode
(tests/test_kernels.py, tests/test_warp_pf.py). Inputs come from numpy
generators and go as numpy to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.kernels import build as kbuild
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import warp as kw
from pnp_vcve_torch.ops import dynamic_conv as tdc
from pnp_vcve_torch.ops import warp as twarp

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_flow_warp_per_pixel_matches_padgather(rng):
    """Random per-pixel flows reaching past the border."""
    from pnp_vcve_tpu.ops.warp import flow_warp as jwarp

    x = rng.standard_normal((2, 13, 21, 64)).astype(np.float32)
    flow = rng.uniform(-8.0, 8.0, (2, 13, 21, 2)).astype(np.float32)
    flow[0, 0, 0] = (-0.5, -0.25)  # floor of negative fractions
    want = jwarp(jnp.asarray(x), jnp.asarray(flow), impl="padgather")
    _close(twarp.flow_warp(_t(x), _t(flow)), want)
    _close(kw.flow_warp(_t(x), _t(flow)), want)


@pytest.mark.parametrize("reach", [16.0, 40.0])
def test_flow_warp_block_constant_matches_block8(rng, reach):
    """8x8-block-constant flows, within the TPU kernel's +-16 px and beyond:
    the per-pixel warp (K1's plain version) equals JAX block8."""
    from pnp_vcve_tpu.ops.warp import flow_warp as jwarp

    b, h, w = 2, 32, 48
    x = rng.standard_normal((b, h, w, 64)).astype(np.float32)
    fb = rng.uniform(-reach, reach, (b, h // 8, w // 8, 2)).astype(np.float32)
    flow = np.repeat(np.repeat(fb, 8, axis=1), 8, axis=2)
    want = jwarp(jnp.asarray(x), jnp.asarray(flow), impl="block8")
    _close(kw.flow_warp_plain(_t(x), _t(flow)), want)
    _close(twarp.flow_warp(_t(x), _t(flow), impl="block8"), want)


def test_dynamic_conv_ops_match_jax(rng):
    from pnp_vcve_tpu.ops import dynamic_conv as jdc

    b, h, w, c, k = 2, 9, 11, 8, 3
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wts = rng.random((b, k)).astype(np.float32)
    bank = rng.standard_normal((k, 3, 3, c, c)).astype(np.float32)
    bias_bank = rng.standard_normal((k, c)).astype(np.float32)
    gamma = rng.random((b, c)).astype(np.float32)
    kern = rng.standard_normal((3, 3, c, 5)).astype(np.float32)
    kb = rng.standard_normal((5,)).astype(np.float32)

    jk, jb = jdc.mix_expert_kernels(jnp.asarray(wts), jnp.asarray(bank), jnp.asarray(bias_bank))
    tk, tb = tdc.mix_expert_kernels(_t(wts), _t(bank), _t(bias_bank))
    _close(tk, jk)
    _close(tb, jb)
    _close(
        tdc.dynamic_conv2d(_t(x), tk, tb, gamma=_t(gamma)),
        jdc.dynamic_conv2d(jnp.asarray(x), jk, jb, gamma=jnp.asarray(gamma)),
    )
    _close(
        tdc.conv2d_nhwc(_t(x), _t(kern), _t(kb)),
        jdc.conv2d_nhwc(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(kb)),
    )


@pytest.mark.parametrize("n_parts", [3, 4])
@pytest.mark.parametrize("gate", [None, (0.0, 0.0), (1.0, 1.0), (0.0, 1.0)])
def test_input_conv_plain_matches_xla_compose(rng, n_parts, gate):
    """K2's plain version, with the align_key select folded into kernel
    gains, against JAX ``_xla_input_stack_compose``'s select (3-part
    backward and 4-part forward forms)."""
    from pnp_vcve_tpu.kernels.drt_stack import _xla_input_stack_compose

    b, h, w, c = 2, 12, 20, 64
    parts = [rng.standard_normal((b, h, w, 3)).astype(np.float32)] + [
        rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(n_parts - 1)
    ]
    cin = 3 + c * (n_parts - 1)
    kernel = (rng.standard_normal((3, 3, cin, c)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    g = None if gate is None else np.asarray(gate, np.float32)

    want = _xla_input_stack_compose(
        tuple(jnp.asarray(p) for p in parts), jnp.asarray(kernel), jnp.asarray(bias),
        None, [], align_gate=None if g is None else jnp.asarray(g),
    )
    ks = kd.part_kernels(_t(kernel), [p.shape[-1] for p in parts], b,
                         None if g is None else _t(g))
    _close(kd.input_conv_plain([_t(p) for p in parts], ks, _t(bias)), want)
    _close(kd.input_conv([_t(p) for p in parts], ks, _t(bias)), want)


def _block_params(rng, b, c):
    # weights at the scale of the reference init (kaiming, fan_in 576)
    f = lambda *s, k=0.03: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    return dict(
        dyn_kernels=f(b, 3, 3, c, c), dyn_biases=f(b, c),
        gamma=rng.random((b, c)).astype(np.float32),
        par_kernel=f(c, 3, c), conv1_kernel=f(3, 3, c, c), conv1_bias=f(c),
    )


def test_drt_block_chain_matches_xla_compose(rng):
    """K3's plain version chained over 2 blocks against ``_xla_block_compose``."""
    from pnp_vcve_tpu.kernels.drt_stack import _xla_block_compose

    b, h, w, c = 2, 12, 20, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    par = ((rng.random((b, h, w, 3)) > 0.5) / 255.0).astype(np.float32)
    blocks = [_block_params(rng, b, c) for _ in range(2)]
    want = _xla_block_compose(
        jnp.asarray(x), jnp.asarray(par),
        [{k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks],
    )
    for fn in (kd.drt_block_plain, kd.drt_block):
        y = _t(x)
        for blk in blocks:
            y = fn(y, _t(par), _t(blk["dyn_kernels"]), _t(blk["dyn_biases"]), _t(blk["gamma"]),
                   _t(blk["par_kernel"]), _t(blk["conv1_kernel"]), _t(blk["conv1_bias"]))
        _close(y, want)


def test_head_matches_xla_head(rng):
    from pnp_vcve_tpu.kernels.drt_stack import _xla_head

    b, h, w, c = 2, 12, 20, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    head = [
        (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32),
        rng.standard_normal((c,)).astype(np.float32),
        (rng.standard_normal((3, 3, c, 3)) * 0.05).astype(np.float32),
        rng.standard_normal((3,)).astype(np.float32),
    ]
    want = _xla_head(jnp.asarray(x), tuple(jnp.asarray(a) for a in head))
    _close(kd.head_plain(_t(x), *map(_t, head)), want)
    _close(kd.head(_t(x), *map(_t, head)), want)


def test_premix_matches_mix_expert_kernels(rng):
    """The hoisted premix equals per-frame expert mixing (bank given in the
    reference layout (K, out, in, 3, 3))."""
    from pnp_vcve_tpu.ops.dynamic_conv import mix_expert_kernels

    t, b, k, c = 3, 2, 6, 8
    wts = rng.random((t, b, k)).astype(np.float32)
    gam = rng.random((t, b, c)).astype(np.float32)
    bank = rng.standard_normal((k, c, c, 3, 3)).astype(np.float32)
    bias_bank = rng.standard_normal((k, c)).astype(np.float32)
    pm = kd.premix_block_params(_t(wts), _t(gam), _t(bank), _t(bias_bank))
    for i in range(t):
        jk, jb = mix_expert_kernels(
            jnp.asarray(wts[i]), jnp.asarray(bank.transpose(0, 3, 4, 2, 1)),
            jnp.asarray(bias_bank),
        )
        _close(pm["w2"][i], jk)
        _close(pm["b2"][i], jb)
    _close(pm["g"], gam)


def test_keyframe_indices_match_jax(rng):
    from pnp_vcve_tpu.models.pnp_vcve import keyframe_indices as jkf
    from pnp_vcve_torch.models.pnp_vcve import keyframe_indices as tkf

    slices = rng.choice(np.array([73.0, 80.0, 66.0], np.float32), size=(3, 9))
    for got, want in zip(tkf(_t(slices)), jkf(jnp.asarray(slices))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_plain_path_on_cpu_only(rng):
    """CPU tensors run the plain versions and launch nothing; a device with
    no kernel is refused rather than served by a fallback."""
    K.reset_launches()
    x = _t(rng.standard_normal((1, 8, 8, 64)))
    flow = _t(rng.standard_normal((1, 8, 8, 2)))
    _close(K.KERNELS.flow_warp(x, flow), K.PLAIN.flow_warp(x, flow))
    assert all(v == 0 for v in K.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no kernel"):
        K.KERNELS.flow_warp(x.to("meta"), flow.to("meta"))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build fails loudly; it never falls back."""
    monkeypatch.setattr(kbuild, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kbuild, "nvcc_path", lambda: None)
    kbuild.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kbuild.library()
    finally:
        kbuild.library.cache_clear()
    assert list(tmp_path.iterdir()) == []
