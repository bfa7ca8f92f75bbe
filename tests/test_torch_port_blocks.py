"""The per-block TPU kernels B8 and B9 and the DRT block forms they carry,
the port against the JAX package, on the CPU in float32 (the port runs its
kernels' plain versions here).

- K5's wrapper (``kernels/conv_block.py: conv3x3``) against JAX
  ``conv3x3_pallas``, ``conv3x3_packed`` and ``conv3x3_packed_v2``;
- K3's wrapper (``kernels/drt_stack.py: drt_block``, arguments reordered)
  against JAX ``drt_block_pallas`` and ``drt_block_packed``;
- the port's ``DRTBlock`` in every form against JAX ``DRTBlock`` with
  ``use_pallas=True, pallas_th=8`` at sizes its kernel guard admits, so that
  JAX runs ``drt_block_packed`` for the fused forms;
- the model variants blocktype='drt_woqp', one_layer=False and
  channel_first=False against JAX ``PnPVCVE`` (weights in JAX's layouts,
  carried across by ``from_jax_params``), their gradients, and their launch
  counts through the wrappers' Functions.

The JAX Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them. Inputs come from numpy generators. Tolerances are those of the JAX
package's own tests: 2e-5 for the 3x3 conv and 3e-5 for the DRT block
(tests/test_kernels.py:39, :78), 1e-4 for a model forward and atol 2e-4 /
rtol 1e-3 for gradients (:356).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
from pnp_vcve_tpu.models.bae import DRTBlock as JaxDRTBlock
from pnp_vcve_tpu.models.bae import (
    ResidualBlocksWithInputConvDynamicDRT as JaxResBlocks,
)
from pnp_vcve_tpu.ops.dynamic_conv import dynamic_conv2d as jax_dynamic_conv2d
from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.core.convert import block_state_dict, from_jax_params
from pnp_vcve_torch.kernels import conv_block as kc
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import warp as kw
from pnp_vcve_torch.models.bae import DRTBlock, ResidualBlocksWithInputConvDynamicDRT

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

B, H, W, C = 2, 32, 48, 8  # tests/test_kernels.py:12


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _r(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_params(module, seed, *args, scale=0.05, **kwargs):
    """A JAX module's param tree at the shapes its init gives
    (``jax.eval_shape``: traced, not run), filled from a numpy generator;
    an eager flax init of the scanned model costs ~20 s on the CPU."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return jax.tree_util.tree_map(lambda s: _r(rng, *s.shape, scale=scale), shapes)["params"]


# ---- B9: the per-sample 3x3 conv ------------------------------------------------------


def _jax_conv(name):
    from pnp_vcve_tpu.kernels import conv3x3_pallas
    from pnp_vcve_tpu.kernels.conv_packed import conv3x3_packed, conv3x3_packed_v2

    fns = {"conv3x3_pallas": conv3x3_pallas, "conv3x3_packed": conv3x3_packed,
           "conv3x3_packed_v2": conv3x3_packed_v2}
    if name in fns:
        return lambda x, k, b, g: fns[name](x, k, b, th=8)
    # the gain K5's wrapper folds in: JAX dynamic_conv2d(..., gamma=), gain after bias
    return lambda x, k, b, g: jax_dynamic_conv2d(x, k, b, gamma=g)


# c_in != c_out only for conv3x3_pallas: the packed forms need c_in == c_out
@pytest.mark.parametrize("name,c_out", [
    ("conv3x3_pallas", C), ("conv3x3_pallas", 2 * C), ("conv3x3_packed", C),
    ("conv3x3_packed_v2", C), ("dynamic_conv2d_gamma", C),
])
def test_conv3x3_matches_jax(name, c_out):
    """K5's wrapper equals the three TPU layouts of the per-sample conv and
    the gain-after-bias form it serves in the blocks."""
    rng = np.random.default_rng(0)
    x, k = _r(rng, B, H, W, C), _r(rng, B, 3, 3, C, c_out, scale=0.1)
    bias, g = _r(rng, B, c_out, scale=0.1), rng.random((B, c_out)).astype(np.float32)
    gain = g if name == "dynamic_conv2d_gamma" else None
    want = np.asarray(_jax_conv(name)(*map(jnp.asarray, (x, k, bias)),
                                      None if gain is None else jnp.asarray(gain)))
    got = K.KERNELS.conv3x3(_t(x), _t(k), _t(bias), None if gain is None else _t(gain))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_conv3x3_function_grads():
    """Conv3x3Function, with the plain version standing in for the launch,
    gives plain autograd's gradients for the input, kernels, biases and gain."""
    gen = torch.Generator().manual_seed(0)

    def t(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).requires_grad_(True)

    args = [t(2, 6, 10, C), t(2, 3, 3, C, 16, scale=0.1), t(2, 16, scale=0.1), t(2, 16)]
    g_out = torch.randn((2, 6, 10, 16), generator=gen)
    got = torch.autograd.grad(kc.Conv3x3Function.apply(kc.conv3x3_plain, *args), args, g_out)
    for g, want in zip(got, torch.autograd.grad(kc.conv3x3_plain(*args), args, g_out)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


# ---- B8, B9: the DRT block on K3 -------------------------------------------------------


@pytest.mark.parametrize("name,shape", [
    ("drt_block_pallas", (B, H, W)), ("drt_block_pallas", (1, 24, 16)),  # band edges 7/8, 15/16
    ("drt_block_packed", (B, H, W)), ("drt_block_packed", (1, 24, 20)),  # and image borders
])
def test_drt_block_matches_jax(name, shape):
    """K3's wrapper, given the JAX signature's arguments reordered, equals
    ``drt_block_pallas`` and ``drt_block_packed`` (th=8), including the
    band-boundary cases of tests/test_kernels.py:81-100 and :163-178."""
    from pnp_vcve_tpu.kernels import drt_block_pallas
    from pnp_vcve_tpu.kernels.drt_packed import drt_block_packed

    rng = np.random.default_rng(1)
    b, h, w = shape
    x = _r(rng, b, h, w, C)
    par = rng.random((b, h, w, 3)).astype(np.float32)
    dyn_k, dyn_b = _r(rng, b, 3, 3, C, C, scale=0.1), _r(rng, b, C, scale=0.1)
    par_k, c1_k = _r(rng, C, 3, C, scale=0.1), _r(rng, 3, 3, C, C, scale=0.1)
    c1_b, gamma = _r(rng, C, scale=0.1), rng.random((b, C)).astype(np.float32)
    fn = drt_block_pallas if name == "drt_block_pallas" else drt_block_packed
    want = np.asarray(fn(*map(jnp.asarray, (x, par, dyn_k, dyn_b, par_k, c1_k, c1_b, gamma)),
                         th=8))
    got = K.KERNELS.drt_block(*map(_t, (x, par, dyn_k, dyn_b, gamma, par_k, c1_k, c1_b)))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


# ---- the block forms -------------------------------------------------------------------

FORMS = {
    "drt": dict(),
    "drt_woqp": dict(use_dynamic=False),
    "one_layer_false": dict(one_layer=False),
    "channel_first_false": dict(channel_first=False),
    "res_scale": dict(res_scale=0.5),
    "no_se": dict(with_se=False, one_layer=False),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_drt_block_forms_match_jax(form):
    """The port's DRTBlock, in JAX's call form (it mixes its own experts),
    against JAX DRTBlock(use_pallas=True, pallas_th=8) at 16x24, which the
    kernel guard admits: the fused forms run drt_block_packed in JAX and K3
    in the port, the others XLA ops and K5."""
    rng = np.random.default_rng(2)
    b, h, w, e = 2, 16, 24, 3
    x = _r(rng, b, h, w, C)
    par = (np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, h, w))] / 255.0 * 50)
    weights = np.asarray(jax.nn.softmax(jnp.asarray(_r(rng, b, e))))
    gamma = rng.random((b, C)).astype(np.float32)
    jb = JaxDRTBlock(mid_channels=C, num_experts=e, use_pallas=True, pallas_th=8, **FORMS[form])
    args = tuple(map(jnp.asarray, (x, par, weights, gamma)))
    params = _jax_params(jb, 3, *args, scale=0.1)
    want = np.asarray(jb.apply({"params": params}, *args))
    blk = DRTBlock(C, e, **FORMS[form])
    blk.load_state_dict(block_state_dict(params), strict=True)
    with torch.inference_mode():
        got = blk(*map(_t, (x, par, weights, gamma))).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("form", ["drt", "one_layer_false"])
def test_single_tensor_input_form_matches_jax(form):
    """ResidualBlocksWithInputConvDynamicDRT on one (b, h, w, c_in) tensor
    (JAX bae.py:422-423; the input conv runs through K5 with 19 input
    channels, no multiple of 8) against JAX's module, premixed per block."""
    rng = np.random.default_rng(4)
    b, h, w, e, cin = 2, 12, 20, 2, 19
    x, par = _r(rng, b, h, w, cin), rng.random((b, h, w, 3)).astype(np.float32)
    weights = np.asarray(jax.nn.softmax(jnp.asarray(_r(rng, b, e))))
    gamma = rng.random((b, C)).astype(np.float32)
    kw_ = dict(one_layer=False) if form == "one_layer_false" else {}
    jm = JaxResBlocks(in_channels=cin, out_channels=C, num_blocks=2, num_experts=e, **kw_)
    args = tuple(map(jnp.asarray, (x, par, weights, gamma)))
    p = _jax_params(jm, 5, *args, scale=0.1)
    want = np.asarray(jm.apply({"params": p}, *args))
    sd = {"input_conv.0.weight": _t(np.transpose(np.asarray(p["input_conv_kernel"]), (3, 2, 0, 1))),
          "input_conv.0.bias": _t(p["input_conv_bias"])}
    for i in range(2):
        sd.update({f"main.{i}.{k}": v for k, v in block_state_dict(p[f"block{i}"]).items()})
    rb = ResidualBlocksWithInputConvDynamicDRT(cin, C, 2, e, **kw_)
    rb.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = rb(_t(x), _t(par), rb.premix(_t(weights), _t(gamma)), K.KERNELS).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


# ---- the model variants --------------------------------------------------------------------

SMALL = dict(mid_channels=C, num_blocks=2, num_experts=2)
VARIANTS = {
    "drt_woqp": dict(blocktype="drt_woqp"),
    "one_layer_false": dict(one_layer=False),
    "channel_first_false": dict(channel_first=False),
}


def _inputs(rng, b=2, t=3, h=16, w=16):
    return dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73, 66, 80, 66][:t], [66, 80, 66, 66][:t]], np.float32)[:b],
        mvs=rng.uniform(-6.0, 6.0, (b, t, h, w, 4)).astype(np.float32),
        base_qps=np.full((b, t), 25 / 255.0, np.float32),
        par_map=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h, w))] / 255.0,
    )


_JAX_CACHE = {}


def _jax_variant(variant):
    """JAX PnPVCVE (remat off, XLA path) of a variant, its params in JAX's
    layouts, and a jitted apply."""
    if variant not in _JAX_CACHE:
        jm = JaxPnPVCVE(**SMALL, **VARIANTS[variant], remat=False)
        inp = {k: jnp.asarray(v) for k, v in _inputs(np.random.default_rng(0)).items()}
        params = _jax_params(jm, 7, **inp)
        _JAX_CACHE[variant] = jm, params, jax.jit(lambda p, x: jm.apply({"params": p}, **x))
    return _JAX_CACHE[variant]


def _port_variant(variant, params, **kw):
    model = build_generator(dict(type="PnPVCVE", **SMALL, **VARIANTS[variant], **kw), device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_variant_matches_jax(variant):
    """build_generator takes each variant, from_jax_params carries JAX's
    weights across (strict), and the forward equals JAX's within 1e-4; where
    the JAX converter reads the variant back (conv1 banks), the weights
    round-trip bit for bit."""
    jm, params, apply = _jax_variant(variant)
    model = _port_variant(variant, params, remat=False)
    inp = _inputs(np.random.default_rng(8))
    want = np.asarray(apply(params, {k: jnp.asarray(v) for k, v in inp.items()}))
    with torch.inference_mode():
        got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if variant != "drt_woqp":  # the JAX converter reads conv2 as a bank only
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        back = dict(jax.tree_util.tree_leaves_with_path(
            convert_generator_state_dict(sd, num_blocks=SMALL["num_blocks"])))
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            np.testing.assert_array_equal(back[path], leaf)
    else:
        blk = params["backward"]["resblocks"]["block0"]
        np.testing.assert_array_equal(
            model.backward_resblocks.main[0].conv2.weight.detach().numpy(),
            np.transpose(np.asarray(blk["conv2_kernel"]), (3, 2, 0, 1)))


def test_one_layer_false_grads_match_jax():
    """Every parameter's gradient of one Charbonnier loss equals jax.grad's
    (atol 2e-4, rtol 1e-3) for one_layer=False, with the step recompute."""
    from pnp_vcve_tpu.train.losses import charbonnier_loss as jax_loss
    from pnp_vcve_torch.train.losses import charbonnier_loss

    jm, params, _ = _jax_variant("one_layer_false")
    rng = np.random.default_rng(9)
    inp, gt = _inputs(rng), rng.random((2, 3, 16, 16, 3), np.float32)
    grads = jax.jit(jax.grad(lambda p: jax_loss(
        jm.apply({"params": p}, **{k: jnp.asarray(v) for k, v in inp.items()}), jnp.asarray(gt))
    ))(params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    model = _port_variant("one_layer_false", params, remat=True)
    charbonnier_loss(model(**{k: _t(v) for k, v in inp.items()}), _t(gt)).backward()
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


def _launches_per_pass(variant, t, n):
    """Launches of one forward over t frames with n blocks (JAX's fused
    forms on K3, the others on K5: two 3x3 convs per block)."""
    fused = variant == "drt_woqp"
    return {"warp": 2 * t, "warp_block": 0, "input_conv": 2 * t,
            "drt_block": 2 * n * t if fused else 0, "drt_block_select": 0, "head": t,
            "conv3x3": 0 if fused else 4 * n * t}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_through_kernel_wrappers(monkeypatch, variant):
    """Each variant with every wrapper routed through its Function (the plain
    versions standing in for the launches): the launch counts per pass are
    the chip's (drt_woqp: K1 2t, K2 2t, K3 2Nt, K4 t; the others: K1 2t,
    K2 2t, K5 4Nt, K4 t; twice with remat's recompute in the backward), and
    the output and every gradient equal the plain path's."""
    counts = dict.fromkeys(K.LAUNCHES, 0)

    def stand_in(name, plain):
        def run(*a):
            counts[name] += 1
            return plain(*a)
        return run

    for mod in (kw, kd, kc):
        monkeypatch.setattr(mod, "on_cpu", lambda x: False)
    monkeypatch.setattr(kw, "_launch", stand_in("warp", kw.flow_warp_plain))
    monkeypatch.setattr(kd, "_input_conv_launch", stand_in("input_conv", kd.input_conv_plain))
    monkeypatch.setattr(kd, "_drt_block_launch", stand_in("drt_block", kd.drt_block_plain))
    monkeypatch.setattr(kd, "_head_launch", stand_in("head", kd.head_plain))
    monkeypatch.setattr(kc, "_conv3x3_launch", stand_in("conv3x3", kc.conv3x3_plain))
    t, n = 3, SMALL["num_blocks"]
    model = build_generator(dict(type="PnPVCVE", **SMALL, **VARIANTS[variant]), device="cpu",
                            seed=1)
    rng = np.random.default_rng(10)
    inp = {k: _t(v) for k, v in _inputs(rng, t=t).items()}
    gt = _t(rng.random((2, t, 16, 16, 3), np.float32))
    outs, grads = {}, {}
    for ops in (K.KERNELS, K.PLAIN):
        model.ops = ops
        model.zero_grad()
        outs[ops is K.KERNELS] = out = model(**inp)
        (out - gt).abs().mean().backward()
        # under 'drt_woqp' no block reads the expert routing or the SE gain
        grads[ops is K.KERNELS] = {m: p.grad for m, p in model.named_parameters()}
        if ops is K.KERNELS:
            got = dict(counts)
    assert got == {k: 2 * v for k, v in _launches_per_pass(variant, t, n).items()}
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)
    for m, g in grads[True].items():
        if g is None:
            assert variant == "drt_woqp" and grads[False][m] is None
            assert m.startswith(("BasePredictor.", "BiasePredictor."))
        else:
            torch.testing.assert_close(g, grads[False][m], rtol=1e-5, atol=1e-7)


def test_pf_needs_the_fused_block_form():
    """warp_impl='pf' refuses an unfused block form, as JAX's PF-resident
    input stack does (bae.py:391-395)."""
    model = build_generator(dict(type="PnPVCVE", **{**SMALL, "mid_channels": 64}, one_layer=False,
                                 use_pallas_kernels=True, warp_impl="pf"), device="cpu")
    inp = {k: _t(v) for k, v in _inputs(np.random.default_rng(0), 1, 2).items()}
    with pytest.raises(ValueError, match="fused Pallas input-stack"), torch.inference_mode():
        model(**inp)


def test_other_blocktype_is_drt_woqp_as_in_jax():
    """JAX's model class takes any blocktype but 'drt' as 'drt_woqp'
    (pnp_vcve.py:507, ``use_dynamic = blocktype == "drt"``); so does the
    port's. One such value on both classes, built directly (the builders
    refuse it, see the next test): JAX's parameters load strictly into the
    port's plain-conv2 blocks, and the forwards agree."""
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    jm = JaxPnPVCVE(**SMALL, blocktype="dcn", remat=False)
    inp = _inputs(np.random.default_rng(11))
    params = _jax_params(jm, 12, **{k: jnp.asarray(v) for k, v in inp.items()})
    want = np.asarray(jm.apply({"params": params}, **{k: jnp.asarray(v) for k, v in inp.items()}))
    model = PnPVCVE(**SMALL, blocktype="dcn", remat=False)
    assert not model.use_dynamic
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.inference_mode():
        got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("blocktype", ["dcn", "drt_wo_qp"])
def test_builder_refuses_other_blocktype_as_in_jax(blocktype):
    """JAX's builder refuses a blocktype but 'drt' and 'drt_woqp'
    (core/builder.py:74-75), with its message; so does the port's, where it
    once built 'drt_woqp' quietly."""
    from pnp_vcve_tpu.core.builder import build_generator as jax_build_generator

    msg = f"blocktype={blocktype!r} not implemented yet"
    with pytest.raises(NotImplementedError) as jax_err:
        jax_build_generator(dict(type="PnPVCVE", **SMALL, blocktype=blocktype))
    with pytest.raises(NotImplementedError) as err:
        build_generator(dict(type="PnPVCVE", **SMALL, blocktype=blocktype), device="cpu")
    assert str(err.value) == str(jax_err.value) == msg
