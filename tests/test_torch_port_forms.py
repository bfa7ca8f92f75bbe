"""The flagship generator's remaining forms, the port against the JAX
package on the CPU in float32 (the port runs its kernels' plain versions
here): the ops they need (every ``flow_warp`` form, the upsampling and
resize ops, the modulated deformable conv), the three aligners, and
``PnPVCVE`` with vsr=True, deform='basic'/'fvc' and flow_inter='nearest',
forward and gradients; the builder and the converters for these forms.

Weights are drawn by the port from a seed and carried to JAX's layouts
through ``pnp_vcve_tpu.core.convert`` (the reference's names), each sweep's
aligner apart; no flax init runs (tracing the DCN model's init costs ~6 s
here). Each ``conv_offset``'s last conv gets seeded weights large enough
that the learned offsets move the samples by pixels: with the zero init the
offsets would equal the flow and hide a transposed offset layout. JAX is
imported inside the tests, so that the card tests (marker ``cuda``) run
where JAX is absent:
``python -m pytest -m cuda --noconftest tests/test_torch_port_forms.py``.

Tolerances: the warps and the resizes 1e-5, the DCN 1e-5 relative to its
largest output, a model forward 1e-4 and gradients atol 2e-4 / rtol 1e-3
(tests/test_kernels.py:356).
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.core.checkpoint import load_generator_weights
from pnp_vcve_torch.core.convert import aligner_state_dict, from_jax_params
from pnp_vcve_torch.kernels import KERNELS, LAUNCHES, PLAIN, reset_launches
from pnp_vcve_torch.models import alignment as talign
from pnp_vcve_torch.ops import deform_conv as tdcn
from pnp_vcve_torch.ops import resize as tresize
from pnp_vcve_torch.ops import upsample as tup
from pnp_vcve_torch.ops import warp as twarp

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

SMALL = dict(mid_channels=8, num_blocks=2, num_experts=2, deform_groups=4)
FORMS = {
    "vsr_basic": dict(vsr=True, deform="basic"),
    "vsr_fvc": dict(vsr=True, deform="fvc"),
    "vsr_nearest": dict(vsr=True, flow_inter="nearest"),
}
OFFSET_SCALE = 0.5  # conv_offset.conv1's weights: offsets of ~1-3 px


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jnp(d):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in d.items()}


# ---- ops/warp.py ------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["padgather", "blockgather", "corner", "block8"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_flow_warp_forms_match_jax(interpolation, padding_mode, impl):
    """Every interpolation x padding x impl of ``flow_warp`` equals JAX's
    within 1e-5 on ragged sizes (one of them 1 pixel high: the blockgather
    and border fallbacks), flows that leave the image, and half-pixel
    positions (round half to even)."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.ops.warp import flow_warp as jax_warp

    rng = np.random.default_rng(0)
    for h, w in ((7, 11), (1, 5)):
        x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
        flow = rng.uniform(-8.0, 8.0, (2, h, w, 2)).astype(np.float32)
        flow[0, 0, :3] = [[0.5, 1.5], [2.5, -0.5], [-1.5, 0.0]]
        want = np.asarray(jax_warp(jnp.asarray(x), jnp.asarray(flow), interpolation, impl=impl,
                                   padding_mode=padding_mode))
        got = twarp.flow_warp(_t(x), _t(flow), interpolation, impl=impl,
                              padding_mode=padding_mode).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=f"{h}x{w}")


def test_flow_warp_refusals():
    x, flow = torch.zeros((1, 16, 16, 8)), torch.zeros((1, 16, 16, 2))
    with pytest.raises(NotImplementedError, match="blockgather"):
        twarp.flow_warp(x, flow, impl="corner", padding_mode="reflection")
    with pytest.raises(ValueError, match="Unsupported interpolation"):
        twarp.flow_warp(x, flow, "bicubic")
    with pytest.raises(ValueError, match="bilinear with zeros"):
        twarp.flow_warp(x, flow, "nearest", impl="pf")


# ---- ops/upsample.py, ops/resize.py --------------------------------------------------------


def test_pixel_shuffle_bitwise():
    import jax.numpy as jnp

    from pnp_vcve_tpu.ops.upsample import pixel_shuffle

    x = np.random.default_rng(1).standard_normal((2, 5, 7, 12)).astype(np.float32)
    for r in (1, 2):
        np.testing.assert_array_equal(tup.pixel_shuffle(_t(x), r).numpy(),
                                      np.asarray(pixel_shuffle(jnp.asarray(x), r)))
    # torch's own channel order, NCHW
    ref = torch.nn.functional.pixel_shuffle(_t(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(tup.pixel_shuffle(_t(x), 2), ref, rtol=0, atol=0)


def test_bilinear_resize_matches_jax():
    import jax.numpy as jnp

    from pnp_vcve_tpu.ops.upsample import bilinear_resize

    x = np.random.default_rng(2).standard_normal((2, 5, 7, 3)).astype(np.float32)
    for s in (2, 4):
        np.testing.assert_allclose(tup.bilinear_resize(_t(x), s).numpy(),
                                   np.asarray(bilinear_resize(jnp.asarray(x), s)),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(11, 3), (3, 20), (5, 7), (1, 1), (2, 9)])
def test_resize_matches_jax(size):
    """Both resize forms, up and down and unchanged, equal JAX's within
    1e-5, and torch's ``F.interpolate`` where it samples the same way."""
    import jax.numpy as jnp

    from pnp_vcve_tpu.ops import resize as jr

    x = np.random.default_rng(3).standard_normal((2, 5, 7, 4)).astype(np.float32)
    for tf, jf in ((tresize.resize_bilinear, jr.resize_bilinear),
                   (tresize.resize_bilinear_align_corners, jr.resize_bilinear_align_corners)):
        np.testing.assert_allclose(tf(_t(x), size).numpy(), np.asarray(jf(jnp.asarray(x), size)),
                                   atol=1e-5, rtol=0)
    if size != (1, 1):
        ref = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=size,
                                              mode="bilinear", align_corners=True)
        torch.testing.assert_close(tresize.resize_bilinear_align_corners(_t(x), size),
                                   ref.permute(0, 2, 3, 1), rtol=0, atol=1e-5)


# ---- ops/deform_conv.py ---------------------------------------------------------------------


@pytest.mark.parametrize("groups,taps", [(1, (1, 3)), (2, (3, 3)), (4, (3, 1))])
def test_deform_conv_matches_jax(groups, taps):
    """modulated_deform_conv2d equals JAX's within 1e-5 of its largest
    output, with offsets of up to +-4 px (taps off the image) and masks in
    (0, 1), at 1, 2 and 4 groups; the 1x3 and 3x1 kernels hold the tap
    order (and cost a third of the 3x3's JAX trace). Its gradients are held
    to jax.vjp's through the basic aligner
    (test_basic_aligner_grads_match_jax)."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.ops.deform_conv import modulated_deform_conv2d

    rng = np.random.default_rng(groups)
    kh, kw = taps
    x = rng.standard_normal((2, 9, 13, 8)).astype(np.float32)
    off = rng.uniform(-4.0, 4.0, (2, 9, 13, groups, kh * kw, 2)).astype(np.float32)
    mask = rng.random((2, 9, 13, groups, kh * kw)).astype(np.float32)
    k = (rng.standard_normal((kh, kw, 8, 6)) * 0.2).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    args = (x, off, mask, k, b)
    want = np.asarray(jax.jit(modulated_deform_conv2d)(*map(jnp.asarray, args)))
    got = tdcn.modulated_deform_conv2d(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_deform_conv_refuses_groups_that_do_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        tdcn.modulated_deform_conv2d(torch.zeros(1, 4, 4, 6), torch.zeros(1, 4, 4, 4, 9, 2),
                                     torch.zeros(1, 4, 4, 4, 9), torch.zeros(3, 3, 6, 6))


# ---- models/alignment.py ---------------------------------------------------------------------


def _jax_aligner(m):
    """A port DCN aligner's weights as JAX's param tree."""
    def conv(c):
        return {"kernel": c.weight.detach().permute(2, 3, 1, 0).numpy(),
                "bias": c.bias.detach().numpy()}

    return {"weight": m.weight.detach().permute(2, 3, 1, 0).numpy(),
            "bias": m.bias.detach().numpy(),
            "conv_offset": {"conv0": conv(m.conv_offset[0]), "conv1": conv(m.conv_offset[2])}}


def _offsets_on(m, gen):
    """Give an aligner's zero-initialised last offset conv seeded weights:
    offsets and masks that move the samples by pixels."""
    with torch.no_grad():
        w = m.conv_offset[2].weight
        w.copy_(torch.randn(w.shape, generator=gen) * OFFSET_SCALE)


@pytest.mark.parametrize("kind,interp", [("vos", "bilinear"), ("vos", "nearest"),
                                         ("fvc", "bilinear")])
def test_aligners_match_jax(kind, interp):
    """Each aligner equals JAX's within 1e-5 on the same params (the fvc
    offset head's conv1 nonzero: offsets of pixels), flows up to +-6 px;
    aligner_state_dict carries JAX's tree back bit for bit. The basic
    aligner: test_basic_aligner_grads_match_jax (nearest pre-warp) and the
    vsr_basic model (bilinear)."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.models import alignment as ja

    rng = np.random.default_rng(4)
    c, g = 8, 4
    feat = rng.standard_normal((2, 12, 20, c)).astype(np.float32)
    flow = rng.uniform(-6.0, 6.0, (2, 12, 20, 2)).astype(np.float32)
    if kind == "vos":
        jm, tm = ja.VOSAlignment(interp), talign.VOSAlignment(interp)
        params = {}
    else:
        jm = ja.FVCDeformableAlignment(channels=c, deform_groups=g)
        tm = talign.FVCDeformableAlignment(c, g)
    if kind != "vos":
        gen = torch.Generator().manual_seed(5)
        tm.reset_parameters(gen)
        _offsets_on(tm, gen)
        params = _jax_aligner(tm)
        for k, v in aligner_state_dict(params).items():
            torch.testing.assert_close(v, tm.state_dict()[k], rtol=0, atol=0)
        with torch.no_grad():
            head = tm._offset_head(torch.cat([_t(feat), _t(flow)], -1))
        assert float(head[..., : 2 * 9 * g].abs().mean()) > 1.0
    want = np.asarray(jax.jit(lambda p, f, fl: jm.apply({"params": p}, f, fl))(
        params, jnp.asarray(feat), jnp.asarray(flow)))
    with torch.no_grad():
        got = tm(_t(feat), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_basic_aligner_grads_match_jax():
    """The basic aligner with the nearest pre-warp equals JAX's within 1e-5,
    and its gradients for its parameters (the offset head's among them,
    through the offsets and the mask) and for the feature equal jax.vjp's
    (atol 2e-4, rtol 1e-3): the DCN's backward."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.models import alignment as ja

    rng = np.random.default_rng(6)
    c, g = 8, 4
    feat = rng.standard_normal((2, 10, 14, c)).astype(np.float32)
    flow = rng.uniform(-6.0, 6.0, (2, 10, 14, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 10, 14, c)).astype(np.float32)
    tm = talign.BasicDeformableAlignment(c, g, "nearest")
    gen = torch.Generator().manual_seed(7)
    tm.reset_parameters(gen)
    _offsets_on(tm, gen)
    jm = ja.BasicDeformableAlignment(channels=c, deform_groups=g, flow_interpolation="nearest")

    def fwd_bwd(p, f):
        out, pull = jax.vjp(lambda p, f: jm.apply({"params": p}, f, jnp.asarray(flow)), p, f)
        return out, pull(jnp.asarray(cot))

    out, (jp, jf) = jax.jit(fwd_bwd)(_jax_aligner(tm), jnp.asarray(feat))
    tf = _t(feat).requires_grad_()
    got = tm(tf, _t(flow))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    got.backward(_t(cot))
    want = aligner_state_dict(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in tm.named_parameters():
        assert float(want[name].abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=2e-4, rtol=1e-3)


# ---- PnPVCVE in the new forms ------------------------------------------------------------------


def _inputs(rng, b=2, t=3, h=16, w=16):
    return dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73, 66, 80, 66][:t], [66, 80, 66, 66][:t]], np.float32)[:b],
        mvs=rng.uniform(-6.0, 6.0, (b, t, h, w, 4)).astype(np.float32),
        base_qps=np.full((b, t), 25 / 255.0, np.float32),
        par_map=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h, w))] / 255.0,
    )


_FORM_CACHE = {}


def _form(form):
    """The port's PnPVCVE of a form (seeded weights, each sweep's offset
    head nonzero and its own), JAX's PnPVCVE of the form (remat off, XLA
    path) on the same weights, their params in JAX's layouts and a jitted
    JAX apply. JAX's converter reads the reference's names; the sweeps'
    aligners go across one each."""
    if form not in _FORM_CACHE:
        import jax

        from pnp_vcve_tpu.core.convert import convert_generator_state_dict
        from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE

        cfg = dict(FORMS[form])
        model = build_generator(dict(type="PnPVCVE", **SMALL, **cfg, remat=False), device="cpu",
                                seed=7)
        gen = torch.Generator().manual_seed(8)
        aligners = [model.backward_deform_align, model.forward_deform_align]
        for m in aligners:
            if m is not None:
                _offsets_on(m, gen)
        sd = {k: v.numpy() for k, v in model.state_dict().items()
              if "_deform_align." not in k}
        params = convert_generator_state_dict(sd, num_blocks=SMALL["num_blocks"],
                                              vsr=cfg.get("vsr", False))
        for side, m in zip(("backward", "forward"), aligners):
            if m is not None:
                params[side]["deform_align"] = _jax_aligner(m)
        interp = cfg.pop("flow_inter", "bilinear")
        jm = JaxPnPVCVE(**SMALL, **cfg, flow_interpolation=interp, remat=False)
        _FORM_CACHE[form] = (model, jm, params,
                             jax.jit(lambda p, x: jm.apply({"params": p}, **x)))
    return _FORM_CACHE[form]


@pytest.mark.parametrize("form,hw", [("vsr_basic", (16, 16)), ("vsr_fvc", (14, 18))])
def test_model_form_matches_jax(form, hw):
    """build_generator takes each form and the forward equals JAX's within
    1e-4: vsr with the basic aligners, and vsr with the fvc ones on 14x18
    (padded to 16x20, the 4x output cropped to 56x72) (the nearest warp:
    test_model_form_grads_match_jax); from_jax_params carries JAX's params
    back to the port's state dict bit for bit, each sweep's aligner its
    own."""
    model, _, params, apply = _form(form)
    sd = from_jax_params(params)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0, msg=k)
    inp = _inputs(np.random.default_rng(8), h=hw[0], w=hw[1])
    want = np.asarray(apply(params, _jnp(inp)))
    with torch.inference_mode():
        got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
    s = 4 if "vsr" in form else 1
    assert got.shape == want.shape == (2, 3, s * hw[0], s * hw[1], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_model_form_grads_match_jax():
    """vsr with the nearest warp (flow_inter='nearest'): the forward equals
    JAX's within 1e-4, and every parameter's gradient of one Charbonnier
    loss equals jax.vjp's (atol 2e-4, rtol 1e-3), through the step
    recompute (remat), the K4 head at 4x and the upsampling convs. The
    basic form's own part, the aligner, is held to jax.vjp in
    test_basic_aligner_grads_match_jax: the gradient of a whole DCN model
    costs ~27 s of JAX tracing and compiling here."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.train.losses import charbonnier_loss as jax_loss
    from pnp_vcve_torch.train.losses import charbonnier_loss

    model, jm, params, _ = _form("vsr_nearest")
    rng = np.random.default_rng(9)
    inp = _inputs(rng, t=2)
    gt = rng.random((2, 2, 64, 64, 3), np.float32)

    def fwd_bwd(p):
        y, pull = jax.vjp(lambda p: jm.apply({"params": p}, **_jnp(inp)), p)
        loss, g_y = jax.value_and_grad(lambda y: jax_loss(y, jnp.asarray(gt)))(y)
        return y, pull(g_y)[0]

    y, grads = jax.jit(fwd_bwd)(params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, grads))
    model.remat = True
    try:
        model.zero_grad()
        got = model(**{k: _t(v) for k, v in inp.items()})
        charbonnier_loss(got, _t(gt)).backward()
    finally:
        model.remat = False
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), atol=1e-4, rtol=0)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    assert float(want["upsample1.upsample_conv.weight"].abs().max()) > 0


def test_form_launches_through_kernel_wrappers(monkeypatch):
    """vsr with basic aligners, every wrapper routed past its CPU check (the
    plain versions standing in for the launches): per frame 2 K1 (basic's
    pre-warp), 2 K2, 2N K3 and one K4 at 4h x 4w; fvc no K1. Outputs equal
    the plain path's."""
    from pnp_vcve_torch.kernels import drt_stack as kd
    from pnp_vcve_torch.kernels import warp as kw

    seen = []

    def stand_in(name, plain):
        def run(*a):
            LAUNCHES[name] += 1
            if name == "head":
                seen.append(tuple(a[0].shape))
            return plain(*a)
        return run

    monkeypatch.setattr(kw, "on_cpu", lambda x: False)
    monkeypatch.setattr(kd, "on_cpu", lambda x: False)
    monkeypatch.setattr(kw, "_launch", stand_in("warp", kw.flow_warp_plain))
    monkeypatch.setattr(kd, "_input_conv_launch", stand_in("input_conv", kd.input_conv_plain))
    monkeypatch.setattr(kd, "_drt_block_launch", stand_in("drt_block", kd.drt_block_plain))
    monkeypatch.setattr(kd, "_head_launch", stand_in("head", kd.head_plain))
    t, n = 3, SMALL["num_blocks"]
    inp = {k: _t(v) for k, v in _inputs(np.random.default_rng(5), b=1, t=t).items()}
    for deform, k1 in (("basic", 2 * t), ("fvc", 0)):
        model = build_generator(dict(type="PnPVCVE", **SMALL, vsr=True, deform=deform),
                                device="cpu", seed=3)
        reset_launches()
        seen.clear()
        with torch.inference_mode():
            got = model(**inp)
            counts = dict(LAUNCHES)
            model.ops = PLAIN
            want = model(**inp)
        assert counts == {"warp": k1, "warp_block": 0, "input_conv": 2 * t,
                          "drt_block": 2 * n * t, "drt_block_select": 0, "head": t,
                          "conv3x3": 0}, deform
        assert seen == [(1, 64, 64, SMALL["mid_channels"])] * t
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- builder, converter, guards --------------------------------------------------------------


def test_builder_takes_the_forms_and_refuses_stdf():
    m = build_generator(dict(type="PnPVCVE", **SMALL, vsr=True, deform="fvc",
                             flow_inter="nearest"), device="cpu")
    assert (m.vsr, m.deform, m.flow_interpolation) == (True, "fvc", "nearest")
    assert m.backward_deform_align is not m.forward_deform_align
    assert m.backward_deform_align.deform_groups == SMALL["deform_groups"]
    # conv_offset's last conv starts at zero, as the reference's and JAX's
    assert not m.forward_deform_align.conv_offset[2].weight.any()
    with pytest.raises(NotImplementedError, match="No such DCN type"):
        build_generator(dict(type="PnPVCVE", **SMALL, deform="stdf"), device="cpu")


def test_reference_state_dict_fills_both_sweeps(tmp_path):
    """A reference ``generator.*`` state dict (one shared ``deform_align``,
    ``upsample{1,2}.upsample_conv``) loads into both sweeps' aligners, and
    JAX's converter reads the same dict into the params that
    from_jax_params carries back to the port's state dict, bit for bit."""
    from pnp_vcve_tpu.core.convert import convert_generator_state_dict

    model = build_generator(dict(type="PnPVCVE", **SMALL, vsr=True, deform="basic"),
                            device="cpu", seed=2)
    ref = {}
    for k, v in model.state_dict().items():
        if k.startswith("forward_deform_align."):
            continue
        ref["generator." + k.replace("backward_deform_align.", "deform_align.")] = v.numpy()
    np.savez(tmp_path / "ref.npz", **ref)
    fresh = build_generator(dict(type="PnPVCVE", **SMALL, vsr=True, deform="basic"),
                            device="cpu", seed=3)
    load_generator_weights(fresh, str(tmp_path / "ref.npz"))
    sd = fresh.state_dict()
    for k, v in model.backward_deform_align.state_dict().items():
        torch.testing.assert_close(sd[f"forward_deform_align.{k}"], v, rtol=0, atol=0)
        torch.testing.assert_close(sd[f"backward_deform_align.{k}"], v, rtol=0, atol=0)
    params = convert_generator_state_dict(
        {k: v for k, v in ref.items()}, num_blocks=SMALL["num_blocks"], vsr=True)
    back = from_jax_params(params)
    assert set(back) == set(sd)
    for k, v in back.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("override", [dict(vsr=True), dict(deform="basic"),
                                      dict(deform="fvc")])
def test_pf_guard_refuses_vsr_and_deform(override):
    """warp_impl='pf' refuses vsr and the DCN aligners, as JAX does
    (pnp_vcve.py:535-539)."""
    model = build_generator(dict(type="PnPVCVE", mid_channels=64, num_blocks=1, num_experts=2,
                                 use_pallas_kernels=True, warp_impl="pf", **override),
                            device="cpu")
    inp = {k: _t(v) for k, v in _inputs(np.random.default_rng(0), b=1, t=2).items()}
    with pytest.raises(ValueError, match="deform='vos', vsr=False"), torch.inference_mode():
        model(**inp)


# ---- on the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("deform", ["basic", "fvc"])
def test_vsr_head_on_the_card(cuda, deform):
    """vsr at 64 channels with a DCN aligner: the kernel path (K4 at 4h x
    4w, one launch a frame) within 3e-3 of the plain path, float32."""
    model = build_generator(dict(type="PnPVCVE", mid_channels=64, num_blocks=2, num_experts=2,
                                 vsr=True, deform=deform), device=cuda, seed=4)
    t, h, w = 3, 36, 52
    inp = {k: _t(v).to(cuda) for k, v in _inputs(np.random.default_rng(6), b=1, t=t, h=h,
                                                  w=w).items()}
    with torch.inference_mode():
        reset_launches()
        got = model(**inp)
        assert LAUNCHES["head"] == t and LAUNCHES["warp"] == (2 * t if deform == "basic" else 0)
        model.ops = PLAIN
        want = model(**inp)
    assert got.shape == (1, t, 4 * h, 4 * w, 3)
    assert float((got - want).abs().max()) <= 3e-3
    model.ops = KERNELS
