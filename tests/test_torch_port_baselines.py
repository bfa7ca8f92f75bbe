"""The port's baselines against the JAX package on the CPU: SPyNet, vanilla
BasicVSR++, the four BasicVSR++ PQF variants, MFQEv2 with the MFQE joint
protocol, the PQF helpers, and the weight carriers of core/convert.py.

Weights: one reference-named numpy state dict per model, drawn from a seed
(every offset head non-zero, SPyNet's last convs scaled so that the flows
reach several pixels). The port loads it directly; JAX takes it through
``convert_spynet`` / ``convert_bvpp_pqf``, and the port's inverse in
core/convert.py must give it back exactly. MFQEv2 goes the other way: JAX
``params`` and ``batch_stats`` (set away from 0 / 1) carried to the port.

Sizes: 8 channels, 1 block, 2 deform groups, MFQEv2 at nf=4, frames of
32x48 (not multiples of 32: SPyNet's resize runs; full-size input at
128x192, so that its features have the LR case's size). Each JAX model is
jitted once per configuration. JAX traces its DCN (``ops/deform_conv.py``,
nested vmaps) in ~2.6 s a call, eight calls a model, and its warps in ~0.1
s a call, dozens a model: for these tests the names ``modulated_deform_conv2d``
and ``flow_warp`` in JAX's basicvsr_pp, spynet and mfqev2 modules are
wrapped in ``jax.jit``, so that each shape is traced once and reused. The
functions computed are JAX's own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert_baselines import convert_bvpp_pqf, convert_spynet
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.core.convert import bvpp_state_dict, mfqev2_state_dict, spynet_state_dict

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

H, W = 32, 48
SMALL = dict(mid_channels=8, num_blocks=1, deform_groups=2)
PQF_SLICES = np.array([[73, 66, 66, 80, 66, 66], [73, 80, 66, 66, 66, 80]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _jax_traced_once():
    import pnp_vcve_tpu.models.baselines.basicvsr_pp as jb
    import pnp_vcve_tpu.models.baselines.mfqev2 as jm
    import pnp_vcve_tpu.models.spynet as js

    mp = pytest.MonkeyPatch()
    mp.setattr(jb, "modulated_deform_conv2d", jax.jit(jb.modulated_deform_conv2d))
    warp = jax.jit(jb.flow_warp, static_argnames=("interpolation", "impl", "padding_mode"))
    for mod in (jb, jm, js):
        mp.setattr(mod, "flow_warp", warp)
    yield
    mp.undo()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _reference_sd(model, seed):
    """A numpy state dict under the model's (the reference's) names: conv
    weights N(0, 1 / fan_in), biases N(0, 0.05); each offset head's last
    conv non-zero (offsets of a pixel or so) and SPyNet's last convs x4."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("weight") and v.dim() == 4:
            a = rng.standard_normal(v.shape) / np.sqrt(v[0].numel())
            if "conv_offset.6" in k:
                a *= 0.5
            if ".basic_module.4.conv" in k:
                a *= 4.0
        else:
            a = rng.standard_normal(v.shape) * 0.05
        sd[k] = a.astype(np.float32)
    return sd


def _port(typ, sd, **cfg):
    model = build_generator(dict(type=typ, **cfg), device="cpu")
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return model


def _jax_bvpp_params(sd):
    """``convert_bvpp_pqf`` of a reference state dict; with full-size input
    the stride-2 convs (``feat_extract.{0,2}``), which that converter does
    not read, go to ``feat_down{0,1}`` by hand."""
    if "feat_extract.0.weight" not in sd:
        return convert_bvpp_pqf(sd, num_blocks=SMALL["num_blocks"])
    renamed = {k.replace("feat_extract.4.main.", "feat_extract.main."): v for k, v in sd.items()}
    params = convert_bvpp_pqf(renamed, num_blocks=SMALL["num_blocks"])
    for i, ref in ((0, 0), (1, 2)):
        params[f"feat_down{i}"] = {
            "kernel": np.transpose(sd[f"feat_extract.{ref}.weight"], (2, 3, 1, 0)),
            "bias": sd[f"feat_extract.{ref}.bias"]}
    return params


def _assert_sd_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_spynet_matches_jax():
    from pnp_vcve_tpu.models.spynet import SPyNet as JaxSPyNet
    from pnp_vcve_torch.models.spynet import SPyNet

    model = SPyNet()
    sd = _reference_sd(model, 0)
    model.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    params = convert_spynet(sd)
    _assert_sd_equal(spynet_state_dict(params), sd)
    rng = np.random.default_rng(1)
    ref, supp = (rng.random((2, H, W, 3), np.float32) for _ in range(2))
    want = np.asarray(jax.jit(JaxSPyNet().apply)({"params": params}, ref, supp))
    with torch.inference_mode():
        got = model(_t(ref), _t(supp)).numpy()
    assert got.shape == (2, H, W, 2) and np.abs(want).max() > 2.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _jax_vanilla(low_res: bool, mirror: bool):
    """JAX's vanilla BasicVSR++ apply, jitted once per form (the eval
    harness's cascade below reuses the LR form's)."""
    from pnp_vcve_tpu.models.baselines.basicvsr_pp import BasicVSRPlusPlus as Jax

    return jax.jit(functools.partial(Jax(**SMALL, is_low_res_input=low_res).apply,
                                     is_mirror_extended=mirror))


def _vanilla(low_res: bool):
    """The port's vanilla BasicVSR++ on its reference state dict (seed 2)
    and JAX's params for it."""
    cfg = dict(SMALL, is_low_res_input=low_res)
    sd = _reference_sd(build_generator(dict(type="BasicVSRPlusPlus", **cfg), device="cpu"), 2)
    return _port("BasicVSRPlusPlus", sd, **cfg), _jax_bvpp_params(sd), sd


@pytest.mark.parametrize("low_res,mirror", [(True, False), (False, False), (True, True)])
def test_bvpp_vanilla_matches_jax(low_res, mirror):
    """Vanilla BasicVSR++ at t = 4, LR (x4 out) and full-size input, and the
    mirror-extended form (forward flows the backward ones reversed)."""
    model, params, sd = _vanilla(low_res)
    _assert_sd_equal(bvpp_state_dict(params), sd)
    s = 1 if low_res else 4  # the features at H x W either way
    lrs = np.random.default_rng(3).random((1, 4, s * H, s * W, 3), np.float32)
    if mirror:
        lrs = np.concatenate([lrs[:, :2], lrs[:, 1::-1]], axis=1)
    want = np.asarray(_jax_vanilla(low_res, mirror)({"params": params}, lrs))
    with torch.inference_mode():
        got = model(_t(lrs), is_mirror_extended=mirror).numpy()
    assert got.shape == (1, 4, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", ["base", "v2", "v2_withB_skip", "v2_onlyB_skip"])
def test_bvpp_pqf_variants_match_jax(variant):
    """Each PQF variant at t = 6 on two batch items whose I/P/B slices differ
    (the keys are routed per item, as in JAX)."""
    from pnp_vcve_tpu.models.baselines.basicvsr_pp import BasicVSRPlusPlusPQF as Jax

    names = {"base": "BasicVSRPlusPlus_PQF", "v2": "BasicVSRPlusPlus_PQF_v2",
             "v2_withB_skip": "BasicVSRPlusPlus_PQF_v2_withB_skip",
             "v2_onlyB_skip": "BasicVSRPlusPlus_PQF_v2_onlyB_skip"}
    sd = _reference_sd(build_generator(dict(type=names[variant], **SMALL), device="cpu"), 4)
    model = _port(names[variant], sd, **SMALL)
    assert model.variant == variant
    params = _jax_bvpp_params(sd)
    lrs = np.random.default_rng(5).random((2, 6, H, W, 3), np.float32)
    want = np.asarray(jax.jit(Jax(**SMALL, variant=variant).apply)(
        {"params": params}, lrs, slices=PQF_SLICES))
    with torch.inference_mode():
        got = model(_t(lrs), slices=_t(PQF_SLICES)).numpy()
    assert got.shape == (2, 6, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_mfqe(seed):
    """JAX MFQEv2(nf=4) and variables drawn from ``seed``: params N(0, 0.2),
    running means N(0, 0.1), variances U(0.5, 2)."""
    from pnp_vcve_tpu.models.baselines import MFQEv2 as Jax

    model = Jax(nf=4)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 3, H, W, 3))))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), shapes["params"])
    stats = {k: {"bn": {"mean": (rng.standard_normal(v["bn"]["mean"].shape) * 0.1)
                        .astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, v["bn"]["var"].shape).astype(np.float32)}}
             for k, v in shapes["batch_stats"].items()}
    return model, {"params": params, "batch_stats": stats}


def _port_mfqe(variables):
    model = build_generator(dict(type="MFQEv2", nf=4), device="cpu")
    model.load_state_dict(mfqev2_state_dict(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def mfqe_pair():
    """(JAX model, its jitted apply, the port's model) for the PQF and the
    non-PQF weights."""
    out = []
    for seed in (6, 7):
        jm, variables = _jax_mfqe(seed)
        apply = jax.jit(lambda lrs, jm=jm, v=variables: jm.apply(v, lrs))
        out.append((apply, _port_mfqe(variables)))
    return out


def test_mfqev2_carried_matches_jax(mfqe_pair):
    """JAX params and batch_stats carried by mfqev2_state_dict: the port's
    forward (BatchNorm on the running statistics) within 1e-5."""
    (apply, model), _ = mfqe_pair
    lrs = np.random.default_rng(8).random((1, 3, H, W, 3), np.float32)
    with torch.inference_mode():
        got = model(_t(lrs)).numpy()
    assert got.shape == (1, H, W, 3)
    np.testing.assert_allclose(got, np.asarray(apply(lrs)), rtol=0, atol=1e-5)


def test_mfqe_joint_enhance_matches_jax(mfqe_pair):
    """The two-model protocol on a 6-frame I/P/B clip: the port's
    ``mfqe_joint_enhance`` (port models) against JAX's (JAX models)."""
    from pnp_vcve_tpu.models.baselines.mfqev2 import mfqe_joint_enhance as jax_joint
    from pnp_vcve_torch.models.baselines import mfqe_joint_enhance

    (jpqf, pqf), (jnon, non) = mfqe_pair

    def run(model):
        def f(lrs):
            with torch.inference_mode():
                return model(_t(lrs)).numpy()
        return f

    frames = np.random.default_rng(9).random((6, H, W, 3), np.float32)
    letters = list("IBPBBP")
    want = jax_joint(jpqf, jnon, frames, letters)
    got = mfqe_joint_enhance(run(pqf), run(non), frames, letters)
    assert got.shape == frames.shape and not np.array_equal(got[1], frames[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("slices", ["IBBPBBP", "IPPPP", "BBBB", "PBBBBBBBI", "I"])
def test_find_left_right_pqf_equals_jax(slices):
    from pnp_vcve_tpu.data import ldp as jax_ldp
    from pnp_vcve_torch.data import ldp

    assert ldp.PQF_SLICES == jax_ldp.PQF_SLICES
    n = len(slices)
    for compressed in (True, False):
        for i in range(n):
            assert (ldp.find_left_right_pqf(lambda k: slices[k], i, n, compressed)
                    == jax_ldp.find_left_right_pqf(lambda k: slices[k], i, n, compressed))


# ---- the eval harness: the cascade and the joint protocol against JAX's ---------------

def _clip(rng, name, t, gt_scale=1, slices="IBPB"):
    """One clip sample of the eval datasets' form at H x W, 8x8-block MVs."""
    mv = rng.uniform(-6.0, 6.0, (t, H // 8, W // 8, 4)).astype(np.float32)
    return dict(
        clip_name=name,
        lq=rng.random((t, H, W, 3), np.float32),
        gt=rng.random((t, gt_scale * H, gt_scale * W, 3), np.float32),
        qps=rng.random(t).astype(np.float32),
        slices=np.array([float(ord(c)) for c in slices[:t]], np.float32),
        mvs=np.repeat(np.repeat(mv, 8, 1), 8, 2),
        base_qps=np.full(t, 15.0 / 255.0, np.float32),
        partitions=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (t, H, W))] / 255.0,
    )


def _assert_metrics_close(got, want):
    assert set(got) == set(want) == {"PSNR", "SSIM"}
    assert abs(got["PSNR"] - want["PSNR"]) <= 1e-3, (got, want)
    assert abs(got["SSIM"] - want["SSIM"]) <= 1e-5, (got, want)


def test_evaluate_dataset_cascade_matches_jax():
    """``evaluate_dataset(cascade=(model, restorer))`` against JAX's
    ``evaluate_dataset`` with its cascade triple: a tiny flagship, then the
    LR vanilla BasicVSR++ of the test above on its output, metrics against
    the x4 GT. Two clips of 4 frames."""
    from pnp_vcve_tpu.core.convert import convert_generator_state_dict
    from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
    from pnp_vcve_tpu.models.restorer import Restorer as JaxRestorer
    from pnp_vcve_tpu.train.eval import evaluate_dataset as jax_evaluate
    from pnp_vcve_torch.models.restorer import Restorer
    from pnp_vcve_torch.train.eval import evaluate_dataset

    cfg = dict(mid_channels=8, num_blocks=1, num_experts=2)
    flagship = build_generator(dict(type="PnPVCVE", **cfg, remat=False), device="cpu", seed=1)
    jax_params = convert_generator_state_dict(
        {k: v.numpy() for k, v in flagship.state_dict().items()}, num_blocks=1)
    vsr, vsr_params, _ = _vanilla(True)
    rng = np.random.default_rng(10)
    data = [_clip(rng, "000", 4, gt_scale=4), _clip(rng, "001", 4, gt_scale=4, slices="IPBB")]
    test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
    got = evaluate_dataset(Restorer(generator=flagship, test_cfg=test_cfg), data,
                           cascade=(vsr, Restorer(generator=vsr, test_cfg=test_cfg)),
                           verbose=False)
    apply = _jax_vanilla(True, False)
    want = jax_evaluate(JaxRestorer(generator=JaxPnPVCVE(**cfg, remat=False), test_cfg=test_cfg),
                        jax_params, data,
                        cascade=(lambda p, lrs: apply({"params": p}, lrs), vsr_params, None),
                        verbose=False)
    _assert_metrics_close(got, want)


def test_evaluate_dataset_mfqe_joint_matches_jax(mfqe_pair, tmp_path, capsys):
    """``evaluate_dataset_mfqe_joint`` against JAX's on two 6-frame clips:
    the dataset mean within 1e-3 dB / 1e-5, ``[mfqe-joint]`` lines, PNGs."""
    from pnp_vcve_tpu.models.restorer import Restorer as JaxRestorer
    from pnp_vcve_tpu.train.eval import evaluate_dataset_mfqe_joint as jax_joint_eval
    from pnp_vcve_torch.models.restorer import CenterFrameRestorer
    from pnp_vcve_torch.train.eval import evaluate_dataset_mfqe_joint

    (_, pqf), (_, non) = mfqe_pair
    jpqf, pqf_vars = _jax_mfqe(6)
    jnon, non_vars = _jax_mfqe(7)
    rng = np.random.default_rng(11)
    data = [_clip(rng, "000", 6, slices="IBPBBP"), _clip(rng, "001", 6, slices="IBBPBB")]
    test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
    got = evaluate_dataset_mfqe_joint(pqf, non, data,
                                      CenterFrameRestorer(generator=non, test_cfg=test_cfg),
                                      save_path=str(tmp_path), save_image=True)
    lines = capsys.readouterr().out
    want = jax_joint_eval(jpqf, pqf_vars, jnon, non_vars, data,
                          JaxRestorer(generator=jnon, test_cfg=test_cfg), verbose=False)
    _assert_metrics_close(got, want)
    assert "[mfqe-joint] 001: PSNR=" in lines and "[mfqe-joint] dataset mean" in lines
    assert len(list(tmp_path.glob("*/*.png"))) == 12
