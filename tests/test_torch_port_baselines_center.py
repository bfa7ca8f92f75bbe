"""The port's centre-frame baselines against the JAX package on the CPU:
``ops/pac.py`` and ``ops/wavelet.py``, STDF, DCNGAN's generator and
discriminator, MW-GAN's PSNR generator and SIDECVSR (carried by
core/convert.py), ``LDPTripleDataset``, ``evaluate_center_frame_dataset``,
both branches of ``apis.restoration_video_inference`` for image-input
models, and the builder's new types.

Weights: JAX params from ``jax.eval_shape`` of the init, filled with seeded
numpy (N(0, 1 / fan_in) kernels, N(0, 0.04) biases; SIDECVSR's kernels
x0.4, since its SFT blocks multiply the features and overflow at unit
gain). STDF also goes the other way: the port's state dict under the
reference's names through JAX's ``convert_stdf``. Sizes are small (a few
channels, 16-64 px); each JAX model is jitted once per form.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_e2e import T_FRAMES, dataset_root  # noqa: F401  (the fixture)

from pnp_vcve_torch.core import convert
from pnp_vcve_torch.core.builder import build_dataset, build_discriminator, build_generator

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

STDF_SMALL = dict(nf_stdf=8, nf_stdf_out=8, nf_qe=8, nb_qe=2)
DCNGAN_SMALL = dict(nf_fa=4, nb_fa=2)
MWGAN_SMALL = dict(nf=16, nb=1, front_rbs=1, gc=8)
SIDE_SMALL = dict(nf=16, scg_n=1)


@pytest.fixture(scope="module", autouse=True)
def _jax_dcn_traced_once():
    """JAX's STDF module (DCNGAN's FA too) calls its DCN through a jitted
    wrapper, so that each shape is traced once (its nested vmaps take
    seconds a trace); the function computed is JAX's own."""
    import pnp_vcve_tpu.models.baselines.stdf as js

    mp = pytest.MonkeyPatch()
    mp.setattr(js, "modulated_deform_conv2d", jax.jit(js.modulated_deform_conv2d))
    yield
    mp.undo()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _fill(shapes, seed, gain=1.0):
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) > 1:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * gain / np.sqrt(fan_in)).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model(name, seed, *args_shapes, gain=1.0, **cfg):
    """(JAX module, seeded params) for inputs of ``args_shapes``."""
    model = _module(name, **cfg)
    args = [jnp.zeros(s, jnp.float32) for s in args_shapes]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]
    return model, _fill(shapes, seed, gain)


@functools.lru_cache(maxsize=None)
def _jax_apply(name, **cfg):
    """JAX's jitted apply for one model configuration (one trace a shape)."""
    return jax.jit(_module(name, **cfg).apply)


def _module(name, **cfg):
    from pnp_vcve_tpu.models.baselines.dcngan import DCNGANDiscriminator, DCNGANNet
    from pnp_vcve_tpu.models.baselines.mwgan import DenseMWNetMiniPSNR
    from pnp_vcve_tpu.models.baselines.sidecvsr import SIDECVSR
    from pnp_vcve_tpu.models.baselines.stdf import STDFNet

    return dict(stdf=STDFNet, dcngan=DCNGANNet, disc=DCNGANDiscriminator,
                mwgan=DenseMWNetMiniPSNR, sidecvsr=SIDECVSR)[name](**cfg)


def _port(typ, sd, disc=False, **cfg):
    model = (build_discriminator if disc else build_generator)(dict(type=typ, **cfg),
                                                               device="cpu")
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


# ---- ops ------------------------------------------------------------------------------------


def test_pac_and_wavelets_match_jax():
    """``gauss_kernel2d``, ``pac_conv2d`` (with and without bias), ``dwt`` and
    ``iwt`` against JAX's within 1e-6; ``iwt(dwt(x)) == x`` within 1e-6."""
    from pnp_vcve_tpu.ops import pac as jpac
    from pnp_vcve_tpu.ops import wavelet as jwav
    from pnp_vcve_torch.ops.pac import gauss_kernel2d, pac_conv2d
    from pnp_vcve_torch.ops.wavelet import dwt, iwt

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    guide = (rng.standard_normal((2, 12, 16, 3)) * 0.7).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 5, 7)) / 6).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    _close(gauss_kernel2d(_t(guide)), jpac.gauss_kernel2d(guide), 1e-6)
    _close(pac_conv2d(_t(x), _t(guide), _t(kernel), _t(bias)),
           jpac.pac_conv2d(x, guide, kernel, bias), 1e-6)
    _close(pac_conv2d(_t(x), _t(guide), _t(kernel)), jpac.pac_conv2d(x, guide, kernel), 1e-6)
    _close(dwt(_t(x)), jwav.dwt(x), 1e-6)
    y = rng.standard_normal((2, 6, 8, 12)).astype(np.float32)
    _close(iwt(_t(y)), jwav.iwt(y), 1e-6)
    _close(iwt(dwt(_t(x))), x, 1e-6)


# ---- STDF -----------------------------------------------------------------------------------


@pytest.mark.parametrize("radius,nb,hw", [(1, 2, (32, 32)), (3, 3, (36, 44))])
def test_stdf_matches_jax(radius, nb, hw):
    """STDFNet carried by ``stdf_state_dict``: within 1e-5 of JAX at 32x32
    and at an odd 36x44 (the decoder's bilinear resizes and XLA's 'SAME'
    stride-2 padding on odd sides); the port's state dict, under the
    reference's names, through JAX's own ``convert_stdf`` gives JAX's params
    back exactly."""
    from pnp_vcve_tpu.core.convert_baselines import convert_stdf

    cfg = dict(STDF_SMALL, radius=radius, nb_stdf=nb)
    t = 2 * radius + 1
    shape = (2, t, *hw, 3)
    jm, params = _jax_model("stdf", 1, shape, **cfg)
    port = _port("STDFNet", convert.stdf_state_dict(params), **cfg)
    lrs = np.random.default_rng(2).random(shape, np.float32)
    want = _jax_apply("stdf", **cfg)({"params": params}, lrs)
    with torch.inference_mode():
        _close(port(_t(lrs)), want, 1e-5)
    back = convert_stdf({k: v.numpy() for k, v in port.state_dict().items()}, nb=nb,
                        nb_qe=STDF_SMALL["nb_qe"])
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                           params, back)


def test_stdf_reference_names_drive_jax():
    """A seeded state dict under the port's (the reference's) names: the
    port's forward equals JAX's on ``convert_stdf`` of the same dict within
    1e-5."""
    from pnp_vcve_tpu.core.convert_baselines import convert_stdf

    cfg = dict(STDF_SMALL, radius=1, nb_stdf=2)
    port = build_generator(dict(type="STDFNet", **cfg), device="cpu", seed=5).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    lrs = np.random.default_rng(3).random((2, 3, 32, 32, 3), np.float32)
    want = _jax_apply("stdf", **cfg)({"params": convert_stdf(sd, nb=2, nb_qe=2)}, lrs)
    with torch.inference_mode():
        _close(port(_t(lrs)), want, 1e-5)


# ---- DCNGAN ---------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dcngan_pair():
    shape = (2, 3, 64, 64, 3)
    jm, params = _jax_model("dcngan", 3, shape, **DCNGAN_SMALL)
    port = _port("DCNGANNet", convert.dcngan_state_dict(params), **DCNGAN_SMALL)
    apply = jax.jit(lambda lrs, bq: jm.apply({"params": params}, lrs, base_qps=bq))
    return port, apply, np.random.default_rng(4).random(shape, np.float32)


@pytest.mark.parametrize("base_qp", [None, 22.0, 37.0])
def test_dcngan_matches_jax(base_qp):
    """DCNGANNet (FA 4 / 2) carried by ``dcngan_state_dict``, base QPs None
    (class 0), 22 and 37 (both clipped to class 3): within 1e-4 of JAX at
    64x64, the batch-statistics norms on the batch of 2. JAX's None branch
    is ``jnp.zeros((b,))`` (dcngan.py:121-123), so JAX gets zeros for it:
    one trace serves the three cases."""
    port, apply, lrs = _dcngan_pair()
    bq = None if base_qp is None else np.full((2, 3), base_qp, np.float32)
    want = apply(lrs, np.zeros((2, 3), np.float32) if bq is None else bq)
    with torch.inference_mode():
        got = port(_t(lrs), base_qps=None if bq is None else _t(bq))
    _close(got, want, 1e-4)


def test_dcngan_discriminator_matches_jax():
    """DCNGANDiscriminator (d 8): the prediction and its 4 feature maps
    within 1e-5 of JAX at 64x64."""
    jm, params = _jax_model("disc", 5, (2, 64, 64, 3), d=8)
    port = _port("DCNGANDiscriminator", convert.dcngan_disc_state_dict(params), disc=True, d=8)
    x = np.random.default_rng(6).random((2, 64, 64, 3), np.float32)
    want = jax.jit(jm.apply)({"params": params}, x)
    with torch.inference_mode():
        got = port(_t(x))
    _close(got["prediction"], want["prediction"], 1e-5)
    assert len(got["feature_maps"]) == 4
    for g, w in zip(got["feature_maps"], want["feature_maps"]):
        _close(g, w, 1e-5)


# ---- MW-GAN and SIDECVSR --------------------------------------------------------------------


def test_mwgan_matches_jax_and_refuses_other_sides():
    """DenseMWNetMiniPSNR (16 / 1 / 1 / 8) carried by ``mwgan_state_dict``:
    within 1e-5 of JAX on 5 frames at 32x32; a side that is not a multiple
    of 16 is refused."""
    shape = (1, 5, 32, 32, 3)
    jm, params = _jax_model("mwgan", 7, shape, **MWGAN_SMALL)
    port = _port("DenseMWNet_Mini_PSNR", convert.mwgan_state_dict(params),
                 **{("front_RBs" if k == "front_rbs" else k): v for k, v in MWGAN_SMALL.items()})
    lrs = np.random.default_rng(8).random(shape, np.float32)
    want = jax.jit(jm.apply)({"params": params}, lrs)
    with torch.inference_mode():
        _close(port(_t(lrs)), want, 1e-5)
        with pytest.raises(ValueError, match="multiples of 16"):
            port(torch.zeros(1, 5, 24, 32, 3))


def _side_inputs(rng, n, h, w):
    return (rng.random((1, n, h, w, 1), np.float32),
            (rng.standard_normal((1, n, h, w, 2)) * 0.05).astype(np.float32),
            rng.random((1, n, h, w, 1), np.float32), rng.random((1, n, h, w, 1), np.float32),
            rng.random((1, n, h, w, 1), np.float32))


@functools.lru_cache(maxsize=None)
def _sidecvsr_pair():
    shapes = [(1, 7, 16, 16, c) for c in (1, 2, 1, 1, 1)]
    jm, params = _jax_model("sidecvsr", 9, *shapes, gain=0.4, **SIDE_SMALL)
    return jm, params, _port("SIDECVSR", convert.sidecvsr_state_dict(params), **SIDE_SMALL)


def test_sidecvsr_matches_jax():
    """SIDECVSR (nf 16, one SC group) carried by ``sidecvsr_state_dict``: the
    x4 output and the frame features within 1e-4 of JAX on 7 frames at
    16x16 (MVs of ~1.6 px after the x32)."""
    jm, params, port = _sidecvsr_pair()
    xs = _side_inputs(np.random.default_rng(10), 7, 16, 16)
    want = jax.jit(jm.apply)({"params": params}, *xs)
    with torch.inference_mode():
        got = port(*map(_t, xs))
    _close(got[0], want[0], 1e-4)
    _close(got[1], want[1], 1e-4)


def test_sidecvsr_incremental_features_equal_full():
    """The next window with ``pre_l1_fea`` (only its newest frame extracted)
    equals the full path on that window within 1e-6."""
    _, _, port = _sidecvsr_pair()
    xs = _side_inputs(np.random.default_rng(11), 8, 16, 16)
    first = [_t(a[:, :7]) for a in xs]
    second = [_t(a[:, 1:]) for a in xs]
    with torch.inference_mode():
        _, l1 = port(*first)
        full = port(*second)
        inc = port(*second, pre_l1_fea=l1)
    _close(inc[0], full[0].numpy(), 1e-6)
    _close(inc[1], full[1].numpy(), 1e-6)


# ---- data, eval and the API -----------------------------------------------------------------


def _ldp(cls, clip_index, root, centers, clips):
    return cls(
        lq_folder=str(root / "crf15" / "png"), gt_folder=str(root / "sharp" / "png"),
        cprs15_folder=str(root / "crf15" / "png"), cprs25_folder=str(root / "crf25" / "png"),
        cprs35_folder=str(root / "crf35" / "png"), qp_slice_file=str(root / "qp.json"),
        clips=[clip_index(c, T_FRAMES) for c in clips], centers=centers, gt_patch_size=16)


def _ldp_pair(root, centers, clips=("000", "001")):
    import pnp_vcve_tpu.data.datasets as jd
    import pnp_vcve_tpu.data.ldp as jl
    import pnp_vcve_torch.data.datasets as pd
    import pnp_vcve_torch.data.ldp as pl

    return (_ldp(jl.LDPTripleDataset, jd.ClipIndex, root, centers, clips),
            _ldp(pl.LDPTripleDataset, pd.ClipIndex, root, centers, clips))


@pytest.mark.parametrize("centers", ["pqf", "nonpqf"])
def test_ldp_triple_dataset_equals_jax(dataset_root, centers):  # noqa: F811
    """``sample`` (8 seeds: the CRF bucket, the centre, the crop and flips)
    and ``iter_test`` at CRF 15 and 25 bitwise equal to JAX's."""
    jds, pds = _ldp_pair(dataset_root, centers)
    for seed in range(8):
        a, b = jds.sample(np.random.default_rng(seed)), pds.sample(np.random.default_rng(seed))
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    for crf in (15, 25):
        ja, pa = list(jds.iter_test(crf=crf)), list(pds.iter_test(crf=crf))
        assert len(ja) == len(pa) > 0
        for a, b in zip(ja, pa):
            assert a["clip_name"] == b["clip_name"]
            for k in ("lq", "gt", "qps", "base_qps"):
                np.testing.assert_array_equal(b[k], a[k])


def _stdf_r1():
    cfg = dict(STDF_SMALL, radius=1, nb_stdf=2)
    jm, params = _jax_model("stdf", 12, (1, 3, 32, 48, 3), **cfg)
    return cfg, jm, params, _port("STDFNet", convert.stdf_state_dict(params), **cfg)


def test_evaluate_center_frame_dataset_matches_jax(dataset_root):  # noqa: F811
    """STDF over the non-PQF test triples of the fixture: the port's
    ``evaluate_center_frame_dataset`` means within 1e-6 of JAX's."""
    from pnp_vcve_tpu.models.restorer import CenterFrameRestorer as JaxRestorer
    from pnp_vcve_tpu.models.restorer import evaluate_center_frame_dataset as jax_eval
    from pnp_vcve_torch.models.restorer import CenterFrameRestorer, evaluate_center_frame_dataset

    _, jm, params, port = _stdf_r1()
    jds, pds = _ldp_pair(dataset_root, "nonpqf")
    want = jax_eval(JaxRestorer(generator=jm), params, jds.iter_test(crf=15), verbose=False)
    got = evaluate_center_frame_dataset(CenterFrameRestorer(generator=port),
                                        pds.iter_test(crf=15), verbose=False)
    assert sorted(got) == sorted(want) == ["PSNR", "SSIM"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), (k, got[k], want[k])


def _write_frames(d, frames):
    d.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:08d}.png")
    return str(d)


def test_video_inference_sliding_window_matches_jax(tmp_path):
    """``restoration_video_inference(window_size=3)`` with STDF (radius 1)
    through ``init_model``'s centre kind: each frame within 1e-5 of JAX's
    windows on a 5-frame clip, reflect-padded at both ends."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    cfg, _, params, port = _stdf_r1()
    frames = np.random.default_rng(13).integers(0, 256, (5, 32, 48, 3), dtype=np.uint8)
    clip = _write_frames(tmp_path / "clip", frames)
    config = dict(model=dict(type="STDF", generator=dict(type="STDFNet", **cfg)))
    jmodel = japis.init_model(config)
    jmodel.variables = {"params": params}
    want = japis.restoration_video_inference(jmodel, clip, window_size=3)
    model = apis.init_model(config, device="cpu")
    model.generator.load_state_dict(port.state_dict())
    got = apis.restoration_video_inference(model, clip, window_size=3)
    assert got.shape == (5, 32, 48, 3)
    _close(got, want, 1e-5)


def test_video_inference_whole_clip_bvpp_matches_jax(tmp_path):
    """Vanilla BasicVSR++ (8 channels, 1 block) through the image-input
    branch with ``window_size <= 0``: the whole clip within 1e-4 of JAX's
    ``apis``; ``max_seq_len=2`` gives the whole-clip runs of its pieces."""
    import pnp_vcve_tpu.models.baselines.basicvsr_pp as jb
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis
    from test_torch_port_baselines import SMALL, _jax_bvpp_params, _reference_sd

    mp = pytest.MonkeyPatch()  # JAX's DCN traced once, as test_torch_port_baselines does
    mp.setattr(jb, "modulated_deform_conv2d", jax.jit(jb.modulated_deform_conv2d))
    try:
        config = dict(model=dict(type="BasicVSR", generator=dict(type="BasicVSRPlusPlus",
                                                                 **SMALL)))
        model = apis.init_model(config, device="cpu")
        sd = _reference_sd(model.generator, 14)
        model.generator.load_state_dict({k: _t(v) for k, v in sd.items()})
        frames = np.random.default_rng(15).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
        clip = _write_frames(tmp_path / "clip", frames)
        jmodel = japis.init_model(config)
        jmodel.variables = {"params": _jax_bvpp_params(sd)}
        want = japis.restoration_video_inference(jmodel, clip)
        got = apis.restoration_video_inference(model, clip)
        assert got.shape == (3, 64, 96, 3)
        _close(got, want, 1e-4)
        pieces = apis.restoration_video_inference(model, clip, max_seq_len=2)
        with torch.inference_mode():
            lq = _t(frames / np.float32(255.0))[None]
            whole = torch.cat([model.generator(lq[:, :2])[0], model.generator(lq[:, 2:])[0]])
        _close(pieces, whole.numpy(), 1e-6)
    finally:
        mp.undo()


def test_builder_builds_the_new_types(dataset_root):  # noqa: F811
    """Every new backbone type and alias builds; the discriminator registry
    builds DCNGAN's under its aliases and refuses any other type citing
    item 8; the LDP datasets build through ``build_dataset`` with their
    centre class."""
    for cfg in (dict(type="STDFNet", **STDF_SMALL), dict(type="DCNGANNet", **DCNGAN_SMALL),
                dict(type="DCNGAN_Net", nf_fa=4, nb_fa=2, unknown_key=1),
                dict(type="DenseMWNetMiniPSNR", **MWGAN_SMALL),
                dict(type="DenseMWNet_Mini_PSNR", nf=8, nb=1, front_RBs=1, gc=4),
                dict(type="SIDECVSR", **SIDE_SMALL)):
        assert sum(p.numel() for p in build_generator(cfg, device="cpu").parameters()) > 0
    for typ in ("DCNGANDiscriminator", "Discriminator_UNet", "NLayerDiscriminator"):
        assert build_discriminator(dict(type=typ, d=4), device="cpu").conv1.out_channels == 4
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        build_discriminator(dict(type="StyleGAN2Discriminator"), device="cpu")
    common = dict(lq_folder=str(dataset_root / "crf15" / "png"),
                  gt_folder=str(dataset_root / "sharp" / "png"),
                  cprs15_folder=str(dataset_root / "crf15" / "png"),
                  cprs25_folder=str(dataset_root / "crf25" / "png"),
                  cprs35_folder=str(dataset_root / "crf35" / "png"),
                  sequence_length=T_FRAMES,
                  pipeline=[dict(type="LoadImageFromFileList_Mix_Compress_ipb", key="lq",
                                 qp_slice_file=str(dataset_root / "qp.json")),
                            dict(type="PairedRandomCrop_mv", gt_patch_size=16)])
    pqf = build_dataset(dict(type="LDPPQFDataset", **common))
    non = build_dataset(dict(type="LDPNonPQFDataset", **common))
    assert (pqf.centers, non.centers) == ("pqf", "nonpqf")
    s = non.sample(np.random.default_rng(0))
    assert s["lq"].shape == (3, 16, 16, 3) and s["gt"].shape == (1, 16, 16, 3)
