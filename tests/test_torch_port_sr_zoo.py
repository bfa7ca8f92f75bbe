"""The port's recurrent super-resolution models against the JAX package on
the CPU: BasicVSR, IconVSR (with EDVR-M's refill) and RealBasicVSR
(carried by core/convert.py; IconVSR at padding 3 beside EDVR in
tests/test_torch_port_sr_zoo_window.py) forward and through
``restoration_video_inference``, the cascade into each through
tools/torch_test.py, the builder's zoo types, and every zoo model's
feature-warp launches through the K1 wrapper. The window and single-image
models are tests/test_torch_port_sr_zoo_window.py.

Weights: JAX params from ``jax.eval_shape`` of the init, filled with seeded
numpy (N(0, 1 / fan_in) kernels, N(0, 0.04) biases), so that the DCN offset
heads of EDVR and TDAN, zero at init, are not zero: a transposed offset
layout shows. Sizes are small (8 channels, 1-2 blocks, 20x28 frames:
EDVR's quarter level is then an odd 5x7); JAX's DCN and flow warp are
jitted once per shape, each JAX model once per form, and JAX's API reuses
that compiled apply.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pnp_vcve_torch.core import convert
from pnp_vcve_torch.core.builder import build_generator

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REC = dict(mid_channels=8, num_blocks=1)
SMALL = {
    "basicvsr": ("BasicVSRNet", REC),
    "iconvsr": ("IconVSRNet", dict(REC, keyframe_stride=2, padding=2)),
    "edvr": ("EDVRNet", dict(mid_channels=8, deform_groups=2, num_blocks_extraction=1,
                             num_blocks_reconstruction=1)),
    "tdan": ("TDANNet", dict(mid_channels=8, num_blocks_before_align=1,
                             num_blocks_after_align=1)),
    "toflow": ("TOFlow", {}),
    "real": ("RealBasicVSRNet", dict(mid_channels=8, num_propagation_blocks=1,
                                     num_cleaning_blocks=2)),
    "edsr": ("EDSR", dict(mid_channels=8, num_blocks=2)),
    "rrdb": ("RRDBNet", dict(mid_channels=8, num_blocks=1, growth_channels=4)),
    "msr": ("MSRResNet", dict(mid_channels=8, num_blocks=2)),
    "srcnn": ("SRCNN", dict(channels=(3, 16, 8, 3))),
    "rdn": ("RDN", dict(mid_channels=8, num_blocks=2, num_layers=2, channel_growth=4)),
}
CARRIER = {"basicvsr": convert.basicvsr_state_dict, "iconvsr": convert.iconvsr_state_dict,
           "edvr": convert.edvr_state_dict, "tdan": convert.tdan_state_dict,
           "toflow": convert.toflow_state_dict, "real": convert.realbasicvsr_state_dict}
SISR = ("edsr", "rrdb", "msr", "srcnn", "rdn")
RECURRENT = ("basicvsr", "iconvsr", "real")
# the window models' frame counts; the recurrent models run 5-frame clips
FRAMES = {"edvr": 5, "tdan": 5, "toflow": 7}
HW = (20, 28)


@pytest.fixture(scope="module", autouse=True)
def _jax_ops_traced_once():
    """JAX's DCN and flow warp through jitted wrappers in the zoo's modules,
    so that each shape is traced once; the functions computed are JAX's
    own."""
    import pnp_vcve_tpu.models.baselines.basicvsr as jb
    import pnp_vcve_tpu.models.baselines.edvr as je
    import pnp_vcve_tpu.models.baselines.tdan as jt
    import pnp_vcve_tpu.models.baselines.tof as jf

    mp = pytest.MonkeyPatch()
    for mod in (je, jt):
        mp.setattr(mod, "modulated_deform_conv2d", jax.jit(mod.modulated_deform_conv2d))
    for mod in (jb, jf):
        mp.setattr(mod, "flow_warp", jax.jit(mod.flow_warp))
    yield
    mp.undo()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) > 1:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes)


def _module(name, **cfg):
    from pnp_vcve_tpu.models.baselines import basicvsr, edvr, sisr, tdan, tof

    return dict(basicvsr=basicvsr.BasicVSRNet, iconvsr=basicvsr.IconVSRNet, edvr=edvr.EDVRNet,
                tdan=tdan.TDANNet, toflow=tof.TOFlow, real=tof.RealBasicVSRNet, edsr=sisr.EDSR,
                rrdb=sisr.RRDBNet, msr=sisr.MSRResNet, srcnn=sisr.SRCNN,
                rdn=sisr.RDN)[name](**cfg)


@functools.lru_cache(maxsize=None)
def _jax(name, shape, seed, **cfg):
    """(jitted JAX apply, seeded params) for inputs of ``shape``."""
    model = _module(name, **cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros(shape, jnp.float32)))["params"]
    return jax.jit(model.apply), _fill(shapes, seed)


def _pair(name, shape, seed=1, **over):
    """(JAX apply, params, the port's model carrying them) for ``name``."""
    typ, cfg = SMALL[name]
    cfg = dict(cfg, **over)
    apply, params = _jax(name, shape, seed, **cfg)
    port = build_generator(dict(type=typ, **cfg), device="cpu")
    port.load_state_dict(CARRIER.get(name, convert.sisr_state_dict)(params), strict=True)
    return apply, params, port.eval()


def _input_shape(name, t=None):
    if name in SISR:
        return (1, *HW, 3)
    return (1, t or FRAMES.get(name, 5), *HW, 3)


def _check_model(name, t=None, **over):
    """The port's forward against JAX's within 1e-4 on seeded frames (each
    output of a pair)."""
    shape = _input_shape(name, t)
    apply, params, port = _pair(name, shape, **over)
    x = np.random.default_rng(2).random(shape, np.float32)
    want = apply({"params": params}, x)
    with torch.inference_mode():
        got = port(_t(x))
    for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
        _close(g, w)


def _write_frames(d, frames):
    d.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:08d}.png")
    return str(d)


def _api_models(name, **over):
    """(JAX InferenceModel, the port's through ``init_model``) for a
    ``BasicVSR``-kind config of ``name``, both on the seeded params of
    ``_pair``; JAX's API calls the compiled apply of the model tests."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    typ, cfg = SMALL[name]
    cfg = dict(cfg, **over)
    apply, params, _ = _pair(name, _input_shape(name), **over)
    config = dict(model=dict(type="BasicVSR", generator=dict(type=typ, **cfg)))
    jmodel = japis.init_model(config)
    jmodel.variables = {"params": params}
    jmodel._jitted.update(video=apply, sisr=apply)
    model = apis.init_model(config, device="cpu")
    model.generator.load_state_dict(CARRIER.get(name, convert.sisr_state_dict)(params))
    return jmodel, model


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """A 5-frame PNG clip at ``HW``."""
    frames = np.random.default_rng(6).integers(0, 256, (5, *HW, 3), dtype=np.uint8)
    return _write_frames(tmp_path_factory.mktemp("zoo") / "clip", frames)


def _close(got, want, atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


# ---- each model against JAX ----------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_model_matches_jax(name):
    """BasicVSR, IconVSR (padding 2, stride 2: keyframes 0, 2, 4) and
    RealBasicVSR carried by core/convert.py: forward within 1e-4 of JAX on 5
    frames at 20x28. IconVSR at padding 3 is in
    tests/test_torch_port_sr_zoo_window.py, beside EDVR."""
    _check_model(name)


def test_mirror_indices_are_jax_gathers():
    """``mirror_indices`` picks the frames JAX's ``lrs[:, jnp.asarray(idx)]``
    gathers for IconVSR's end padding (negative indices wrapped, then
    clamped) at every clip length from 1 to 9."""
    from pnp_vcve_torch.models.baselines.basicvsr import _MIRROR, mirror_indices

    for p, (front, back) in _MIRROR.items():
        for t in range(1, 10):
            frames = jnp.arange(t)
            want = np.concatenate([frames[jnp.asarray(front)], frames,
                                   frames[jnp.asarray(back)]])
            assert mirror_indices(t, p) == want.tolist(), (p, t)


def test_realbasicvsr_returns_cleaned_frames_as_jax():
    """``return_lqs=True``: the x4 clip and the cleaned LR frames within 1e-4
    of JAX's."""
    shape = _input_shape("real")
    _, params, port = _pair("real", shape)
    apply = jax.jit(functools.partial(_module("real", **SMALL["real"][1]).apply,
                                      return_lqs=True))
    x = np.random.default_rng(3).random(shape, np.float32)
    want = apply({"params": params}, x)
    with torch.inference_mode():
        got = port(_t(x), return_lqs=True)
    _close(got[0], want[0])
    _close(got[1], want[1])


# ---- builder and launch counts --------------------------------------------------------------


def test_builder_builds_each_type_from_jax_keys():
    """Every zoo type and alias of JAX's builder builds from its config keys
    (keys JAX drops are dropped) with the class JAX's builds; a type the port
    does not have cites item 8."""
    from pnp_vcve_torch.models import baselines

    aliases = {"IconVSR": "IconVSRNet", "TOF": "TOFlow", "RRDBNetESRGAN": "RRDBNet",
               "ModifiedSRResNet": "MSRResNet"}
    for typ in [t for t, _ in SMALL.values()] + list(aliases):
        cls = aliases.get(typ, typ)
        cfg = next(c for t, c in SMALL.values() if t == cls)
        model = build_generator(dict(cfg, type=typ, pretrained=None, unknown_key=1),
                                device="cpu", seed=2)
        assert type(model) is getattr(baselines, cls)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        build_generator(dict(type="ResnetGenerator"), device="cpu")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_feature_warp_launches(monkeypatch, name):
    """Through the K1 wrapper with its plain version standing in for the
    launch: BasicVSR, IconVSR and RealBasicVSR launch K1 2 (t - 1) times a
    clip (each sweep warps from its second step); the other models launch
    none. The output equals the plain ops' bit for bit."""
    import pnp_vcve_torch.kernels.warp as kw
    from pnp_vcve_torch.kernels import KERNELS, PLAIN

    count = []
    monkeypatch.setattr(kw, "_launch", lambda x, f: count.append(1) or kw.flow_warp_plain(x, f))
    typ, cfg = SMALL[name]
    model = build_generator(dict(type=typ, **cfg), device="cpu", seed=3).eval()
    shape = _input_shape(name)
    x = _t(np.random.default_rng(5).random(shape, np.float32))
    owners = [m for m in model.modules() if hasattr(m, "ops")]
    with torch.inference_mode():
        got = model(x)
        for m in owners:
            m.ops = PLAIN
        want = model(x)
        for m in owners:
            m.ops = KERNELS
    assert len(count) == (2 * (shape[1] - 1) if name in RECURRENT else 0)
    for g, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---- the video API --------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_video_inference_matches_jax(clip_dir, name):
    """``restoration_video_inference`` over a 5-frame PNG clip: each frame
    within 1e-4 of JAX's function on the same weights; with ``max_seq_len=3``
    the port's output is its whole-clip runs of the pieces (3 and 2
    frames)."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    jmodel, model = _api_models(name)
    want = japis.restoration_video_inference(jmodel, clip_dir)
    got = apis.restoration_video_inference(model, clip_dir)
    assert got.shape == (5, 4 * HW[0], 4 * HW[1], 3)
    _close(got, want)
    pieces = apis.restoration_video_inference(model, clip_dir, max_seq_len=3)
    lq = _t(apis._read_frame_dir(clip_dir, "{:08d}.png", 0))[None]
    with torch.inference_mode():
        whole = torch.cat([model.generator(lq[:, :3])[0], model.generator(lq[:, 3:])[0]])
    _close(pieces, whole.numpy(), 1e-6)


# ---- the cascade ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_cli_cascade_into_zoo_model(tmp_path, name):
    """``tools/torch_test.py --cascade --cascade_config`` a BasicVSR,
    IconVSR or RealBasicVSR config (its seeded checkpoint under
    ``generator.`` names): finite metrics against the x4 GT, x4 PNGs, and
    the metrics equal the harness's own cascade on the same models."""
    from test_torch_port_cascade import ENHANCER, _cli, _test_data, _write_clips

    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.models.restorer import Restorer
    from pnp_vcve_torch.train.eval import evaluate_dataset

    root = tmp_path / "data"
    _write_clips(root, ["000"], 4, 32, 32, "X4/png", 4)
    (tmp_path / "enh.py").write_text(ENHANCER + _test_data(root, "X4/png", 4))
    typ, cfg = SMALL[name]
    (tmp_path / "vsr.py").write_text(f"model = dict(type='BasicVSR', generator="
                                     f"{dict(type=typ, **cfg)!r})\n")
    vsr = build_generator(dict(type=typ, **cfg), device="cpu", seed=7).eval()
    torch.save({"state_dict": {f"generator.{k}": v for k, v in vsr.state_dict().items()}},
               tmp_path / "vsr.pth")
    out = tmp_path / "out"
    metrics = _cli().main([str(tmp_path / "enh.py"), "-", "--device", "cpu", "--cascade",
                           "--cascade_config", str(tmp_path / "vsr.py"), "--cascade_ckpt",
                           str(tmp_path / "vsr.pth"), "--save-path", str(out), "--save-image"])
    assert set(metrics) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in metrics.values())
    assert np.asarray(Image.open(out / "000" / "00000003.png")).shape == (128, 128, 3)

    enh_cfg = Config.fromfile(tmp_path / "enh.py")
    enh = build_restorer(enh_cfg.model, enh_cfg.get("test_cfg"), device="cpu")
    enh.generator.reset_parameters(torch.Generator().manual_seed(0))
    want = evaluate_dataset(enh, build_dataset(dict(enh_cfg.data["test"])), verbose=False,
                            cascade=(vsr, Restorer(generator=vsr)))
    assert metrics == want
