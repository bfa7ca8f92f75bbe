"""The port's adversarial training against the JAX package on the CPU:
``train/gan.py: make_gan_train_step`` (three steps against JAX's under
``lsgan`` and ``vanilla`` with the feature-matching term), the GAN losses,
the VGG perceptual and style loss on ``models/vgg.py`` (seeded VGG19 under
torchvision's names), and tools/torch_train.py's GAN path on a DCNGAN
config.

The step's generator is a small STDFNet (radius 1, 8 channels): it reads
the same window and ignores ``base_qps``, and its JAX compile is a fraction
of DCNGAN's QE module; the discriminator is DCNGAN's at d = 8 on 64x64
frames, the smallest side its VALID 4x4 head takes after four halvings.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pnp_vcve_torch.core import convert
from pnp_vcve_torch.core.builder import build_discriminator, build_generator, build_optimizer
from pnp_vcve_torch.train.state import TrainState

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GEN = dict(radius=1, nf_stdf=8, nb_stdf=2, nf_stdf_out=8, nf_qe=8, nb_qe=1)


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


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) > 1:
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes)


def _batch(rng):
    return {"lq": rng.random((2, 3, 64, 64, 3), np.float32),
            "gt": rng.random((2, 64, 64, 3), np.float32),
            "base_qps": np.full((2, 3), 37.0 / 255.0, np.float32)}


def _state(model):
    opt, sched = build_optimizer({"generator": dict(type="Adam", lr=1e-4,
                                                    betas=(0.9, 0.999))}, model)
    return TrainState(step=0, model=model, optimizer=opt, scheduler=sched)


# the discriminator's conv biases that feed a batch-statistics norm: the
# norm subtracts the batch mean, so their true gradient is 0 and each side's
# Adam steps on float rounding noise (up to lr a step, either sign)
NORMED_BIASES = ("conv2.bias", "conv3.bias", "conv4.bias")


def _assert_tree_close(got_sd, want_sd, atol, start=None):
    """Every entry within ``atol``; the entries of ``NORMED_BIASES`` (where
    ``start`` is given) each within three Adam steps of lr 1e-4 of their
    start on both sides."""
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        got = got_sd[k].detach().numpy()
        if start is not None and k in NORMED_BIASES:
            for side in (got, v.numpy()):
                np.testing.assert_allclose(side, start[k].numpy(), rtol=0, atol=3e-4 * 1.001,
                                           err_msg=k)
            continue
        np.testing.assert_allclose(got, v.numpy(), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("gan_type", ["lsgan", "vanilla"])
def test_gan_step_matches_jax(gan_type):
    """Three steps of ``make_gan_train_step`` (gan_weight 0.01, fm_weight 0.1,
    Adam 1e-4 for each network) against JAX's with ``optax.adam(1e-4)``:
    both networks' weights within 1e-5, each step's losses within 1e-5
    relative. The discriminator's biases in front of its batch-statistics
    norms have a true gradient of 0 (the norm subtracts them): each side
    moves them by rounding noise, so they are held to Adam's bound of three
    steps from their start instead."""
    from pnp_vcve_tpu.models.baselines.dcngan import DCNGANDiscriminator as JaxDisc
    from pnp_vcve_tpu.models.baselines.stdf import STDFNet as JaxGen
    from pnp_vcve_tpu.train.gan import make_gan_train_step as jax_step
    from pnp_vcve_tpu.train.state import create_train_state
    from pnp_vcve_torch.train.gan import make_gan_train_step

    jg, jd = JaxGen(**GEN), JaxDisc(d=8)
    gp = _fill(jax.eval_shape(lambda: jg.init(jax.random.PRNGKey(0),
                                              jnp.zeros((2, 3, 64, 64, 3))))["params"], 1)
    dp = _fill(jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0),
                                              jnp.zeros((2, 64, 64, 3))))["params"], 2)
    gen = build_generator(dict(type="STDFNet", **GEN), device="cpu")
    gen.load_state_dict(convert.stdf_state_dict(gp))
    disc = build_discriminator(dict(type="DCNGANDiscriminator", d=8), device="cpu")
    d_start = convert.dcngan_disc_state_dict(dp)
    disc.load_state_dict(d_start)

    kw = dict(gan_type=gan_type, gan_weight=0.01, fm_weight=0.1)
    jstep = jax_step(jg, jd, donate=False, **kw)
    js_g = create_train_state(gp, optax.adam(1e-4))
    js_d = create_train_state(dp, optax.adam(1e-4))
    step = make_gan_train_step(gen, disc, **kw)
    g_state, d_state = _state(gen), _state(disc)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = _batch(rng)
        js_g, js_d, jm = jstep(js_g, js_d, batch)
        g_state, d_state, m = step(g_state, d_state, {k: _t(v) for k, v in batch.items()})
        for k in ("loss_g", "loss_d"):
            want = float(jm[k])
            assert abs(float(m[k]) - want) <= 1e-5 * abs(want), (k, float(m[k]), want)
    assert g_state.step == d_state.step == 3
    _assert_tree_close(gen.state_dict(), convert.stdf_state_dict(js_g.params), 1e-5)
    _assert_tree_close(disc.state_dict(), convert.dcngan_disc_state_dict(js_d.params), 1e-5,
                       d_start)


def test_gan_losses_match_jax():
    """``gan_loss`` (lsgan and vanilla, real and fake targets, weighted) and
    ``feature_matching_loss`` against JAX's within 1e-6 relative."""
    from pnp_vcve_tpu.train import losses as jl
    from pnp_vcve_torch.train.losses import feature_matching_loss, gan_loss

    rng = np.random.default_rng(4)
    pred = (rng.standard_normal((2, 5, 5, 1)) * 3).astype(np.float32)
    for gan_type in ("lsgan", "vanilla"):
        for real in (True, False):
            want = float(jl.gan_loss(pred, real, gan_type, weight=0.5))
            got = float(gan_loss(_t(pred), real, gan_type, weight=0.5))
            assert abs(got - want) <= 1e-6 * abs(want)
    fake = [rng.standard_normal((2, s, s, 4)).astype(np.float32) for s in (8, 4, 2)]
    real = [rng.standard_normal(f.shape).astype(np.float32) for f in fake]
    want = float(jl.feature_matching_loss(fake, real, 0.1))
    got = float(feature_matching_loss([_t(f) for f in fake], [_t(r) for r in real], 0.1))
    assert abs(got - want) <= 1e-6 * abs(want)
    with pytest.raises(ValueError, match="gan_type"):
        gan_loss(_t(pred), True, "wgan")


def test_perceptual_loss_matches_jax_and_torchvision_names_load():
    """A seeded VGG19 under torchvision's names: its state dict, with a
    classifier entry beside it, loads back as it is through
    ``load_torchvision_vgg``; JAX takes it through ``convert_torchvision_vgg``.
    The perceptual and style terms at layers '3' and '8' (relu1_2,
    relu2_2; perceptual 1.0, style 0.5, l1) at 32x32 within 1e-5 relative
    of JAX's, and so is the prediction's gradient of their sum."""
    from pnp_vcve_tpu.models.vgg import convert_torchvision_vgg
    from pnp_vcve_tpu.train.losses import make_perceptual_loss as jax_perceptual
    from pnp_vcve_torch.models.vgg import VGGFeatures, load_torchvision_vgg
    from pnp_vcve_torch.train.losses import make_perceptual_loss

    vgg = VGGFeatures("vgg19")
    vgg.reset_parameters(torch.Generator().manual_seed(5))
    sd = dict(vgg.state_dict())
    assert sorted(k for k in sd if k.endswith("weight"))[0] == "features.0.weight"
    again = load_torchvision_vgg(VGGFeatures("vgg19"),
                                 {**sd, "classifier.0.weight": torch.zeros(4, 4)})
    for k, v in sd.items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)

    weights = {"3": 1.0, "8": 0.5}
    kw = dict(perceptual_weight=1.0, style_weight=0.5, criterion="l1")
    jfn = jax_perceptual(convert_torchvision_vgg(sd, "vgg19"), weights, vgg_type="vgg19", **kw)
    fn = make_perceptual_loss(vgg, weights, **kw)
    rng = np.random.default_rng(6)
    pred = rng.random((2, 32, 32, 3), np.float32)
    gt = rng.random((2, 32, 32, 3), np.float32)
    want = jfn(pred, gt)
    want_grad = jax.grad(lambda p: sum(jfn(p, gt)))(pred)
    x = _t(pred).requires_grad_(True)
    got = fn(x, _t(gt))
    sum(got).backward()
    for g, w in zip(got, want):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w)), (g.item(), float(w))
    scale = float(np.abs(want_grad).max())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-5 * scale)
    assert not any(p.requires_grad for p in vgg.parameters())


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """A DAVIS-layout fixture: 2 clips x 20 frames at 64x64, CRF 15/25/35
    and sharp, one qp.json for the three."""
    sys.path.insert(0, str(REPO / "tools" / "data"))
    from make_protocol_fixture import write_fixture

    root = tmp_path_factory.mktemp("davis_gan")
    merged = {}
    for crf in (15, 25, 35):
        write_fixture(root, clips=("bear", "boat"), frames=20, height=64, width=64, crf=crf,
                      seed=0, quiet=True)
        merged.update(json.loads((root / "qp.json").read_text()))
    (root / "qp.json").write_text(json.dumps(merged))
    return root


def test_train_cli_trains_dcngan(davis_root, tmp_path):
    """tools/torch_train.py --device cpu on a DCNGAN config (FA 4 / 2, d 8;
    3-frame windows, 64x64 crops, b = 2): 2 iterations log ``loss_g`` and
    ``loss_d`` each, change both networks' weights and write a checkpoint
    holding ``disc``; a resume from it continues the generator and its step
    for a third iteration while the discriminator starts fresh."""
    from pnp_vcve_torch.core.presets import train_dataset

    sys.path.insert(0, str(REPO / "tools"))
    import torch_train

    data = train_dataset("DAVISMultipleGTMixCompressDataset", str(davis_root), "sharp",
                         str(davis_root / "qp.json"))
    data["dataset"]["num_input_frames"] = 3
    crop = next(s for s in data["dataset"]["pipeline"] if s["type"] == "PairedRandomCrop_mv")
    crop["gt_patch_size"] = 64
    cfg = tmp_path / "dcngan.py"
    cfg.write_text(f"""
_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / 'HR_davis_LR_128x128.py')!r}]
model = dict(type='DCNGAN', generator=dict(type='DCNGANNet', nf_fa=4, nb_fa=2),
             discriminator=dict(type='DCNGANDiscriminator', d=8))
data = dict(train=[{data!r}], workers_per_gpu=2, train_dataloader=dict(samples_per_gpu=2))
optimizers = dict(generator=dict(type='Adam', lr=1e-4, betas=(0.9, 0.999)),
                  discriminator=dict(type='Adam', lr=1e-4, betas=(0.9, 0.999)))
log_config = dict(interval=1)
checkpoint_config = dict(interval=2, save_optimizer=False)
""")
    work = tmp_path / "w"
    state = torch_train.main([str(cfg), "--device", "cpu", "--work-dir", str(work),
                              "--total-iters", "2", "--deterministic"])
    assert state.step == 2
    log = (work / "train.log").read_text()
    for i in (1, 2):
        line = next(x for x in log.splitlines() if f"iter {i}/2 loss_g=" in x)
        lg = float(line.split("loss_g=")[1].split()[0])
        ld = float(line.split("loss_d=")[1].split()[0])
        assert np.isfinite(lg) and np.isfinite(ld)
    ckpt = torch.load(work / "ckpt" / "2.pth", weights_only=True)
    assert {"step", "model", "disc"} <= set(ckpt) and ckpt["step"] == 2
    g0 = build_generator(dict(type="DCNGANNet", nf_fa=4, nb_fa=2), device="cpu")
    d0 = build_discriminator(dict(type="DCNGANDiscriminator", d=8), device="cpu", seed=1)
    for m0, sd in ((g0, ckpt["model"]), (d0, ckpt["disc"]["model"])):
        assert any(not torch.equal(v, sd[k]) for k, v in m0.state_dict().items())

    state = torch_train.main([str(cfg), "--device", "cpu", "--work-dir", str(work),
                              "--total-iters", "3", "--resume-from", str(work)])
    assert state.step == 3
    assert "iter 3/3 loss_g=" in (work / "train.log").read_text()
    assert torch.load(work / "ckpt" / "3.pth", weights_only=True)["disc"]["step"] == 1
