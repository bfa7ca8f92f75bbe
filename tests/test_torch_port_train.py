"""The port's training path against the JAX package's, on the CPU in float32
at a small size (16 channels, 2 blocks, 3 experts; the port runs its
kernels' plain versions here).

Weights are drawn by the port and carried to the JAX side through
``pnp_vcve_tpu.core.convert``; gradients and parameters come back through
``pnp_vcve_torch.core.convert.from_jax_params``. Inputs are made with numpy.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.core.builder import build_generator, build_optimizer
from pnp_vcve_torch.core.convert import from_jax_params
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import warp as kw
from pnp_vcve_torch.train.state import TrainState
from pnp_vcve_torch.train.train_step import make_train_step

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(mid_channels=16, num_blocks=2, num_experts=3)
# the flagship optimizer and schedule (configs/HR_davis_LR_128x128.py:19-28)
OPTIMIZERS = dict(generator=dict(type="Adam", lr=2e-4, betas=(0.9, 0.99)))
LR_CONFIG = dict(policy="CosineRestart", by_epoch=False, periods=[300000],
                 restart_weights=[1], min_lr=1e-7)


def _jax_params(model):
    # copies: JAX's CPU arrays may alias numpy memory, and the port's
    # optimizer updates its parameters in place while JAX's step may still
    # be reading them
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    return convert_generator_state_dict(sd, num_blocks=SMALL["num_blocks"])


def _batch(rng, b=2, t=3, h=16, w=16):
    slices = np.array([[73, 66, 80, 66][:t], [66, 80, 66, 66][:t]], np.float32)[:b]
    return dict(
        lq=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=slices,
        mvs=rng.uniform(-6.0, 6.0, (b, t, h, w, 4)).astype(np.float32),
        base_qps=(rng.choice([0, 15, 25, 35], (b, 1)).repeat(t, 1) / 255.0).astype(np.float32),
        partitions=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h, w))] / 255.0,
        gt=rng.random((b, t, h, w, 3), np.float32),
    )


def _model_kwargs(batch, to):
    keys = dict(lrs="lq", qps="qps", slices="slices", mvs="mvs", base_qps="base_qps",
                par_map="partitions")
    return {k: to(batch[v]) for k, v in keys.items()}


# ---- (a) gradients against jax.grad ------------------------------------------------


@pytest.fixture(scope="module")
def grad_case():
    """One batch, the port's weights, and jax.grad of the JAX model's
    Charbonnier loss (remat=False, padgather) in the port's layout."""
    from pnp_vcve_tpu.train.losses import charbonnier_loss

    rng = np.random.default_rng(0)
    batch = _batch(rng, t=4)
    model = build_generator(dict(type="PnPVCVE", **SMALL), device="cpu", seed=5)
    jm = JaxPnPVCVE(**SMALL, remat=False, warp_impl="padgather")
    inputs = _model_kwargs(batch, jnp.asarray)
    grads = jax.jit(jax.grad(
        lambda p: charbonnier_loss(jm.apply({"params": p}, **inputs), jnp.asarray(batch["gt"]))
    ))(_jax_params(model))
    return batch, model.state_dict(), from_jax_params(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("remat", [True, False])
def test_grads_match_jax(grad_case, remat):
    """Every parameter's gradient equals jax.grad's at the bound of
    tests/test_kernels.py:356, with and without the step recompute."""
    from pnp_vcve_torch.train.losses import charbonnier_loss

    batch, sd, want = grad_case
    model = build_generator(dict(type="PnPVCVE", **SMALL, remat=remat), device="cpu")
    model.load_state_dict(sd)
    loss = charbonnier_loss(model(**_model_kwargs(batch, torch.from_numpy)),
                            torch.from_numpy(batch["gt"]))
    loss.backward()
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=2e-4, rtol=1e-3,
                                   err_msg=name)


# ---- (b), (c) five flagship-optimizer steps against JAX's train step --------------


@pytest.mark.parametrize("fix_iter", [0, 2], ids=["steps", "fix_iter"])
def test_train_steps_match_jax(fix_iter):
    """Five steps of the port's train step with the flagship Adam and
    schedule end within 1e-5 of JAX's. With ``fix_iter=2`` the CAA routing
    MLP is frozen for two steps: it does not move while frozen, and after
    the freeze its Adam steps count from the global step, as optax's do."""
    from pnp_vcve_tpu.core.builder import build_optimizer as jax_build_optimizer
    from pnp_vcve_tpu.train import create_train_state
    from pnp_vcve_tpu.train import make_train_step as jax_make_train_step

    rng = np.random.default_rng(1)
    batches = [_batch(rng) for _ in range(5)]
    model = build_generator(dict(type="PnPVCVE", **SMALL), device="cpu", seed=5)

    jm = JaxPnPVCVE(**SMALL, remat=False)
    jstate = create_train_state(_jax_params(model),
                                jax_build_optimizer(OPTIMIZERS, LR_CONFIG, 300000))
    jstep = jax_make_train_step(jm, fix_iter=fix_iter, freeze_prefixes=("base_predictor",),
                                donate=False)

    optimizer, scheduler = build_optimizer(OPTIMIZERS, model, LR_CONFIG, 300000)
    state = TrainState(0, model, optimizer, scheduler)
    step = make_train_step(model, fix_iter=fix_iter, freeze_prefixes=("BasePredictor",))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i, b in enumerate(batches):
        jstate, jm_metrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(metrics["loss"]), float(jm_metrics["loss"]), rtol=1e-5)
        if i + 1 == fix_iter:
            for k, v in model.state_dict().items():
                if k.startswith("BasePredictor"):
                    torch.testing.assert_close(v, start[k], rtol=0, atol=0)
    assert state.step == 5 and scheduler.last_epoch == 5
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        assert float((v - start[k]).abs().max()) > 1e-4, k  # every tensor moved
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


# ---- (d) the schedule ------------------------------------------------------------------


def test_cosine_restart_schedule_matches_optax():
    from pnp_vcve_tpu.train.schedule import cosine_restart_schedule as jax_schedule
    from pnp_vcve_torch.train.schedule import cosine_restart_schedule

    args = (2e-4, [10, 20], [1.0, 0.5], 1e-7)
    ours, ref = cosine_restart_schedule(*args), jax_schedule(*args)
    # start, mid, end of period 1 (= restart), mid and end of period 2, past
    # the end; optax computes in float32, the port in float64
    for step in (0, 5, 9, 10, 11, 20, 29, 30, 45):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, err_msg=str(step))
    flagship = cosine_restart_schedule(2e-4, [300000], [1], 1e-7)
    assert flagship(0) == 2e-4 and abs(flagship(300000) - 1e-7) < 1e-15


# ---- (e) the loader ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """A DAVIS-layout fixture: 2 clips x 20 frames at 32x32, CRF 15/25/35
    and sharp, one qp.json for the three (make_protocol_fixture.py writes
    one CRF per call and its qp.json each time)."""
    sys.path.insert(0, str(REPO / "tools" / "data"))
    from make_protocol_fixture import write_fixture

    root = tmp_path_factory.mktemp("davis")
    merged = {}
    for crf in (15, 25, 35):
        write_fixture(root, clips=("bear", "boat"), frames=20, height=32, width=32, crf=crf,
                      seed=0, quiet=True)
        merged.update(json.loads((root / "qp.json").read_text()))
    (root / "qp.json").write_text(json.dumps(merged))
    return root


def _train_cfg(root, patch=16, frames=4):
    from pnp_vcve_torch.core.presets import train_dataset

    cfg = train_dataset("DAVISMultipleGTMixCompressDataset", str(root), "sharp",
                        str(root / "qp.json"))
    cfg["dataset"]["num_input_frames"] = frames
    crop = next(s for s in cfg["dataset"]["pipeline"] if s["type"] == "PairedRandomCrop_mv")
    crop["gt_patch_size"] = patch
    return cfg


@pytest.mark.parametrize("threads", [1, 2])
def test_loader_batches_equal_jax(fixture_root, threads):
    """The port's DAVIS dataset and prefetch loader give the JAX package's
    batches bit for bit for one seed, whatever the thread count, and a
    loader started at step 2 gives step 2's batch."""
    from pnp_vcve_tpu.core.builder import build_train_datasets as jax_datasets
    from pnp_vcve_tpu.data.loader import PrefetchLoader as JaxLoader
    from pnp_vcve_tpu.data.loader import WeightedMixture as JaxMixture
    from pnp_vcve_torch.core.builder import build_train_datasets
    from pnp_vcve_torch.data.loader import PrefetchLoader, WeightedMixture

    cfgs = [_train_cfg(fixture_root)] * 2
    jl = JaxLoader(JaxMixture(jax_datasets(cfgs), [1, 2]), batch_size=3, seed=7, num_threads=2)
    mix = WeightedMixture(build_train_datasets(cfgs), [1, 2])
    ours = PrefetchLoader(mix, batch_size=3, seed=7, num_threads=threads)
    later = PrefetchLoader(mix, batch_size=3, seed=7, num_threads=threads, start_step=2)
    try:
        want = [next(iter(jl)) for _ in range(3)]
        got = [next(iter(ours)) for _ in range(3)]
        got_later = next(iter(later))
    finally:
        for loader in (jl, ours, later):
            loader.stop()
    assert set(got[0]) == set(want[0]) and got[0]["lq"].shape == (3, 4, 16, 16, 3)
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    for k in want[2]:
        np.testing.assert_array_equal(got_later[k].numpy(), np.asarray(want[2][k]), err_msg=k)


def test_loader_threads_stress():
    """More worker threads than cores and a tiny switch interval: every step
    is built once and comes out in order with its own draws (a lost or
    doubled claim would skip, repeat or reorder a batch)."""
    from pnp_vcve_torch.data.loader import PrefetchLoader

    class Source:
        def sample(self, rng):
            return {"x": rng.random((2,)).astype(np.float32)}

    def want(step):
        rngs = [np.random.default_rng(np.random.SeedSequence([3, step, s])) for s in range(2)]
        return np.stack([r.random((2,)).astype(np.float32) for r in rngs])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    loader = PrefetchLoader(Source(), batch_size=2, seed=3, num_threads=32, prefetch=1,
                            start_step=5)
    try:
        it = iter(loader)
        for step in range(5, 205):
            np.testing.assert_array_equal(next(it)["x"].numpy(), want(step))
    finally:
        sys.setswitchinterval(interval)
        loader.stop()
    assert not any(t.is_alive() for t in loader._threads)


# ---- (f), (g) the training CLI ----------------------------------------------------------


def _write_cli_cfg(tmp_path, root):
    cfg = tmp_path / "tiny_train.py"
    cfg.write_text(f"""
_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / 'HR_davis_LR_128x128.py')!r}]
from pnp_vcve_torch.core.presets import flagship_data
model = dict(generator=dict(mid_channels=8, num_blocks=1, num_experts=2))
data = flagship_data(test_lq={str(root / 'crf25' / 'png')!r}, test_gt={str(root / 'sharp' / 'png')!r},
                     test_qp_json={str(root / 'qp.json')!r})
data["train"] = [{_train_cfg(root)!r}]
data["train_dataloader"]["samples_per_gpu"] = 2
data["workers_per_gpu"] = 2
data["test"].update(type="SRFolderMultipleGTDataset", num_input_frames=3)
log_config = dict(interval=1)
checkpoint_config = dict(interval=2)
""")
    return cfg


def _cli(name):
    sys.path.insert(0, str(REPO / "tools"))
    return __import__(name)


def test_train_cli_resume_equals_uninterrupted_run(fixture_root, tmp_path):
    """tools/torch_train.py --device cpu: 4 iterations equal 2 iterations, a
    checkpoint and a resume for 2 more, bit for bit (weights, Adam state,
    schedule)."""
    train = _cli("torch_train")
    cfg = str(_write_cli_cfg(tmp_path, fixture_root))
    full, part = tmp_path / "full", tmp_path / "part"
    train.main([cfg, "--device", "cpu", "--work-dir", str(full), "--total-iters", "4"])
    train.main([cfg, "--device", "cpu", "--work-dir", str(part), "--total-iters", "2"])
    state = train.main([cfg, "--device", "cpu", "--work-dir", str(part), "--total-iters", "4",
                        "--resume-from", str(part)])
    assert state.step == 4
    a = torch.load(full / "ckpt" / "4.pth", weights_only=True)
    b = torch.load(part / "ckpt" / "4.pth", weights_only=True)
    assert sorted((full / "ckpt").iterdir()) == [full / "ckpt" / "2.pth", full / "ckpt" / "4.pth"]
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)
    assert a["scheduler"]["last_epoch"] == b["scheduler"]["last_epoch"] == 4
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(b["optimizer"]["state"][i][k], v, rtol=0, atol=0)


def test_port_and_clis_import_no_jax(fixture_root, tmp_path):
    """One process imports every module of pnp_vcve_torch (serving, apis,
    parallel, utils and the baselines among them), runs the CLIs on the CPU
    (the train CLI also as a one-rank torchrun world with --launcher
    pytorch, the KITTI CLI on a KITTI-layout fixture, the test CLI also as
    the exact pipeline's stream over two chunks, the cascade into
    BasicVSR++ and the MFQE joint protocol), a batched dispatch and an exact
    one, the overlapped-window eval, the serving curve, the packager, the
    handler, the protocol tool's exact leg, the five probe tools (K6-K13's
    plain versions at small shapes), the five deployment tools (export
    with --verify, the deploy test of its artifact, the parity gate's asset
    mode, publish and the FLOP count) and a centre-frame model (STDF)
    through the video API's sliding window; neither jax nor any
    pnp_vcve_tpu module gets imported (the centre-frame baselines, PAC,
    the wavelets, the GAN step and VGG among the modules)."""
    cfg = _write_cli_cfg(tmp_path, fixture_root)
    ckpt = tmp_path / "w" / "ckpt" / "1.pth"
    # the cascade into a same-size BasicVSR++, the joint protocol on MFQEv2
    vsr_cfg, mfqe_cfg = tmp_path / "vsr.py", tmp_path / "mfqe.py"
    vsr_cfg.write_text('model = dict(type="BasicVSR", generator=dict(type="BasicVSRPlusPlus", '
                       'mid_channels=8, num_blocks=1, deform_groups=2, is_low_res_input=False))\n')
    mfqe_cfg.write_text(cfg.read_text() + '\nmodel = dict(type="MFQEv2Restorer", '
                        'generator=dict(type="MFQEv2", nf=4))\n')
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'tools')!r}]
import numpy as np
import pnp_vcve_torch
mods = [m.name for m in pkgutil.walk_packages(pnp_vcve_torch.__path__, "pnp_vcve_torch.")]
for m in mods:
    importlib.import_module(m)
assert {{"pnp_vcve_torch.models.baselines.basicvsr_pp", "pnp_vcve_torch.models.baselines.mfqev2",
         "pnp_vcve_torch.models.spynet", "pnp_vcve_torch.data.ldp",
         "pnp_vcve_torch.data.extra_datasets", "pnp_vcve_torch.utils.logging",
         "pnp_vcve_torch.train.ema", "pnp_vcve_torch.train.visualization",
         "pnp_vcve_torch.models.baselines.stdf", "pnp_vcve_torch.models.baselines.dcngan",
         "pnp_vcve_torch.models.baselines.mwgan", "pnp_vcve_torch.models.baselines.sidecvsr",
         "pnp_vcve_torch.ops.pac", "pnp_vcve_torch.ops.wavelet", "pnp_vcve_torch.train.gan",
         "pnp_vcve_torch.models.vgg"}} <= set(mods)
import torch_test, torch_train, torch_serving_curve, torch_pnp2servable, torch_serving_handler
import torch_kernel_bounds, torch_protocol_eval, torch_test_kitti
import torch_int8_probe, torch_warp_kernel_probe2, torch_warp_bisect
import torch_warp_kernel_probe, torch_dma_probe
import torch_export_model, torch_deploy_test, torch_parity_check, torch_publish_model
import torch_get_flops
from pnp_vcve_torch import apis, serving
torch_train.main([{str(cfg)!r}, "--device", "cpu", "--work-dir", {str(tmp_path / 'w')!r},
                  "--total-iters", "1"])
torch_test.main([{str(cfg)!r}, {str(ckpt)!r}, "--device", "cpu"])
import os, socket
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(s.getsockname()[1]))
torch_train.main([{str(cfg)!r}, "--device", "cpu", "--work-dir", {str(tmp_path / 'wd')!r},
                  "--total-iters", "1", "--launcher", "pytorch", "--deterministic"])
sys.path.insert(0, {str(REPO / 'tools' / 'data')!r})
from make_kitti_fixture import write_kitti_fixture
kitti = write_kitti_fixture({str(tmp_path / 'kitti')!r}, height=16, width=24)
assert torch_test_kitti.main([{str(cfg)!r}, {str(ckpt)!r}, "--device", "cpu",
                              "--testdir_lr", str(kitti / "crf15" / "png"),
                              "--testdir_gt", str(kitti / "clean"),
                              "--qp-slice-file", str(kitti / "qp.json")])
torch_test.main([{str(cfg)!r}, {str(ckpt)!r}, "--device", "cpu", "--frame-parallel", "exact",
                 "--stream-clips", "2", "--pipeline-devices", "cpu,cpu"])
torch_test.main([{str(cfg)!r}, {str(ckpt)!r}, "--device", "cpu", "--cascade",
                 "--cascade_config", {str(vsr_cfg)!r}])
torch_test.main([{str(mfqe_cfg)!r}, "-", "--device", "cpu", "--joint-pqf-config",
                 {str(mfqe_cfg)!r}])
stdf = apis.init_model(dict(model=dict(type="STDF", generator=dict(
    type="STDFNet", radius=1, nf_stdf=4, nb_stdf=2, nf_stdf_out=4, nf_qe=4, nb_qe=1))),
    device="cpu")
assert apis.restoration_video_inference(stdf, {str(fixture_root / 'crf25' / 'png' / 'bear')!r},
                                        window_size=3).shape == (20, 32, 32, 3)
model = apis.init_model({str(cfg)!r}, {str(ckpt)!r}, device="cpu")
run = serving.batched_forward_executor(model.generator)
sample = dict(lq=np.zeros((2, 8, 8, 3), np.float32), qps=np.zeros(2, np.float32),
              slices=np.full(2, 73.0, np.float32), mvs=np.zeros((2, 8, 8, 4), np.float32),
              base_qps=np.zeros(2, np.float32), partitions=np.zeros((2, 8, 8, 3), np.float32))
assert [o.shape for o in run([sample, sample])] == [(2, 8, 8, 3)] * 2
exact = serving.exact_stream_executor(model.generator, ["cpu", "cpu"])
assert [o.shape for o in exact([sample, sample])] == [(2, 8, 8, 3)] * 2
from pnp_vcve_torch.train.eval import enhance_clip_frame_parallel
assert enhance_clip_frame_parallel(model.generator, sample, ["cpu"], 1, 1).shape == (2, 8, 8, 3)
torch_protocol_eval.main(["--device", "cpu", "--root", {str(tmp_path / 'proto')!r}, "--frames",
                          "2", "--height", "16", "--width", "16", "--clips", "000",
                          "--skip-card", "--exact-mid", "8", "--exact-blocks", "1",
                          "--exact-experts", "2"])
torch_serving_curve.main(["--device", "cpu", "--config", {str(cfg)!r}, "--max-b", "1",
                          "--t", "2", "--hw", "8", "8", "--iters", "1"])
srv = torch_pnp2servable.main([{str(cfg)!r}, {str(ckpt)!r}, "--output-folder",
                               {str(tmp_path / 'srv')!r}])
h = torch_serving_handler.PnPServingHandler()
h.initialize(srv, device="cpu")
import io
from PIL import Image
buf = io.BytesIO()
Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="PNG")
assert Image.open(io.BytesIO(h.handle(buf.getvalue()))).size == (8, 8)
probe_runs = [
    torch_int8_probe.main(["--device", "cpu", "--mkn", "64", "32", "16", "--band", "6", "20",
                           "32", "--out", "4", "18", "--n", "1"]),
    torch_warp_kernel_probe2.main(["--device", "cpu", "--hw", "16", "256", "--channels", "16",
                                   "--n", "1"]),
    torch_warp_bisect.main(["dma64", "nodma64", "fori64", "--device", "cpu", "--hw", "32", "256"]),
    torch_warp_kernel_probe.main(["--device", "cpu", "--hw", "16", "256", "--channels", "8",
                                  "--n", "1"]),
    torch_dma_probe.main(["--device", "cpu", "--hw", "16", "16", "--split", "2", "--n", "1",
                          "--chain", "2"]),
]
assert all(r["out"] is not None for run in probe_runs for r in run.values())
pt2 = {str(tmp_path / 'tiny.pt2')!r}
exported = torch_export_model.main([{str(cfg)!r}, {str(ckpt)!r}, pt2, "--shape", "3", "16", "16",
                                    "--verify", "--device", "cpu"])
assert exported["ops"] == {{"flow_warp": 6, "input_conv": 6, "drt_block": 6, "head": 3}}
per_clip, mean = torch_deploy_test.main([{str(cfg)!r}, pt2, "--device", "cpu"])
assert len(per_clip) == 2 and set(mean) == {{"PSNR", "SSIM"}}
published = torch_publish_model.main([{str(ckpt)!r}, {str(tmp_path / 'pub' / 'tiny')!r}])
try:
    torch_parity_check.main([{str(cfg)!r}, str(published), "--testdir_lr",
                             {str(fixture_root / 'crf25' / 'png')!r}, "--testdir_gt",
                             {str(fixture_root / 'sharp' / 'png')!r}, "--device", "cpu",
                             "--num-blocks", "1"])
except SystemExit as e:
    assert e.code == 0, e.code
assert torch_get_flops.main([{str(cfg)!r}, "--shape", "2", "16", "16", "--device", "cpu"])[1] > 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pnp_vcve_tpu")]
print("MODULES", len(mods), "BAD", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "iter 1/1 loss=" in proc.stdout and "dataset mean" in proc.stdout
    for line in ("[ok] quantize-in-kernel + int8 matmul", "[ok] int8 tap-conv",
                 "[ok] matmul-select H + dense V", "[ok] fori+dot 64-lane",
                 "[ok] dense select (35H+35V)", "[ok] per-block window DMAs",
                 "split=2 out=1 depth=3:", "verify: max abs diff vs eager = 0.00e+00",
                 "[deploy-test] dataset mean", "PARITY GATE PASSED", "FLOPs per frame"):
        assert line in proc.stdout
    assert "BAD []" in proc.stdout
    assert int(proc.stdout.split("MODULES ")[1].split()[0]) >= 30


def test_train_refuses_serving_config_and_unported_models(tmp_path):
    """The serving config's warp (pf) is refused with JAX's message; model
    types of tools/train.py's other branches (here the repository's
    CycleGAN config) name their ROADMAP item."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(REPO / "pnp_vcve_torch" / "configs" / "HR_davis_LR_128x128_serving.py")
    gen = build_restorer(cfg.model, device="cpu").generator
    with pytest.raises(ValueError, match="serving-only"):
        make_train_step(gen)
    cyclegan = REPO / "configs" / "baselines" / "cyclegan_lsgan_resnet.py"
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        _cli("torch_train").main([str(cyclegan), "--device", "cpu", "--work-dir",
                                  str(tmp_path)])


# ---- (h) the kernels' autograd Functions ---------------------------------------------------


def _grads(fn, args, grad_out):
    out = fn(*args)
    return torch.autograd.grad(out, [a for a in args if a.requires_grad], grad_out)


def _function_cases(gen):
    b, h, w = 2, 6, 10

    def t(*shape, scale=1.0, grad=True):
        return (torch.randn(shape, generator=gen) * scale).requires_grad_(grad)

    x = t(b, h, w, 64)
    par = (torch.rand((b, h, w, 3), generator=gen) > 0.5).float()
    parts = [t(b, h, w, 3), t(b, h, w, 64), t(b, h, w, 64), t(b, h, w, 64)]
    ks = [t(b, 3, 3, p.shape[-1], 64, scale=0.03) for p in parts]
    return {
        "warp": (lambda x_, f_: kw.WarpFunction.apply(kw.flow_warp_plain, x_, f_),
                 kw.flow_warp_plain, [x, t(b, h, w, 2, scale=4.0, grad=False)]),
        "input_conv": (
            lambda *a: kd.InputConvFunction.apply(kd.input_conv_plain, 4, *a),
            lambda *a: kd.input_conv_plain(a[:4], a[4:8], a[8]),
            [*parts, *ks, t(64, scale=0.1)]),
        "drt_block": (
            lambda *a: kd.DRTBlockFunction.apply(kd.drt_block_plain, *a), kd.drt_block_plain,
            [x, par, t(b, 3, 3, 64, 64, scale=0.03), t(b, 64, scale=0.1), t(b, 64),
             t(64, 3, 64, scale=0.03), t(3, 3, 64, 64, scale=0.03), t(64, scale=0.1)]),
        "head": (
            lambda *a: kd.HeadFunction.apply(kd.head_plain, *a), kd.head_plain,
            [x, t(3, 3, 64, 64, scale=0.03), t(64, scale=0.1), t(3, 3, 64, 3, scale=0.06),
             t(3, scale=0.1)]),
    }


@pytest.mark.parametrize("name", ["warp", "input_conv", "drt_block", "head"])
def test_function_grads_equal_plain_autograd(name):
    """Each kernel's Function, with its plain version standing in for the
    launch, gives plain autograd's gradients for every input that needs one
    (the flow and the partition map need none)."""
    fn, plain, args = _function_cases(torch.Generator().manual_seed(0))[name]
    grad_out = torch.randn_like(plain(*args))
    for g, want in zip(_grads(fn, args, grad_out), _grads(plain, args, grad_out)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_model_through_functions(monkeypatch, remat):
    """The whole model with every wrapper routed through its Function (the
    plain versions standing in for the launches): its gradients equal the
    plain path's, and the stand-in launches per training step are the
    forward's (t warps, t input convs, blocks x t DRT blocks per sweep, t
    heads), twice over with remat."""
    counts = dict.fromkeys(K.LAUNCHES, 0)

    def stand_in(name, plain):
        def run(*a):
            counts[name] += 1
            return plain(*a)
        return run

    monkeypatch.setattr(kw, "on_cpu", lambda x: False)
    monkeypatch.setattr(kd, "on_cpu", lambda x: False)
    monkeypatch.setattr(kw, "_launch", stand_in("warp", kw.flow_warp_plain))
    monkeypatch.setattr(kd, "_input_conv_launch", stand_in("input_conv", kd.input_conv_plain))
    monkeypatch.setattr(kd, "_drt_block_launch", stand_in("drt_block", kd.drt_block_plain))
    monkeypatch.setattr(kd, "_head_launch", stand_in("head", kd.head_plain))

    batch = _batch(np.random.default_rng(2), t=4)
    model = build_generator(dict(type="PnPVCVE", **SMALL, remat=remat), device="cpu", seed=3)
    grads = {}
    for ops in (K.KERNELS, K.PLAIN):
        model.ops = ops
        model.zero_grad()
        out = model(**_model_kwargs(batch, torch.from_numpy))
        (out - torch.from_numpy(batch["gt"])).abs().mean().backward()
        grads[ops is K.KERNELS] = {n: p.grad.clone() for n, p in model.named_parameters()}
        if ops is K.KERNELS:
            got = dict(counts)
    t, nb = 4, SMALL["num_blocks"]
    per_pass = {"warp": 2 * t, "warp_block": 0, "input_conv": 2 * t, "drt_block": 2 * nb * t,
                "drt_block_select": 0, "head": t, "conv3x3": 0}
    assert got == {k: v * (2 if remat else 1) for k, v in per_pass.items()}
    for n, g in grads[True].items():
        torch.testing.assert_close(g, grads[False][n], rtol=1e-5, atol=1e-7)
