"""The port's deployment and API tooling on the CPU at small widths (16
channels, 2 blocks, 3 experts; 3-frame windows at 32x32): the deploy test
of an exported artifact (tools/torch_deploy_test.py), the parity gate as a
CLI (tools/torch_parity_check.py), publish (tools/torch_publish_model.py),
the parameter and FLOP count (tools/torch_get_flops.py), the dataset test
loops (``apis.single_gpu_test`` / ``multi_gpu_test``) and a video file
through ``apis.restoration_video_inference``.

Bounds: the deploy test's outputs within 1e-4 of the eager forward and its
metrics within the parity gate's (0.05 dB PSNR, 0.001 SSIM); the parameter
count equal to the JAX package's; the kernel path's FLOPs (the ops'
formulas) within 1% of the plain path's; the video path within 1e-4 of
JAX's, its decoded frames bitwise equal.
"""

import hashlib
import json
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_torch import apis
from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.core.builder import build_dataset, build_restorer
from pnp_vcve_torch.core.config import Config
from pnp_vcve_torch.models.restorer import Restorer
from pnp_vcve_torch.train.eval import evaluate_dataset

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "tools"), str(REPO / "tools" / "data")]
import torch_deploy_test  # noqa: E402
import torch_export_model  # noqa: E402
import torch_get_flops  # noqa: E402
import torch_parity_check  # noqa: E402
import torch_publish_model  # noqa: E402
import torch_test  # noqa: E402

CONFIGS = REPO / "pnp_vcve_torch" / "configs"
FIXTURE = REPO / "tests" / "fixtures" / "parity"
SMALL = dict(mid_channels=16, num_blocks=2, num_experts=3)
T, H, W = 3, 32, 32  # the exported window
CLIP_T, CLIP_H, CLIP_W = 7, 40, 48  # two windows and a dropped tail; centre crop


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A make_synthetic_dataset fixture of clips 000 and 011 (7 frames at
    40x48) and 015 cut to 2 frames (shorter than a window), a config of the
    small training-config generator reading it, and the exported artifact of
    that config (seeded init) at (3, 32, 32)."""
    from make_synthetic_dataset import write_dataset

    root = tmp_path_factory.mktemp("deploy")
    write_dataset(root, ["000", "011", "015"], CLIP_T, CLIP_H, CLIP_W, seed=3)
    for sub in ("crf25/png", "crf25/mv", "sharp/png"):
        for f in sorted((root / sub / "015").iterdir())[2:]:
            f.unlink()
    cfg = root / "small.py"
    cfg.write_text(
        f"_base_ = [{str(CONFIGS / 'HR_davis_LR_128x128.py')!r}]\n"
        "from pnp_vcve_torch.core.presets import flagship_data\n"
        f"model = dict(generator={SMALL!r})\n"
        f"data = flagship_data(test_lq={str(root / 'crf25/png')!r}, "
        f"test_gt={str(root / 'sharp/png')!r}, test_qp_json={str(root / 'qp.json')!r})\n"
        "data['test'].update(type='SRFolderMultipleGTDataset', num_input_frames=100)\n")
    res = torch_export_model.main([str(cfg), "-", str(root / "small.pt2"), "--shape", str(T),
                                   str(H), str(W), "--verify", "--device", "cpu"])
    return dict(root=root, cfg=cfg, pt2=root / "small.pt2", program=res["loaded"])


def _dataset(cfg):
    return build_dataset(dict(Config.fromfile(cfg).data["test"]))


def test_deploy_test_matches_eager_windows(data, tmp_path, capsys):
    """tools/torch_deploy_test.py: the artifact's windows of (3, 32, 32),
    centre-cropped from 40x48, 2 a clip of 7 frames, the clip of 2 frames
    dropped; its outputs within 1e-4 of the eager forward on the same
    windows and its per-clip PSNR / SSIM within the parity gate's bounds of
    the eager ``Restorer.evaluate_clip``; the mean pickled."""
    out = tmp_path / "m.pkl"
    per_clip, mean = torch_deploy_test.main([str(data["cfg"]), str(data["pt2"]), "--device", "cpu",
                                             "--out", str(out)])
    printed = capsys.readouterr().out
    assert "deployed artifact expects windows of (t=3, h=32, w=32)" in printed
    assert sorted(per_clip) == ["000", "011"]
    assert pickle.loads(out.read_bytes()) == mean
    model = torch_export_model.load_model(str(data["cfg"]), "-", torch.device("cpu"))
    restorer = Restorer(model, test_cfg={"metrics": ["PSNR", "SSIM"], "crop_border": 0})
    top, left = (CLIP_H - H) // 2, (CLIP_W - W) // 2
    for sample in _dataset(data["cfg"]):
        name = sample["clip_name"]
        if name == "015":
            assert sample["lq"].shape[0] == 2
            continue
        outs = []
        for s in (0, T):
            crop = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
                a[s:s + T, top:top + H, left:left + W][None]))
            win = lambda k: torch.from_numpy(np.ascontiguousarray(sample[k][s:s + T][None]))  # noqa: E731
            args = (crop(sample["lq"]), win("qps"), win("slices"), crop(sample["mvs"]),
                    win("base_qps"), crop(sample["partitions"]))
            with torch.no_grad():
                eager = model(*args)
                deployed = data["program"].module()(*args)
            np.testing.assert_allclose(deployed.numpy(), eager.numpy(), atol=1e-4, rtol=0)
            outs.append(eager[0].numpy())
        gt = sample["gt"][:2 * T, top:top + H, left:left + W]
        want = restorer.evaluate_clip(np.concatenate(outs), gt)
        assert abs(per_clip[name]["PSNR"] - want["PSNR"]) <= 0.05
        assert abs(per_clip[name]["SSIM"] - want["SSIM"]) <= 0.001
        assert f"[deploy-test] {name}: PSNR=" in printed


def test_parity_cli(tmp_path, capsys):
    """tools/torch_parity_check.py: the fixture gate on the first clip at the
    full flagship widths exits 0, with --tamper 1; the asset mode with
    missing files skips with exit 0 and its reason on stderr."""
    codes = []
    for extra in ([], ["--tamper"]):
        with pytest.raises(SystemExit) as e:
            torch_parity_check.main(["--fixture", str(FIXTURE), "--clips-limit", "1",
                                     "--device", "cpu", *extra])
        codes.append(e.value.code)
    assert codes == [0, 1]
    assert "PARITY GATE PASSED" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        torch_parity_check.main([str(CONFIGS / "HR_davis_LR_128x128.py"),
                                 str(tmp_path / "absent.pth"), "--testdir_lr", str(tmp_path),
                                 "--testdir_gt", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 0
    assert "PARITY GATE SKIPPED: reference checkpoint not found" in capsys.readouterr().err


def test_publish_strips_state_and_keeps_outputs(data, tmp_path):
    """A training checkpoint (weights after an Adam step, the optimizer, the
    schedule, the step) published: only the generator's weights remain, the
    name carries the first 8 hex digits of the file's sha256, and
    tools/torch_test.py gives bitwise the same PNGs and metrics from it as
    from the checkpoint."""
    from pnp_vcve_torch.train.state import TrainState, state_payload

    model = torch_export_model.load_model(str(data["cfg"]), "-", torch.device("cpu"))
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
    opt = torch.optim.Adam(params, lr=1e-3)
    opt.step()
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    ckpt = tmp_path / "w" / "ckpt" / "1.pth"
    ckpt.parent.mkdir(parents=True)
    torch.save(state_payload(TrainState(1, model, opt, sched)), ckpt)

    pub = torch_publish_model.main([str(ckpt), str(tmp_path / "pub" / "small")])
    assert re.fullmatch(r"small-[0-9a-f]{8}\.pth", pub.name)
    assert pub.name[6:14] == hashlib.sha256(pub.read_bytes()).hexdigest()[:8]
    held = torch.load(pub, weights_only=True)
    assert list(held) == ["state_dict"]
    assert held["state_dict"].keys() == model.state_dict().keys()
    runs = {}
    for tag, path in (("ckpt", ckpt), ("pub", pub)):
        save = tmp_path / tag
        metrics = torch_test.main([str(data["cfg"]), str(path), "--device", "cpu",
                                   "--save-path", str(save), "--save-image"])
        runs[tag] = (metrics, {p.relative_to(save): p.read_bytes()
                               for p in sorted(save.glob("*/*.png"))})
    assert runs["ckpt"][0] == runs["pub"][0] and len(runs["ckpt"][1]) == 2 * CLIP_T + 2
    assert runs["ckpt"][1] == runs["pub"][1]


def _jax_param_count(cfg_path):
    from pnp_vcve_tpu.core.builder import build_restorer as jax_build
    from pnp_vcve_tpu.core.config import Config as JaxConfig

    cfg = JaxConfig.fromfile(cfg_path)
    model = jax_build(cfg.model, cfg.get("test_cfg")).generator
    z = lambda *s: jax.numpy.zeros((1, 2, *s))  # noqa: E731
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), lrs=z(16, 16, 3), qps=z(), slices=jax.numpy.full((1, 2), 73.0),
        mvs=z(16, 16, 4), base_qps=z(), par_map=z(16, 16, 3)))
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


def test_get_flops(capsys):
    """tools/torch_get_flops.py on the port's flagship config: the parameter
    count equals the JAX tool's (the leaves of the JAX model's variables)
    exactly, and the four lines print. The kernel path's FLOPs, counted
    through the ops' formulas, are within 1% of FlopCounterMode's count of
    the plain path (both count the same convolutions and products)."""
    n_params, flops = torch_get_flops.main([str(CONFIGS / "HR_davis_LR_128x128.py"),
                                            "--shape", "2", "16", "16", "--device", "cpu"])
    printed = capsys.readouterr().out
    for line in ("Input shape: (1, 2, 16, 16, 3)", "Params: ", "FLOPs (", "FLOPs per frame: "):
        assert line in printed
    assert n_params == _jax_param_count(str(REPO / "configs" / "HR_davis_LR_128x128.py"))
    model = torch_export_model.load_model(str(CONFIGS / "HR_davis_LR_128x128_serving.py"), "-",
                                          torch.device("cpu"))
    counts = {}
    for ops in (K.KERNELS, K.PLAIN):
        model.ops = ops
        counts[ops is K.KERNELS] = torch_get_flops.count(model, 2, 16, 16, "cpu")[1]
    assert counts[True] > 0 and abs(counts[True] - counts[False]) <= 0.01 * counts[False]
    assert abs(flops - counts[True]) <= 0.01 * counts[True]  # padgather and pf alike


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from pnp_vcve_torch import apis
from pnp_vcve_torch.core.builder import build_dataset, build_restorer
from pnp_vcve_torch.core.config import Config
from pnp_vcve_torch.parallel.multihost import init_distributed
import torch.distributed as dist

device = init_distributed("pytorch", "cpu")
cfg = Config.fromfile(sys.argv[2])
restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device)
metrics = apis.multi_gpu_test(restorer, build_dataset(dict(cfg.data["test"])), verbose=False)
print(json.dumps({"rank": dist.get_rank(), "metrics": metrics}))
dist.destroy_process_group()
"""


def test_test_loops(data, tmp_path):
    """``single_gpu_test`` equals ``evaluate_dataset``; ``multi_gpu_test`` in
    a real 2-rank gloo world (the 3 clips split 2/1) equals one process's
    mean within 1e-6 relative (the float32 count-weighted reduction)."""
    cfg = Config.fromfile(data["cfg"])
    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu")
    one = evaluate_dataset(restorer, _dataset(data["cfg"]), verbose=False)
    assert apis.single_gpu_test(restorer, _dataset(data["cfg"]), verbose=False) == one
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, str(worker), str(REPO), str(data["cfg"])],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        got = json.loads(out.strip().splitlines()[-1])["metrics"]
        assert got.keys() == one.keys()
        for k, v in one.items():
            assert abs(got[k] - v) <= 1e-6 * abs(v), (k, got[k], v)


def test_video_file_through_both_apis(tmp_path):
    """A 3-frame .mp4 written with OpenCV (mp4v): both packages decode the
    same frames bit for bit, and the port's restoration_video_inference
    equals JAX's on the same weights within 1e-4."""
    import cv2

    from pnp_vcve_tpu import apis as japis

    path = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (48, 32))
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    for i in range(3):
        writer.write(np.roll(base, 2 * i, axis=1))
    writer.release()
    frames = apis._read_video_file(path)
    assert frames.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(frames, japis._read_video_file(path))

    tiny_cfg = dict(model=dict(type="BasicVSR", generator=dict(
        type="IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par", mid_channels=8,
        num_blocks=1, num_experts=2)), test_cfg=dict(metrics=["PSNR", "SSIM"], crop_border=0))
    model = apis.init_model(tiny_cfg, device="cpu")
    sd = {k: v.detach().numpy() for k, v in model.generator.state_dict().items()}
    jm = japis.init_model(tiny_cfg)
    jm.variables = {"params": convert_generator_state_dict(sd, num_blocks=1)}
    got = apis.restoration_video_inference(model, path)
    want = np.asarray(japis.restoration_video_inference(jm, path))
    assert got.shape == (3, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
