"""The eval entry point's last two modes on the CPU, through
tools/torch_test.py: ``--cascade`` into vanilla BasicVSR++ (the layout of
tests/test_cascade_cli.py: enhanced LR frames, metrics against x4 GT) and
the MFQE two-model joint protocol (the layout of
tests/test_mfqe_joint_cli.py); the checkpoints of both under the
reference's names; the port's copies of configs/baselines. The port
against JAX's models and eval harness is tests/test_torch_port_baselines.py.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _write_clips(root, clips, t, h, w, gt_dir, gt_scale):
    """``crf15/{png,mv}/<clip>`` frames with empty MV sidecars, GT frames
    under ``gt_dir`` at ``gt_scale`` x, I/P/B slices in ``qp.json``."""
    rng = np.random.default_rng(0)
    sidecar = {}
    for clip in clips:
        png, mv, gt = (root / "crf15" / "png" / clip, root / "crf15" / "mv" / clip,
                       root / gt_dir / clip)
        for d in (png, mv, gt):
            d.mkdir(parents=True)
        entries = {}
        for i in range(t):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                png / f"{i:08d}.png")
            Image.fromarray(rng.integers(0, 256, (gt_scale * h, gt_scale * w, 3),
                                         dtype=np.uint8)).save(gt / f"{i:08d}.png")
            np.save(mv / f"{i:08d}.npy", np.zeros((0, 10), np.float32))
            entries[str(i)] = {"QP": 22.0, "slice": "I" if i == 0 else ("P" if i % 2 else "B")}
        sidecar[clip] = entries
    (root / "qp.json").write_text(json.dumps({"crf15": sidecar}))


def _test_data(root, gt_dir, t):
    return f"""
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
data = dict(test=dict(
    type="SRFolderMultipleGTDataset", lq_folder=r"{root}/crf15/png",
    gt_folder=r"{root}/{gt_dir}", num_input_frames={t}, scale=1,
    pipeline=[dict(type="LoadImageFromFileList_ipb", qp_slice_file=r"{root}/qp.json")]))
"""


ENHANCER = """
model = dict(type="BasicVSR", generator=dict(
    type="IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par",
    mid_channels=8, num_blocks=1, num_experts=2))
"""
VSR = """
model = dict(type="BasicVSR", generator=dict(
    type="BasicVSRPlusPlus", mid_channels=8, num_blocks=1, deform_groups=2))
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
"""
MFQE = """
model = dict(type="MFQEv2Restorer",
             generator=dict(type="MFQEv2", in_channels=3, out_channels=3, nf=4))
"""


@pytest.fixture
def cascade_root(tmp_path):
    """tests/test_cascade_cli.py's layout: one clip of 4 frames at 64x64,
    its x4 GT under X4/png; the enhancer's and the VSR model's configs."""
    root = tmp_path / "data"
    _write_clips(root, ["000"], 4, 64, 64, "X4/png", 4)
    (tmp_path / "enh.py").write_text(ENHANCER + _test_data(root, "crf15/png", 4))
    (tmp_path / "vsr.py").write_text(VSR)
    return tmp_path


def _cli():
    sys.path.insert(0, str(REPO / "tools"))
    import torch_test

    return torch_test


def _seeded_vsr_ckpt(path, suffix):
    """A seeded vanilla BasicVSR++ (every offset head non-zero) saved under
    the reference's names with ``generator.`` prefixes; the model too."""
    from pnp_vcve_torch.core.builder import build_generator

    model = build_generator(dict(type="BasicVSRPlusPlus", mid_channels=8, num_blocks=1,
                                 deform_groups=2), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for align in model.deform_align.values():
            w = align.conv_offset[6].weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
    sd = {f"generator.{k}": v for k, v in model.state_dict().items()}
    # the reference SPyNet's constant buffers ride along in its checkpoints
    sd["generator.spynet.mean"] = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    sd["generator.spynet.std"] = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    if suffix == ".npz":
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save({"state_dict": sd}, path)
    return model


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_cli_cascade_into_vanilla_bvpp(cascade_root, suffix):
    """``--cascade --cascade_config vsr.py --cascade_ckpt CKPT --testdir_gt
    X4``: the enhanced frames go through BasicVSR++ (its checkpoint under
    the reference's names, .pth or .npz); the metrics against the x4 GT are
    finite, equal to the harness's own cascade on the same models, and the
    PNGs are x4."""
    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.models.restorer import Restorer
    from pnp_vcve_torch.train.eval import evaluate_dataset

    root = cascade_root
    ckpt = root / f"vsr{suffix}"
    vsr = _seeded_vsr_ckpt(ckpt, suffix)
    out = root / "out"
    metrics = _cli().main([str(root / "enh.py"), "-", "--device", "cpu", "--cascade",
                           "--cascade_config", str(root / "vsr.py"), "--cascade_ckpt", str(ckpt),
                           "--testdir_gt", str(root / "data/X4/png"), "--out",
                           str(root / "m.pkl"), "--save-path", str(out), "--save-image"])
    assert set(metrics) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in metrics.values())
    assert metrics["PSNR"] > 0 and 0 <= metrics["SSIM"] <= 1
    assert pickle.loads((root / "m.pkl").read_bytes()) == metrics
    assert np.asarray(Image.open(out / "000" / "00000003.png")).shape == (256, 256, 3)

    cfg = Config.fromfile(root / "enh.py")
    test_cfg = dict(cfg.data["test"], gt_folder=str(root / "data/X4/png"))
    enh = build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu")
    enh.generator.reset_parameters(torch.Generator().manual_seed(0))
    want = evaluate_dataset(enh, build_dataset(test_cfg), verbose=False,
                            cascade=(vsr, Restorer(generator=vsr)))
    assert metrics == want


def test_cli_cascade_config_defaults_to_the_main_config(cascade_root):
    """Without ``--cascade_config`` the cascade model is the main config's,
    as in tools/test.py: a same-size BasicVSR++ (``is_low_res_input=False``)
    cascades into itself, and its metrics are not the plain run's."""
    root = cascade_root
    cfg = root / "same_size.py"
    cfg.write_text(VSR.replace("deform_groups=2", "deform_groups=2, is_low_res_input=False")
                   + _test_data(root / "data", "crf15/png", 4))
    cascaded = _cli().main([str(cfg), "-", "--device", "cpu", "--cascade"])
    plain = _cli().main([str(cfg), "-", "--device", "cpu"])
    assert set(cascaded) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in cascaded.values())
    assert cascaded != plain


def test_cli_joint_pqf_protocol(tmp_path, capsys):
    """``--joint-pqf-config … --joint-pqf-ckpt -`` on tests/test_mfqe_joint_cli.py's
    layout (2 clips x 6 frames at 32x48): ``[mfqe-joint]`` lines and the
    metrics in ``--out``."""
    root = tmp_path / "data"
    _write_clips(root, ["000", "001"], 6, 32, 48, "sharp/png", 1)
    cfg = tmp_path / "mfqe.py"
    cfg.write_text(MFQE + _test_data(root, "sharp/png", 6))
    metrics = _cli().main([str(cfg), "-", "--device", "cpu", "--joint-pqf-config", str(cfg),
                           "--joint-pqf-ckpt", "-", "--out", str(tmp_path / "j.pkl")])
    assert set(metrics) == {"PSNR", "SSIM"}
    assert np.isfinite(metrics["PSNR"]) and 0 < metrics["SSIM"] <= 1
    assert pickle.loads((tmp_path / "j.pkl").read_bytes()) == metrics
    out = capsys.readouterr().out
    assert "[mfqe-joint] 000: PSNR=" in out and "[mfqe-joint] 001: PSNR=" in out
    assert "[mfqe-joint] dataset mean" in out


@pytest.mark.parametrize("mode", ["cascade", "joint"])
def test_cli_modes_refuse_cuda_without_a_card(cascade_root, mode):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    root = cascade_root
    extra = (["--cascade", "--cascade_config", str(root / "vsr.py")] if mode == "cascade"
             else ["--joint-pqf-config", str(root / "vsr.py")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli().main([str(root / "enh.py"), "-", "--device", "cuda", *extra])


@pytest.mark.parametrize("name", ["basicvsr_pp_pqf_v2.py", "mfqev2_pqf.py", "mfqev2_nonpqf.py"])
def test_port_baseline_configs_build(name):
    """The port's copies of configs/baselines build their restorers at the
    configs' widths through its own Config and builder, with the JAX
    configs' model, test and training keys; tools/torch_train.py refuses to
    train them (ROADMAP Queue A item 8)."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.models.baselines import BasicVSRPlusPlusPQF, MFQEv2
    from pnp_vcve_torch.models.restorer import CenterFrameRestorer

    cfg = Config.fromfile(REPO / "pnp_vcve_torch" / "configs" / "baselines" / name)
    jax_cfg = Config.fromfile(REPO / "configs" / "baselines" / name)
    for key in ("model", "train_cfg", "test_cfg", "optimizers", "lr_config", "total_iters"):
        assert cfg.get(key) == jax_cfg.get(key), key
    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu")
    gen = restorer.generator
    if name.startswith("mfqev2"):
        assert isinstance(restorer, CenterFrameRestorer) and isinstance(gen, MFQEv2)
        assert gen.rec5.weight.shape == (3, 32, 3, 3)
    else:
        assert isinstance(gen, BasicVSRPlusPlusPQF) and gen.variant == "v2"
        assert not gen.is_low_res_input and gen.mid_channels == 64
        assert len(gen.backbone["forward_2"].main[2]) == 7
        assert cfg.data["test"] == jax_cfg.data["test"]
    sys.path.insert(0, str(REPO / "tools"))
    import torch_train

    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        torch_train.main([str(REPO / "pnp_vcve_torch" / "configs" / "baselines" / name),
                          "--device", "cpu"])
