"""tools/torch_test.py, the port's eval entry point, on the CPU; and the
port's builder on the shipped configs."""

import json
import os
import subprocess
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
T_FRAMES, H, W = 4, 24, 32


@pytest.fixture
def fixture_root(tmp_path):
    """One clip of PNG frames with empty MV sidecars and a qp.json."""
    rng = np.random.default_rng(0)
    png = tmp_path / "crf25" / "png" / "000"
    mv = tmp_path / "crf25" / "mv" / "000"
    png.mkdir(parents=True)
    mv.mkdir(parents=True)
    entries = {}
    for i in range(T_FRAMES):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(png / f"{i:08d}.png")
        np.save(mv / f"{i:08d}.npy", np.zeros((0, 10), np.float32))
        entries[str(i)] = {"QP": 27.0, "slice": "I" if i == 0 else ("P" if i % 2 else "B")}
    (tmp_path / "qp.json").write_text(json.dumps({"crf25": {"000": entries}}))
    return tmp_path


def _write_cfg(tmp_path, root):
    cfg = tmp_path / "port_cfg.py"
    cfg.write_text(f"""
model = dict(
    type="BasicVSR",
    generator=dict(
        type="IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par",
        mid_channels=8, num_blocks=1, num_experts=2,
    ),
    pixel_loss=dict(type="CharbonnierLoss", loss_weight=1.0),
)
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
data = dict(
    test=dict(
        type="SRFolderMultipleGTDataset",
        lq_folder=r"{root}/crf25/png",
        gt_folder=r"{root}/crf25/png",
        num_input_frames={T_FRAMES},
        pipeline=[dict(type="LoadImageFromFileList_ipb", qp_slice_file=r"{root}/qp.json")],
    ),
)
""")
    return cfg


def test_cli_enhances_and_saves_without_jax(fixture_root, tmp_path):
    """The CPU drive prints per-clip PSNR/SSIM and the mean, writes
    {clip}/{i:08d}.png, and never imports JAX."""
    cfg = _write_cfg(tmp_path, fixture_root)
    out_dir = tmp_path / "out"
    code = (
        "import runpy, sys; "
        f"sys.argv = ['torch_test.py', {str(cfg)!r}, '-', '--device', 'cpu', "
        f"'--save-path', {str(out_dir)!r}, '--save-image', "
        f"'--out', {str(tmp_path / 'm.pkl')!r}]; "
        f"runpy.run_path({str(REPO / 'tools' / 'torch_test.py')!r}, run_name='__main__'); "
        "print('JAX_IMPORTED', 'jax' in sys.modules)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "[eval] 000: PSNR=" in proc.stdout and "SSIM=" in proc.stdout
    assert "dataset mean" in proc.stdout
    assert "JAX_IMPORTED False" in proc.stdout
    frames = sorted(p.name for p in (out_dir / "000").iterdir())
    assert frames == [f"{i:08d}.png" for i in range(T_FRAMES)]
    assert np.asarray(Image.open(out_dir / "000" / frames[0])).shape == (H, W, 3)
    assert (tmp_path / "m.pkl").exists()


def _cli():
    sys.path.insert(0, str(REPO / "tools"))
    import torch_test

    return torch_test


def test_cli_refuses_cuda_without_a_card(fixture_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli().main([str(_write_cfg(tmp_path, fixture_root)), "-", "--device", "cuda"])


def test_cli_exact_stream_writes_the_plain_runs_pngs(fixture_root, tmp_path):
    """--frame-parallel exact --stream-clips 2 over two chunks on the CPU
    (--pipeline-devices cpu,cpu) and three clips (a stream of 2, then 1):
    the PNGs and metrics of the plain run, bit for bit."""
    import shutil

    for clip in ("001", "002"):
        for sub in ("png", "mv"):
            src = fixture_root / "crf25" / sub
            shutil.copytree(src / "000", src / clip)
    qp = json.loads((fixture_root / "qp.json").read_text())
    entries = qp["crf25"]["000"]
    qp["crf25"]["001"] = {k: dict(v, slice="P" if v["slice"] == "B" else v["slice"])
                          for k, v in entries.items()}
    qp["crf25"]["002"] = dict(entries)
    (fixture_root / "qp.json").write_text(json.dumps(qp))
    cfg = str(_write_cfg(tmp_path, fixture_root))
    cli = _cli()
    plain = cli.main([cfg, "-", "--device", "cpu", "--save-path", str(tmp_path / "a"),
                      "--save-image"])
    exact = cli.main([cfg, "-", "--device", "cpu", "--save-path", str(tmp_path / "b"),
                      "--save-image", "--frame-parallel", "exact", "--stream-clips", "2",
                      "--pipeline-devices", "cpu,cpu"])
    assert exact == plain
    pngs = sorted((tmp_path / "a").glob("*/*.png"))
    assert len(pngs) == 3 * T_FRAMES
    for f in pngs:
        assert f.read_bytes() == (tmp_path / "b" / f.parent.name / f.name).read_bytes()
    with pytest.raises(SystemExit):  # argparse: exact is the one mode
        cli.parse_args([cfg, "-", "--frame-parallel", "halo"])


@pytest.mark.parametrize("flag", [["--cascade", "--cascade_config", "vsr.py"],
                                  ["--joint-pqf-config", "pqf.py"],
                                  ["--cascade_config", "vsr.py"]])
def test_cli_unported_flags_name_their_roadmap_item(fixture_root, tmp_path, flag):
    """The options that once raised with ROADMAP Queue A item 8 run their
    modes: the cascade into a BasicVSR++ (``vsr.py``; same-size input here,
    so the clip's own GT scores it), the MFQE joint protocol (``pqf.py``,
    with an MFQEv2 main config, as the protocol needs), and
    ``--cascade_config`` alone is read only with ``--cascade``, as in
    tools/test.py."""
    (tmp_path / "vsr.py").write_text(
        'model = dict(type="BasicVSR", generator=dict(type="BasicVSRPlusPlus", mid_channels=8, '
        'num_blocks=1, deform_groups=2, is_low_res_input=False))\n')
    (tmp_path / "pqf.py").write_text(
        'model = dict(type="MFQEv2Restorer", generator=dict(type="MFQEv2", nf=4))\n')
    cfg = plain_cfg = _write_cfg(tmp_path, fixture_root)
    if flag[0] == "--joint-pqf-config":
        cfg = tmp_path / "non_pqf.py"
        cfg.write_text(plain_cfg.read_text() + (tmp_path / "pqf.py").read_text())
    cli = _cli()
    metrics = cli.main([str(cfg), "-", "--device", "cpu"]
                       + [f if f.startswith("-") else str(tmp_path / f) for f in flag])
    assert set(metrics) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in metrics.values())
    plain = cli.main([str(plain_cfg), "-", "--device", "cpu"])
    assert (metrics == plain) == (flag[0] == "--cascade_config")


@pytest.mark.parametrize("name", ["HR_davis_LR_128x128.py", "HR_davis_LR_128x128_serving.py",
                                  "HR_davis_LR_128x128_IPB.py",
                                  "HR_davis_LR_128x128_IPB_LR_test.py"])
def test_shipped_configs_build_port_generator(name):
    """The port's flagship configs load through its own Config and builder,
    at the flagship widths, under the reference's parameter names, and
    carry the shipped configs' settings; the IPB configs' loaders read the
    slice type for the QP, as the JAX package's do, over its test folders."""
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.models.pnp_vcve import PnPVCVE

    cfg = Config.fromfile(REPO / "pnp_vcve_torch" / "configs" / name)
    gen = build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu").generator
    assert isinstance(gen, PnPVCVE) and gen.remat
    assert gen.warp_impl == ("pf" if "serving" in name else "padgather")
    with np.load(REPO / "tests" / "fixtures" / "parity" / "state_dict.npz") as z:
        ref = {k: z[k].shape for k in z.files}
    assert {k: tuple(v.shape) for k, v in gen.state_dict().items()} == ref
    if "IPB" in name:
        jax_cfg = Config.fromfile(REPO / "configs" / name)
        for c in (cfg, jax_cfg):
            loaders = [s for d in c.data["train"] + [c.data["test"]]
                       for s in (d.get("dataset", d)["pipeline"])
                       if s["type"] == "LoadImageFromFileList_ipb"]
            assert loaders and all(s["replace_qp_withIPB"] for s in loaders)
        for k in ("lq_folder", "gt_folder", "type"):
            assert cfg.data["test"][k] == jax_cfg.data["test"][k]
    shipped = (REPO / "configs" / "HR_davis_LR_128x128.py").read_text()
    for line in ("optimizers = dict(generator=dict(type=\"Adam\", lr=2e-4, betas=(0.9, 0.99)))",
                 "train_cfg = dict(fix_iter=5000)", "min_lr=1e-7,", "periods=[300000],"):
        assert line in shipped and line in (REPO / "pnp_vcve_torch" / "configs"
                                            / "HR_davis_LR_128x128.py").read_text()


# every generator form of the JAX builder builds since the block forms and
# vsr / deform / flow_inter were ported (tests/test_torch_port_blocks.py,
# tests/test_torch_port_forms.py); what the JAX package refuses, the port
# refuses: a DCN type it has not, and the 'pf' serving path with vsr or a
# DCN aligner (JAX core/builder.py:76-78, models/pnp_vcve.py:535-539)
@pytest.mark.parametrize("override", [
    dict(deform="stdf"), dict(deform="pcd"), dict(vsr=True, warp_impl="pf"),
    dict(deform="basic", warp_impl="pf"), dict(vsr=True, one_layer=False, warp_impl="pf"),
])
def test_unported_generator_variants_raise(override):
    from pnp_vcve_torch.core.builder import build_generator

    cfg = dict(type="PnPVCVE", mid_channels=64, num_blocks=1, num_experts=2,
               use_pallas_kernels=True, deform_groups=8, **override)
    if "warp_impl" not in override:
        with pytest.raises(NotImplementedError, match="No such DCN type"):
            build_generator(cfg, device="cpu")
        return
    model = build_generator(cfg, device="cpu")
    t, h, w = 2, 16, 16
    inp = dict(lrs=torch.zeros(1, t, h, w, 3), qps=torch.zeros(1, t),
               slices=torch.full((1, t), 73.0), mvs=torch.zeros(1, t, h, w, 4),
               base_qps=torch.zeros(1, t), par_map=torch.zeros(1, t, h, w, 3))
    with pytest.raises(ValueError, match="deform='vos', vsr=False"), torch.inference_mode():
        model(**inp)


def test_cli_runs_vsr_on_4x_gt(fixture_root, tmp_path):
    """A vsr generator through the entry point (``--cfg-options
    model.generator.vsr=True``) on a clip whose GT is 4x the LR: metrics
    against the 4x frames, 4x PNGs written."""
    gt = fixture_root / "x4" / "png" / "000"
    gt.mkdir(parents=True)
    for f in sorted((fixture_root / "crf25" / "png" / "000").iterdir()):
        Image.open(f).resize((4 * W, 4 * H), Image.BICUBIC).save(gt / f.name)
    out_dir = tmp_path / "out"
    metrics = _cli().main([str(_write_cfg(tmp_path, fixture_root)), "-", "--device", "cpu",
                           "--testdir_gt", str(fixture_root / "x4" / "png"),
                           "--cfg-options", "model.generator.vsr=True",
                           "--save-path", str(out_dir), "--save-image"])
    assert set(metrics) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in metrics.values())
    assert np.asarray(Image.open(out_dir / "000" / "00000000.png")).shape == (4 * H, 4 * W, 3)
