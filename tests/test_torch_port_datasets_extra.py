"""The port's last codec datasets against the JAX package's, and the KITTI
CLI: each of ``KittiPairDataset``, ``VimeoMixDataset`` (plain and BD),
``VimeoTestDataset`` and the Big mixture, built through both builders from
one synthetic fixture, gives JAX's samples bit for bit (the training
sources on the same seeds); ``tools/torch_test_kitti.py`` with ``-`` and
with an ``.npz`` prints what the port's ``evaluate_dataset`` gives on the
same pairs, and runs at KITTI's 375x1242 under the training config's warp.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pnp_vcve_tpu.core.builder import build_dataset as jax_build_dataset
from pnp_vcve_torch.core.builder import build_dataset

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "tools"), str(REPO / "tools" / "data")]
H, W = 32, 48
KEYS = ("00001/0266", "00002/0011")
SEEDS = range(6)


def _assert_samples_equal(got, want):
    arrays = [k for k, v in want.items() if isinstance(v, np.ndarray)]
    assert arrays and set(arrays) == {k for k, v in got.items() if isinstance(v, np.ndarray)}
    for k in arrays:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got.get("clip_name") == want.get("clip_name")


def _records(rng, n=3):
    """A few 16x16-block MV records (rasterizer layout, make_protocol_fixture)."""
    from make_protocol_fixture import block_mv_records

    return block_mv_records(H, W, int(rng.integers(-3, 4)), int(rng.integers(-3, 4)))[:n]


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    """Two Vimeo-90k septuplets: the plain and BD CRF folders, the
    uncompressed frames under lq/png, GT under sharp, MV sidecars for frames
    2-7 (frame 1's missing: zero motion), a 4-level qp.json with I/P/B and
    the annotation list."""
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(0)
    sidecar = {}

    def frames(d):
        d.mkdir(parents=True, exist_ok=True)
        for i in range(1, 8):
            Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(d / f"im{i}.png")

    for key in KEYS:
        clip, sub = key.split("/")
        frames(root / "lq" / "png" / clip / sub)
        frames(root / "sharp" / clip / sub)
        for prefix in ("", "BD_"):
            for crf in (15, 25, 35):
                base = root / f"{prefix}crf{crf}"
                frames(base / "png" / clip / sub)
                mv = base / "mv" / clip / sub
                mv.mkdir(parents=True, exist_ok=True)
                for i in range(2, 8):
                    np.save(mv / f"{i - 1:08d}.npy", _records(rng))
                entries = {str(i - 1): {"QP": float(rng.integers(20, 45)),
                                        "slice": "I" if i == 1 else "PB"[i % 2]}
                           for i in range(1, 8)}
                sidecar.setdefault(f"crf{crf}", {}).setdefault(clip, {})[sub] = entries
    (root / "qp.json").write_text(json.dumps(sidecar))
    (root / "keys.txt").write_text("".join(f"{k} (256,448,3)\n" for k in KEYS))
    return root


@pytest.mark.parametrize("variant", ["SRVimeo90KMultipleGTMixCompressDataset",
                                     "SRVimeo90KMultipleGTMixCompressDataset_BD"])
@pytest.mark.parametrize("ipb", [False, True])
def test_vimeo_mix_equals_jax(vimeo_root, variant, ipb):
    cfg = dict(
        type=variant, cprs_all_folder=str(vimeo_root), lq_folder=str(vimeo_root / "lq"),
        gt_folder=str(vimeo_root / "sharp"), ann_file=str(vimeo_root / "keys.txt"), scale=1,
        num_input_frames=7,
        pipeline=[
            dict(type="LoadImageFromFileList_Mix_Compress_ipb", key="lq",
                 qp_slice_file=str(vimeo_root / "qp.json"), replace_qp_withIPB=ipb,
                 data_ratio=[0.2, 0.5, 0.75, 1.0]),
            dict(type="PairedRandomCrop_mv", gt_patch_size=16),
        ],
    )
    ours, theirs = build_dataset(cfg), jax_build_dataset(cfg)
    bases = set()
    for seed in SEEDS:
        got = ours.sample(np.random.default_rng(seed))
        _assert_samples_equal(got, theirs.sample(np.random.default_rng(seed)))
        bases.add(round(float(got["base_qps"][0]) * 255))
    assert len(bases) >= 3  # the draws reach several CRF buckets


@pytest.mark.parametrize("folder,ipb", [("crf25/png", False), ("crf35/png", True),
                                        ("lq/png", False)])
def test_vimeo_test_equals_jax(vimeo_root, folder, ipb):
    cfg = dict(
        type="SRVimeo90KMultipleGTCompressDataset", cprs_folder=str(vimeo_root / folder),
        gt_folder=str(vimeo_root / "sharp"), ann_file=str(vimeo_root / "keys.txt"),
        num_input_frames=7,
        pipeline=[dict(type="LoadImageFromFileList_ipb", key="lq", replace_qp_withIPB=ipb,
                       qp_slice_file=str(vimeo_root / "qp.json"))],
    )
    ours, theirs = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        _assert_samples_equal(ours.load_clip(i), theirs.load_clip(i))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Two KITTI-layout sequences at 32x48; one MV sidecar removed."""
    from make_kitti_fixture import write_kitti_fixture

    root = write_kitti_fixture(tmp_path_factory.mktemp("kitti"), height=H, width=W, crf=25)
    (root / "crf25" / "mv" / "000001" / "11.npy").unlink()
    return root


@pytest.mark.parametrize("name", ["KITTIMultipleGTMixCompressDataset", "WMGANDataset_test_kitti"])
def test_kitti_pairs_equal_jax(kitti_root, name):
    cfg = dict(type=name, lq_folder=str(kitti_root / "crf25" / "png"),
               gt_folder=str(kitti_root / "clean"),
               pipeline=[dict(type="LoadImageFromFileList_ipb", key="lq",
                              qp_slice_file=str(kitti_root / "qp.json"))])
    ours, theirs = build_dataset(cfg), jax_build_dataset(cfg)
    assert len(ours) == len(theirs) == 2 and ours.base_qp == 25
    clips = list(ours)
    for i, got in enumerate(clips):
        _assert_samples_equal(got, theirs.load_clip(i))
    assert np.abs(clips[0]["mvs"][1]).max() > 0 and np.abs(clips[1]["mvs"]).max() == 0


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """2 DAVIS-layout clips x 20 frames at 32x32, CRF 15/25/35 and sharp."""
    from make_protocol_fixture import write_fixture

    root = tmp_path_factory.mktemp("davis")
    merged = {}
    for crf in (15, 25, 35):
        write_fixture(root, clips=("bear", "boat"), frames=20, height=32, width=32, crf=crf,
                      seed=0, quiet=True)
        merged.update(json.loads((root / "qp.json").read_text()))
    (root / "qp.json").write_text(json.dumps(merged))
    return root


@pytest.mark.parametrize("index_stage", ["GenerateFrameIndicesEDVR_mix",
                                         "GenerateSegmentIndices_Mix_Compress"])
def test_big_mixture_equals_jax(davis_root, index_stage):
    """Two datasets of the mixture (dicts of folders and of qp files), the
    EDVR centre window with its border redraw or the segment window, the
    config's sample stages; JAX's draws for the same seeds."""
    roots = lambda sub: {"A": f"{davis_root}/{sub}/png", "B": f"{davis_root}/{sub}/png"}  # noqa: E731
    qp = str(davis_root / "qp.json")
    cfg = dict(
        type="BigMultipleGTMixCompressDataset", lq_folder=roots("crf15"),
        gt_folder=roots("sharp"), cprs15_folder=roots("crf15"), cprs25_folder=roots("crf25"),
        cprs35_folder=roots("crf35"), num_input_frames=5, sequence_length={"A": 20, "B": 12},
        scale=1,
        pipeline=[
            dict(type=index_stage, interval_list=[1, 2]),
            dict(type="TemporalReverse", keys=["lq_path", "gt_path"], reverse_ratio=0.5),
            dict(type="LoadImageFromFileList_Mix_Compress_ipb_mixdataset", key="lq",
                 qp_slice_file={"A": qp, "B": qp}, data_ratio=[0.25, 0.5, 0.75, 1.0]),
            dict(type="RescaleToZeroOne", keys=["lq", "gt"]),
            dict(type="PairedRandomCrop_mv", gt_patch_size=16),
            dict(type="Flip", keys=["lq", "gt"], flip_ratio=0.5, direction="horizontal"),
            dict(type="RandomTransposeHW", keys=["lq", "gt"], transpose_ratio=0.5),
        ],
    )
    ours, theirs = build_dataset(cfg), jax_build_dataset(cfg)
    np.testing.assert_array_equal(ours.p, theirs.p)
    for seed in SEEDS:
        _assert_samples_equal(ours.sample(np.random.default_rng(seed)),
                              theirs.sample(np.random.default_rng(seed)))


def test_other_dataset_types_name_item_8():
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        build_dataset(dict(type="SRAnnotationDataset"))


# ---- the KITTI CLI ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "kitti_tiny.py"
    path.write_text(
        f"_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / 'HR_davis_LR_128x128.py')!r}]\n"
        "model = dict(generator=dict(mid_channels=8, num_blocks=1, num_experts=2))\n")
    return path


def test_kitti_cli_equals_evaluate_dataset(kitti_root, tiny_cfg, tmp_path, capsys):
    """``-`` and a reference-named ``.npz`` (seeded weights): the CLI prints
    and returns the port's evaluate_dataset metrics on the same pairs, and
    writes each sequence's enhanced PNGs."""
    import torch_test_kitti

    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.data.extra_datasets import KittiPairDataset
    from pnp_vcve_torch.train.eval import evaluate_dataset

    cfg = Config.fromfile(tiny_cfg)
    lq, gt, qp = kitti_root / "crf25" / "png", kitti_root / "clean", kitti_root / "qp.json"
    dataset = KittiPairDataset(str(lq), str(gt), str(qp))
    seeded = build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu", seed=7)
    npz = tmp_path / "w.npz"
    np.savez(npz, **{k: v.numpy() for k, v in seeded.generator.state_dict().items()})
    for ckpt, seed in (("-", 0), (str(npz), 7)):
        want = evaluate_dataset(build_restorer(cfg.model, cfg.get("test_cfg"), device="cpu",
                                               seed=seed), dataset, verbose=False)
        capsys.readouterr()
        got = torch_test_kitti.main([str(tiny_cfg), ckpt, "--testdir_lr", str(lq),
                                     "--testdir_gt", str(gt), "--qp-slice-file", str(qp),
                                     "--device", "cpu", "--save-path", str(tmp_path / "out"),
                                     "--save-image"])
        assert got == want and set(got) == {"PSNR", "SSIM"}
        assert capsys.readouterr().out.splitlines()[-1] == ", ".join(
            f"{k}: {v:.4f}" for k, v in want.items())
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["000000", "000001"]


def test_kitti_cli_at_kitti_frame_size(tiny_cfg, tmp_path):
    """One sequence at KITTI's 375x1242 under the training config's
    'padgather' warp: finite metrics (the serving config's 'pf' would need
    sides that are multiples of 16)."""
    import torch_test_kitti
    from make_kitti_fixture import write_kitti_fixture

    root = write_kitti_fixture(tmp_path, seqs=("000000",), height=375, width=1242)
    torch.manual_seed(0)
    got = torch_test_kitti.main([str(tiny_cfg), "-", "--testdir_lr", str(root / "crf15" / "png"),
                                 "--testdir_gt", str(root / "clean"), "--qp-slice-file",
                                 str(root / "qp.json"), "--device", "cpu"])
    assert set(got) == {"PSNR", "SSIM"} and all(np.isfinite(v) for v in got.values())
