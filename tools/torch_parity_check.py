#!/usr/bin/env python
"""Checkpoint-parity gate of the PyTorch/CUDA port (the port's counterpart
of tools/parity_check.py, with the same flags and ``--device``).

Fixture mode, the armed gate, which needs no external asset:

    python tools/torch_parity_check.py --fixture [tests/fixtures/parity]
        [--clips-limit N] [--tamper] [--device cuda|cpu]

regenerates the synthetic compressed-clip dataset from the fixture's
``spec.json`` (tools/data/make_synthetic_dataset.py), loads the recorded
reference weights ``state_dict.npz`` under their own names into the
flagship generator at the spec's widths (64 channels, 8 blocks, 6
experts), enhances each clip through ``train.eval.enhance_clip`` and
asserts, per clip, max|output diff| against ``expected.npz`` <= 2e-3 and
PSNR / SSIM against ``per_clip_metrics`` within 0.05 dB / 0.001
(tools/parity_check.py:47-49). Exit 0 passes, 1 fails. ``--tamper`` adds
0.05 to ``conv_last.weight``: the gate must fail.

Asset mode:

    python tools/torch_parity_check.py CONFIG CKPT_PTH --testdir_lr D
        --testdir_gt D [--expect-psnr X --expect-ssim Y --tol-psnr 0.05
        --tol-ssim 0.001] [--num-blocks N] [--chunk-t N] [--device cuda|cpu]

evaluates CONFIG's restorer with the reference checkpoint (read under the
reference's names, as tools/torch_test.py reads it) over the test dirs
and asserts the dataset mean against the expected values. Missing files
skip the gate: exit 0 with the reason on stderr, as tools/parity_check.py
does. ``--num-blocks`` sets the generator's depth (default: CONFIG's).

``--device cuda`` (the default) runs the kernel path in float32 with TF32
off in cuDNN and cuBLAS (the recording is float32); ``cpu`` the kernels'
plain versions. It never falls back.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FIXTURE = "tests/fixtures/parity"
TOL_OUT = 2e-3  # tools/parity_check.py:47


def skip(reason: str):
    print(f"PARITY GATE SKIPPED: {reason}", file=sys.stderr)
    sys.exit(0)


def build_dataset_from_spec(spec: dict, root):
    """The fixture's dataset, written under ``root``."""
    from tools.data.make_synthetic_dataset import write_dataset

    write_dataset(root, spec["clips"], spec["frames"], *spec["hw"], seed=spec["dataset_seed"])


def load_test_clips(spec: dict, root) -> list:
    """Every clip of the dataset under ``root`` through the port's test
    pipeline (PNG frames, MV rasteriser, QP/slice lookup, /255)."""
    from pnp_vcve_torch.core.builder import build_dataset
    from pnp_vcve_torch.core.presets import flagship_data

    cfg = dict(flagship_data(test_lq=f"{root}/crf35/png", test_gt=f"{root}/sharp/png",
                             test_qp_json=f"{root}/qp.json")["test"])
    cfg["num_input_frames"] = spec["frames"]
    ds = build_dataset(cfg)
    return [ds.load_clip(i) for i in range(len(ds))]


def _device(name: str):
    """The device, with TF32 off on a card; refuses a missing card."""
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def run_fixture_gate(fixture_dir: str = FIXTURE, clips_limit: int = 0, tol_out: float = TOL_OUT,
                     tol_psnr: float = 0.05, tol_ssim: float = 0.001, tamper: bool = False,
                     device: str = "cuda") -> int:
    """The armed gate on the recorded fixture; returns 0 (passed) or 1."""
    import numpy as np

    from pnp_vcve_torch.core.builder import build_generator
    from pnp_vcve_torch.core.checkpoint import read_state_dict
    from pnp_vcve_torch.models.restorer import Restorer
    from pnp_vcve_torch.train.eval import enhance_clip
    from pnp_vcve_torch.train.train_step import make_eval_step

    fdir = Path(fixture_dir)
    for need in ("spec.json", "state_dict.npz", "expected.npz"):
        if not (fdir / need).exists():
            skip(f"fixture incomplete: {fdir / need} missing "
                 "(run tools/record_parity_fixture.py)")
    meta = json.loads((fdir / "spec.json").read_text())
    spec = meta["spec"]
    dev = _device(device)

    sd = read_state_dict(fdir / "state_dict.npz")
    if tamper:
        # conv_last feeds the output directly: a converter or numerics fault
        # of this size must trip the gate
        sd["conv_last.weight"] = sd["conv_last.weight"] + 0.05
    model = build_generator(dict(type="PnPVCVE", mid_channels=spec["mid_channels"],
                                 num_blocks=spec["num_blocks"], num_experts=spec["num_experts"],
                                 remat=False), device=dev)
    model.load_state_dict(sd, strict=True)
    model.eval()
    restorer = Restorer(model, test_cfg={"metrics": ["PSNR", "SSIM"], "crop_border": 0})
    eval_step = make_eval_step(model)

    with tempfile.TemporaryDirectory() as root:
        build_dataset_from_spec(spec, root)
        samples = load_test_clips(spec, root)
    if clips_limit:
        samples = samples[:clips_limit]

    failures = []
    with np.load(fdir / "expected.npz") as expected:
        for sample in samples:
            name = sample["clip_name"]
            out = enhance_clip(eval_step, sample)
            d = float(np.abs(out - expected[name].astype(np.float32)).max())
            m = restorer.evaluate_clip(out, sample["gt"])
            rm = meta["per_clip_metrics"][name]
            print(f"{name}: max|out diff|={d:.2e} PSNR={m['PSNR']:.4f} (rec {rm['PSNR']:.4f}) "
                  f"SSIM={m['SSIM']:.6f} (rec {rm['SSIM']:.6f})")
            if not d <= tol_out:
                failures.append(f"{name}: output diff {d:.2e} > {tol_out}")
            if not abs(m["PSNR"] - rm["PSNR"]) <= tol_psnr:
                failures.append(f"{name}: PSNR |d|={abs(m['PSNR'] - rm['PSNR']):.4f}")
            if not abs(m["SSIM"] - rm["SSIM"]) <= tol_ssim:
                failures.append(f"{name}: SSIM |d|={abs(m['SSIM'] - rm['SSIM']):.6f}")
    if failures:
        print("PARITY GATE FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(f"PARITY GATE PASSED (fixture: {len(samples)} clips, full flagship shape "
          f"mid={spec['mid_channels']} nb={spec['num_blocks']} K={spec['num_experts']}, "
          f"{dev.type})")
    return 0


def run_asset_gate(args) -> int:
    """The gate on a reference checkpoint and test folders; 0 or 1."""
    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.train.eval import evaluate_dataset

    dev = _device(args.device)
    cfg = Config.fromfile(args.config)
    if args.num_blocks is not None:
        cfg.model["generator"]["num_blocks"] = args.num_blocks
    test_cfg = dict(cfg.data["test"])
    test_cfg["lq_folder"] = args.testdir_lr
    test_cfg["gt_folder"] = args.testdir_gt
    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=dev)
    load_generator_weights(restorer.generator, args.checkpoint)
    restorer.generator.eval()
    metrics = evaluate_dataset(restorer, build_dataset(test_cfg), chunk_t=args.chunk_t,
                               verbose=True)
    print(", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))

    failures = []
    for key, want, tol in (("PSNR", args.expect_psnr, args.tol_psnr),
                           ("SSIM", args.expect_ssim, args.tol_ssim)):
        if want is not None and not abs(metrics[key] - want) <= tol:
            failures.append(f"{key} {metrics[key]:.4f} vs {want} "
                            f"(|d|={abs(metrics[key] - want):.4f})")
    if failures:
        print("PARITY GATE FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print("PARITY GATE PASSED" + (
        "" if args.expect_psnr is not None else
        " (no expected values given; metrics recorded above)"))
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Checkpoint-parity gate (PyTorch/CUDA port)")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("checkpoint", nargs="?", default=None, help="reference .pth path")
    p.add_argument("--fixture", nargs="?", default=None, const=FIXTURE,
                   help="run the armed fixture gate against this dir")
    p.add_argument("--clips-limit", type=int, default=0)
    p.add_argument("--tamper", action="store_true",
                   help="perturb one weight (the gate must FAIL; self-test)")
    p.add_argument("--testdir_lr", default=None)
    p.add_argument("--testdir_gt", default=None)
    p.add_argument("--expect-psnr", type=float, default=None)
    p.add_argument("--expect-ssim", type=float, default=None)
    p.add_argument("--tol-psnr", type=float, default=0.05)
    p.add_argument("--tol-ssim", type=float, default=0.001)
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--chunk-t", type=int, default=None)
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    if args.fixture:
        sys.exit(run_fixture_gate(args.fixture, clips_limit=args.clips_limit,
                                  tol_psnr=args.tol_psnr, tol_ssim=args.tol_ssim,
                                  tamper=args.tamper, device=args.device))
    if not args.config or not args.checkpoint:
        p.error("CONFIG and CKPT_PTH required (or use --fixture)")
    if not args.testdir_lr or not args.testdir_gt:
        p.error("--testdir_lr/--testdir_gt required (or use --fixture)")
    if not Path(args.checkpoint).exists():
        skip(f"reference checkpoint not found: {args.checkpoint}")
    if not Path(args.testdir_lr).exists() or not Path(args.testdir_gt).exists():
        skip(f"test data not found: {args.testdir_lr} / {args.testdir_gt}")
    sys.exit(run_asset_gate(args))


if __name__ == "__main__":
    main()
