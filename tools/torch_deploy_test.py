#!/usr/bin/env python
"""Score an exported PyTorch/CUDA port program over a test dataset (the
port's counterpart of tools/deploy_test.py): the metrics come from the
deployed artifact of tools/torch_export_model.py, not from the live model,
so a deployment regression shows in PSNR/SSIM.

    python tools/torch_deploy_test.py CONFIG model.pt2 [--testdir_lr D]
        [--testdir_gt D] [--out out.pkl] [--cfg-options k=v ...]
        [--device cuda|cpu]

The artifact fixes its input at ``(1, t, h, w)``, read from its input
signature. Each clip runs as consecutive windows of t frames (a tail
shorter than t is dropped, and a clip shorter than t with it), centre-
cropped to h x w, as tools/deploy_test.py:59-101 does. Per clip: PSNR and
SSIM on uint8-quantised frames (no border crop), printed as
``[deploy-test] <clip>: PSNR=... SSIM=...``; then the dataset mean, which
``--out`` pickles. ``--device`` must be the one the artifact was exported
on (``cuda``, the default, runs the kernels).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Score an exported PnP-VCVE program")
    p.add_argument("config")
    p.add_argument("exported", help="program saved by tools/torch_export_model.py")
    p.add_argument("--testdir_lr", default=None)
    p.add_argument("--testdir_gt", default=None)
    p.add_argument("--out", default=None, help="metrics pickle")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", help="the device the artifact was exported on")
    return p.parse_args(argv)


def windows(sample: dict, t_e: int, h_e: int, w_e: int):
    """``(inputs, gt)`` of each whole window of ``t_e`` frames of a clip,
    centre-cropped to ``h_e x w_e``: the model's six inputs with a batch
    axis, numpy, and the window's GT frames."""
    t, h, w = sample["lq"].shape[:3]
    top, left = max(0, (h - h_e) // 2), max(0, (w - w_e) // 2)
    rows, cols = slice(top, top + h_e), slice(left, left + w_e)
    for s in range(0, t - t_e + 1, t_e):
        win = slice(s, s + t_e)
        inputs = (sample["lq"][win][None][:, :, rows, cols], sample["qps"][win][None],
                  sample["slices"][win][None], sample["mvs"][win][None][:, :, rows, cols],
                  sample["base_qps"][win][None], sample["partitions"][win][None][:, :, rows, cols])
        yield inputs, sample["gt"][win][:, rows, cols]


def clip_metrics(out, gt) -> dict:
    """PSNR and SSIM of each frame (uint8, no border crop), averaged."""
    import numpy as np

    from pnp_vcve_torch.metrics import tensor2img
    from pnp_vcve_torch.metrics.quality import psnr, ssim

    vals_p, vals_s = [], []
    for a, b in zip(out, gt):
        a, b = tensor2img(a), tensor2img(b)
        vals_p.append(psnr(a, b, crop_border=0))
        vals_s.append(ssim(a, b, crop_border=0))
    return {"PSNR": float(np.mean(vals_p)), "SSIM": float(np.mean(vals_s))}


def score(forward, dataset, t_e: int, h_e: int, w_e: int, device, verbose: bool = True):
    """Run ``forward`` (the loaded program) over every clip's windows;
    returns ``(per-clip metrics {name: metrics}, dataset mean)``."""
    import numpy as np
    import torch

    from pnp_vcve_torch.models.restorer import average_clip_metrics

    per_clip = {}
    for sample in dataset:
        outs, gts = [], []
        for inputs, gt in windows(sample, t_e, h_e, w_e):
            args = [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
                    for a in inputs]
            with torch.no_grad():
                outs.append(forward(*args)[0].float().cpu().numpy())
            gts.append(gt)
        if not outs:
            continue
        name = sample.get("clip_name", f"clip{len(per_clip) + 1:03d}")
        per_clip[name] = m = clip_metrics(np.concatenate(outs), np.concatenate(gts))
        if verbose:
            print(f"[deploy-test] {name}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    return per_clip, average_clip_metrics(list(per_clip.values()))


def main(argv=None):
    args = parse_args(argv)

    import torch

    import pnp_vcve_torch.kernels  # noqa: F401  (registers the ops the artifact calls)
    from pnp_vcve_torch.core.builder import build_dataset
    from pnp_vcve_torch.core.config import Config
    from tools.torch_export_model import input_shape

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    test_cfg = dict(cfg.data["test"])
    if args.testdir_lr:
        test_cfg["lq_folder"] = args.testdir_lr
    if args.testdir_gt:
        test_cfg["gt_folder"] = args.testdir_gt
    dataset = build_dataset(test_cfg)

    program = torch.export.load(args.exported)
    t_e, h_e, w_e = input_shape(program)
    print(f"deployed artifact expects windows of (t={t_e}, h={h_e}, w={w_e})")
    per_clip, agg = score(program.module(), dataset, t_e, h_e, w_e, device)
    if agg:
        print("[deploy-test] dataset mean: " + ", ".join(f"{k}: {v:.4f}" for k, v in agg.items()))
    if args.out:
        import pickle

        with open(args.out, "wb") as f:
            pickle.dump(agg, f)
    return per_clip, agg


if __name__ == "__main__":
    main()
