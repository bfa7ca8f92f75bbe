#!/usr/bin/env python
"""Evaluation entry point of the PyTorch/CUDA port (the argument contract of
tools/test.py, plus ``--device``).

    python tools/torch_test.py CONFIG CHECKPOINT [--testdir_lr D] [--testdir_gt D]
        [--save-path P --save-image] [--chunk-t N] [--cfg-options k=v ...]
        [--out metrics.pkl] [--device cuda|cpu]

CONFIG is any config file, for example the port's own
``pnp_vcve_torch/configs/HR_davis_LR_128x128_serving.py``. CHECKPOINT is a
``.pth`` or ``.npz`` state dict under the original reference's names, a
training checkpoint of tools/torch_train.py, or ``-`` for a random init.
``--device cuda`` (the default) runs the CUDA kernels and fails when there
is no GPU; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# options of tools/test.py the port does not have yet -> ROADMAP item
UNPORTED = {
    "--frame-parallel": "Queue A item 6",
    "--stream-clips": "Queue A item 6",
    "--joint-pqf-config": "Queue A item 8",
    "--joint-pqf-ckpt": "Queue A item 8",
    "--cascade": "Queue A item 3",
    "--cascade_config": "Queue A item 3",
    "--cascade_ckpt": "Queue A item 3",
    "--multihost": "Queue A item 6",
    "--launcher": "Queue A item 6",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a PnP-VCVE model (PyTorch/CUDA port)")
    p.add_argument("config", help="test config file path")
    p.add_argument("checkpoint", help="state dict (.pth/.npz) or '-' for random init")
    p.add_argument("--testdir_lr", type=str, default=None, help="override lq folder")
    p.add_argument("--testdir_gt", type=str, default=None, help="override gt folder")
    p.add_argument("--save-path", default=None, help="path to store enhanced frames")
    p.add_argument("--save-image", action="store_true", help="save enhanced frames")
    p.add_argument("--chunk-t", type=int, default=None, help="split clips into windows of N frames")
    p.add_argument("--out", default=None, help="output result pickle")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    # accepted as in tools/test.py; setting one raises with its ROADMAP item
    p.add_argument("--frame-parallel", default=None)
    p.add_argument("--stream-clips", type=int, default=1)
    p.add_argument("--joint-pqf-config", default=None)
    p.add_argument("--joint-pqf-ckpt", default=None)
    p.add_argument("--cascade", action="store_true")
    p.add_argument("--cascade_config", default=None)
    p.add_argument("--cascade_ckpt", default=None)
    p.add_argument("--launcher", default="none")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--multihost", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    defaults = parse_args([args.config, args.checkpoint])
    for option, item in UNPORTED.items():
        dest = option.lstrip("-").replace("-", "_")
        if getattr(args, dest) != getattr(defaults, dest):
            raise NotImplementedError(f"{option} is not ported to the PyTorch port yet "
                                      f"(ROADMAP {item})")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.train.eval import evaluate_dataset

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    test_cfg = dict(cfg.data["test"])
    if args.testdir_lr:
        test_cfg["lq_folder"] = args.testdir_lr
    if args.testdir_gt:
        test_cfg["gt_folder"] = args.testdir_gt

    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device)
    load_generator_weights(restorer.generator, args.checkpoint)
    dataset = build_dataset(test_cfg)

    metrics = evaluate_dataset(
        restorer,
        dataset,
        save_path=args.save_path,
        save_image=args.save_image,
        chunk_t=args.chunk_t,
    )
    if metrics:
        print(", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    if args.out:
        import pickle

        with open(args.out, "wb") as f:
            pickle.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
