#!/usr/bin/env python
"""KITTI evaluation entry point of the PyTorch/CUDA port (the argument
contract of tools/test_kitti.py, plus ``--device``): the flagship restorer
on each KITTI sequence's fixed frame pair (10.png, 11.png), whole frames;
the enhanced pairs feed a downstream optical-flow model.

    python tools/torch_test_kitti.py CONFIG CHECKPOINT --testdir_lr KITTI/crf15/png \\
        --testdir_gt KITTI/clean [--qp-slice-file qp.json] [--save-path out/ --save-image]
        [--cfg-options k=v ...] [--launcher pytorch] [--device cuda|cpu]

CHECKPOINT is a ``.pth`` or ``.npz`` state dict under the reference's
names, a training checkpoint of tools/torch_train.py, or ``-`` for a random
init. ``base_qp`` comes from the ``crf<N>`` in ``--testdir_lr``; the MV
sidecars lie beside the PNGs with 'png' -> 'mv' in the path, and a missing
one is zero motion. ``--launcher pytorch`` joins the ``torchrun`` world:
each rank enhances its share of the sequences and the means are reduced
over the ranks. ``--device cuda`` (the default) runs the CUDA kernels and
fails when there is no GPU; ``--device cpu`` runs their plain versions.
The frame size is any the config's warp takes: KITTI's 375x1242 under the
training config's ``padgather``; the serving config's ``pf`` needs sides
that are multiples of 16.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test on KITTI frame pairs (PyTorch/CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint", help="state dict (.pth/.npz) or '-' for random init")
    p.add_argument("--testdir_lr", required=True)
    p.add_argument("--testdir_gt", required=True)
    p.add_argument("--qp-slice-file", default=None)
    p.add_argument("--save-path", default=None)
    p.add_argument("--save-image", action="store_true")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                   help="'pytorch': join the torchrun world; sequences shard over the ranks")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    device = torch.device(args.device)
    distributed = args.launcher == "pytorch"
    if distributed:
        from pnp_vcve_torch.parallel.multihost import init_distributed

        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
        device = init_distributed("pytorch", device.type)
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.data.extra_datasets import KittiPairDataset
    from pnp_vcve_torch.train.eval import evaluate_dataset

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device)
    load_generator_weights(restorer.generator, args.checkpoint)
    dataset = KittiPairDataset(lq_folder=args.testdir_lr, gt_folder=args.testdir_gt,
                               qp_slice_file=args.qp_slice_file)
    try:
        metrics = evaluate_dataset(restorer, dataset, save_path=args.save_path,
                                   save_image=args.save_image, distributed=distributed)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()
    if metrics:
        print(", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    return metrics


if __name__ == "__main__":
    main()
