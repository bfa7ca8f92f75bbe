#!/usr/bin/env python
"""Evaluation entry point of the PyTorch/CUDA port (the argument contract of
tools/test.py, plus ``--device``).

    python tools/torch_test.py CONFIG CHECKPOINT [--testdir_lr D] [--testdir_gt D]
        [--save-path P --save-image] [--chunk-t N] [--cfg-options k=v ...]
        [--out metrics.pkl] [--device cuda|cpu]
        [--frame-parallel exact [--stream-clips N] [--pipeline-devices cuda:0,cuda:1]]
        [--launcher pytorch] [--multihost]
        [--cascade [--cascade_config CFG] [--cascade_ckpt CKPT|-]]
        [--joint-pqf-config CFG [--joint-pqf-ckpt CKPT|-]]

CONFIG is any config file, for example the port's own
``pnp_vcve_torch/configs/HR_davis_LR_128x128_serving.py``. CHECKPOINT is a
``.pth`` or ``.npz`` state dict under the original reference's names, a
training checkpoint of tools/torch_train.py, or ``-`` for a random init.
``--device cuda`` (the default) runs the CUDA kernels and fails when there
is no GPU; ``--device cpu`` runs the kernels' plain PyTorch versions.

``--frame-parallel exact`` runs each clip through the exact chunked
two-sweep pipeline (pnp_vcve_torch/parallel/seqpar.py), equal bit for bit
to the plain run, over every local card or over ``--pipeline-devices``
(this port's option: a comma-separated device list, repeats allowed, e.g.
``cuda:0,cuda:0`` for two chunks on one card); ``--stream-clips N`` streams
N same-shape clips through it together. ``--launcher pytorch`` or
``--multihost`` joins the ``torchrun`` world (tools/torch_dist_test.sh):
each rank takes the card ``LOCAL_RANK % device_count`` and its rank-strided
share of the clips, and the dataset mean is the exact count-weighted
reduction over the ranks (gloo); rank 0 writes ``--out``.

``--cascade`` feeds each enhanced clip to a downstream model, built from
``--cascade_config`` (default: CONFIG) with the weights of
``--cascade_ckpt`` (default ``-``), and scores its output, for example
vanilla BasicVSR++, BasicVSR, IconVSR or RealBasicVSR at x4 against
``--testdir_gt`` pointed at the x4 frames. The downstream model takes the
whole clip and returns every frame; the window models (EDVR, TDAN, TOFlow)
return one centre frame a window, so they do not fit the cascade, in the
JAX package's tools/test.py as here.
``--joint-pqf-config`` runs the MFQE two-model joint protocol: CONFIG and
CHECKPOINT are the non-PQF model, ``--joint-pqf-config`` and
``--joint-pqf-ckpt`` (default ``-``) the PQF model; PQFs are enhanced first
from the decoded frames, then the non-PQFs against the enhanced PQFs.
Both checkpoints take what CHECKPOINT takes.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


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
    p.add_argument(
        "--frame-parallel", choices=["exact"], default=None,
        help="'exact': chunked two-sweep pipeline over the local cards (or "
        "--pipeline-devices), equal bit for bit to the single-device sweep",
    )
    p.add_argument(
        "--stream-clips", type=int, default=1,
        help="with --frame-parallel exact: stream N same-shape clips through the "
        "pipeline together (each device holds the backward features of N clips)",
    )
    p.add_argument("--pipeline-devices", default=None,
                   help="with --frame-parallel exact: comma-separated devices, one per chunk")
    p.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                   help="'pytorch': join the torchrun world (RANK, WORLD_SIZE, LOCAL_RANK)")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun world; clips shard across the ranks")
    p.add_argument(
        "--joint-pqf-config", default=None,
        help="PQF model config: run the MFQE two-model joint protocol "
        "(PQFs enhanced first, non-PQFs reference the enhanced PQFs)",
    )
    p.add_argument("--joint-pqf-ckpt", default=None,
                   help="PQF model state dict (.pth/.npz) or '-' (the default) for random init")
    p.add_argument("--cascade", action="store_true",
                   help="feed the enhanced clips to a downstream clip model (BasicVSR++, "
                   "BasicVSR, IconVSR, RealBasicVSR) and score its output; the window "
                   "models (EDVR, TDAN, TOFlow) return a centre frame and do not fit")
    p.add_argument("--cascade_config", default=None,
                   help="config of the downstream (VSR) model; default: CONFIG")
    p.add_argument("--cascade_ckpt", default=None,
                   help="downstream model state dict or '-' (the default) for random init")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import os

    import torch

    device = torch.device(args.device)
    distributed = args.multihost or args.launcher == "pytorch"
    if distributed:
        from pnp_vcve_torch.parallel.multihost import init_distributed

        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
        device = init_distributed("pytorch", device.type)
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    devices = ([torch.device(d) for d in args.pipeline_devices.split(",")]
               if args.pipeline_devices else None)

    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.train.eval import evaluate_dataset, evaluate_dataset_mfqe_joint

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

    def other_model(config, checkpoint):
        """The restorer of another config on this device, with its weights."""
        other = Config.fromfile(config)
        r = build_restorer(other.model, other.get("test_cfg"), device=device)
        load_generator_weights(r.generator, checkpoint or "-")
        return r

    if args.joint_pqf_config:
        # the main config and checkpoint are the non-PQF model; every rank
        # runs the whole dataset, as in tools/test.py
        pqf = other_model(args.joint_pqf_config, args.joint_pqf_ckpt)
        metrics = evaluate_dataset_mfqe_joint(
            pqf.generator, restorer.generator, dataset, restorer,
            save_path=args.save_path, save_image=args.save_image)
    else:
        cascade = None
        if args.cascade:
            casc = other_model(args.cascade_config or args.config, args.cascade_ckpt)
            cascade = (casc.generator, casc)
        metrics = evaluate_dataset(
            restorer,
            dataset,
            save_path=args.save_path,
            save_image=args.save_image,
            chunk_t=args.chunk_t,
            cascade=cascade,
            distributed=distributed,
            frame_parallel=args.frame_parallel,
            stream_clips=args.stream_clips,
            devices=devices,
        )
    if metrics:
        print(", ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
    if distributed:
        import torch.distributed as dist

        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:  # rank 0 writes the result
            return metrics
    if args.out:
        import pickle

        with open(args.out, "wb") as f:
            pickle.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
