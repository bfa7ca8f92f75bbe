#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port: the restorer path of
tools/train.py (:640-884), plus ``--device``.

    python tools/torch_train.py CONFIG [--work-dir D] [--resume-from P]
        [--load-from P] [--total-iters N] [--seed S] [--device cuda|cpu]
        [--cfg-options k=v ...]

CONFIG is any config file, for example
``pnp_vcve_torch/configs/HR_davis_LR_128x128.py``. Checkpoints go to
``<work_dir>/ckpt/<step>.pth``. ``--resume-from`` takes a work dir (its
newest checkpoint) or one checkpoint file and continues its weights, Adam
moments, schedule and data stream; ``--load-from`` takes weights only.
``--device cuda`` (the default) runs the CUDA kernels and fails when there
is no GPU; ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# model types of tools/train.py's other branches
UNPORTED_TYPES = (
    "CycleGAN", "DIC",
    "GLInpaintor", "OneStageInpaintor", "DeepFillv1Inpaintor", "DeepFillv2Inpaintor",
    "TwoStageInpaintor", "AOTInpaintor", "PConvInpaintor",
    "DIM", "GCA", "IndexNet", "IndexNetMattor", "GCAMattor",
)
# the generators it trains: the flagship's names; the baselines that
# tools/torch_test.py evaluates (BasicVSR++, MFQEv2) train in a later slice
TRAINED_GENERATORS = ("PnPVCVE", "IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a PnP-VCVE model (PyTorch/CUDA port)")
    p.add_argument("config", help="train config file path")
    p.add_argument("--work-dir", help="dir to save logs and checkpoints")
    p.add_argument("--resume-from", help="work dir or checkpoint file to resume from")
    p.add_argument("--load-from", help="weights to start from")
    p.add_argument("--total-iters", type=int, default=None, help="override total iters")
    p.add_argument("--seed", type=int, default=0, help="random seed (weights and data)")
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="override config entries: key.path=value")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    from pnp_vcve_torch.core.builder import (
        build_dataset,
        build_optimizer,
        build_restorer,
        build_train_datasets,
    )
    from pnp_vcve_torch.core.checkpoint import (
        CheckpointManager,
        load_generator_weights,
        restore_train_state,
    )
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.data.loader import PrefetchLoader, WeightedMixture
    from pnp_vcve_torch.train.eval import evaluate_dataset
    from pnp_vcve_torch.train.loop import train_loop
    from pnp_vcve_torch.train.state import TrainState
    from pnp_vcve_torch.train.train_step import make_train_step

    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    if args.work_dir:
        cfg.work_dir = args.work_dir
    total_iters = args.total_iters or cfg.total_iters

    if cfg.model.get("type") in UNPORTED_TYPES or cfg.model.get("discriminator") is not None:
        raise NotImplementedError(
            f"training {cfg.model.get('type')!r} (GAN, CycleGAN, inpainting, matting, DIC) "
            "is not ported yet (ROADMAP Queue A item 8)"
        )
    gen_type = dict(cfg.model.get("generator") or {}).get("type")
    if gen_type not in TRAINED_GENERATORS:
        raise NotImplementedError(f"training the baseline {gen_type!r} is not ported yet "
                                  "(ROADMAP Queue A item 8)")

    os.makedirs(cfg.work_dir, exist_ok=True)
    log_file = open(os.path.join(cfg.work_dir, "train.log"), "a")

    def log(msg: str):
        print(msg, flush=True)
        log_file.write(msg + "\n")
        log_file.flush()

    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device, seed=args.seed)
    model = restorer.generator
    log(f"device {device}; model params "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")

    datasets = build_train_datasets(cfg.data["train"])
    loader_cfg = cfg.data.get("train_dataloader", {})
    weights = loader_cfg.get("weights", [1] * len(datasets))
    source = WeightedMixture(datasets, weights) if len(datasets) > 1 else datasets[0]

    optimizer, scheduler = build_optimizer(cfg.optimizers, model, cfg.get("lr_config"),
                                           total_iters)
    state = TrainState(step=0, model=model, optimizer=optimizer, scheduler=scheduler)
    ckpt = CheckpointManager(cfg.work_dir)
    if args.resume_from:
        state, _ = restore_train_state(args.resume_from, state)
        log(f"resumed the full train state at iter {state.step}")
    elif args.load_from:
        load_generator_weights(model, args.load_from)
        log(f"loaded weights from {args.load_from}")

    tr_cfg = cfg.get("train_cfg", {}) or {}
    # fix_iter freezes SPyNet/EDVR-style submodules for the warm-up
    # (reference basicvsr.py:95-103); the flagship has none of them
    fix_iter = tr_cfg.get("fix_iter", tr_cfg.get("fix_spynet_iter", 0)) or 0
    freeze_prefixes = tuple(tr_cfg.get("freeze_prefixes", ("spynet", "edvr")))
    train_step = make_train_step(model, restorer.loss_fn(), fix_iter=fix_iter,
                                 freeze_prefixes=freeze_prefixes)

    # periodic validation (reference DistEvalIterHook); the dataset is built
    # at the first evaluation, so a run that never evaluates needs none
    eval_cfg = cfg.get("evaluation", {}) or {}
    eval_interval = int(eval_cfg.get("interval", 0) or 0)
    val_cfg = cfg.data.get("val")
    val_dataset = []

    def eval_fn(_model):
        if not val_dataset:
            val_dataset.append(build_dataset(dict(val_cfg)))
        save = bool(eval_cfg.get("save_image", False))
        return evaluate_dataset(
            restorer, val_dataset[0],
            save_path=os.path.join(cfg.work_dir, "val") if save else None,
            save_image=save, chunk_t=eval_cfg.get("chunk_t"), verbose=False,
        )

    loader = PrefetchLoader(source, batch_size=loader_cfg.get("samples_per_gpu", 5),
                            seed=args.seed, num_threads=cfg.data.get("workers_per_gpu", 6),
                            device=device, start_step=state.step)
    ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
    try:
        train_loop(
            state,
            train_step,
            loader,
            total_iters=total_iters,
            log_interval=cfg.get("log_config", {}).get("interval", 100),
            checkpoint_interval=ckpt_cfg.get("interval", 2000),
            eval_interval=eval_interval if val_cfg is not None else 0,
            eval_fn=eval_fn,
            ckpt_manager=ckpt,
            logger=log,
            start_iter=state.step,
            save_optimizer=bool(ckpt_cfg.get("save_optimizer", True)),
        )
    finally:
        loader.stop()
        log_file.close()
    return state


if __name__ == "__main__":
    main()
