#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port: the restorer path of
tools/train.py (:640-884) with every option of its CLI (:22-41), plus
``--device``.

    python tools/torch_train.py CONFIG [--work-dir D | --exp_name NAME]
        [--resume-from P] [--load-from P] [--total-iters N] [--seed S]
        [--deterministic] [--autoscale-lr] [--device cuda|cpu]
        [--launcher none|pytorch] [--local_rank R] [--multihost]
        [--time-allreduce] [--cfg-options k=v ...]

CONFIG is any config file, for example
``pnp_vcve_torch/configs/HR_davis_LR_128x128.py``. Checkpoints go to
``<work_dir>/ckpt/<step>.pth``, the log to ``<work_dir>/train.log``, the
logged scalars unrounded to ``<work_dir>/scalars.json`` (a JSON object a
line) and, where tensorboardX or tensorboard is installed, to
``<work_dir>/tb``. ``--exp_name NAME`` sets the work dir to
``./work_dirs/NAME`` unless ``--work-dir`` is given. ``--resume-from``
takes a work dir (its newest checkpoint) or one checkpoint file and
continues its weights, Adam moments, schedule and data stream;
``--load-from`` takes weights only. ``--deterministic`` turns on PyTorch's
deterministic algorithms (cuDNN's too) for the run. ``--autoscale-lr`` is
accepted and ignored, as tools/train.py does. ``--device cuda`` (the
default) runs the CUDA kernels and fails when there is no GPU; ``--device
cpu`` runs the kernels' plain PyTorch versions.

``--launcher pytorch`` or ``--multihost`` joins the ``torchrun`` world
(tools/torch_dist_train.sh) and trains data-parallel, as tools/train.py
trains over its mesh's ``dp`` axis: the global batch is ``samples_per_gpu``
times the world size, each rank loads its rows of it and takes the card
``LOCAL_RANK % cards``, and the gradients and the logged loss are averaged
over the ranks every step. Rank 0 alone writes the log, the scalars, the
visual grids and the checkpoints. ``--time-allreduce`` has rank 0 time each
step's all-reduce (it synchronises the card before and after it) and log
the mean with the loss.
"""

import argparse
import json
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
    p.add_argument("--exp_name", type=str, default=None,
                   help="experiment name: the work dir is ./work_dirs/NAME")
    p.add_argument("--resume-from", help="work dir or checkpoint file to resume from")
    p.add_argument("--load-from", help="weights to start from")
    p.add_argument("--seed", type=int, default=0, help="random seed (weights and data)")
    p.add_argument("--deterministic", action="store_true",
                   help="PyTorch's and cuDNN's deterministic algorithms")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="override config entries: key.path=value")
    p.add_argument("--total-iters", type=int, default=None, help="override total iters")
    p.add_argument("--multihost", action="store_true",
                   help="join the torchrun world (several nodes through tools/torch_dist_train.sh)")
    p.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                   help="'pytorch': join the torchrun world (RANK, WORLD_SIZE, LOCAL_RANK)")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--autoscale-lr", action="store_true",
                   help="accepted and ignored, as tools/train.py does")
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    p.add_argument("--time-allreduce", action="store_true",
                   help="rank 0 times each step's gradient all-reduce (profiling: two "
                        "device synchronisations a step)")
    return p.parse_args(argv)


def _deterministic(on: bool):
    """Set PyTorch's and cuDNN's deterministic algorithms; returns the
    previous settings as a function that restores them."""
    import torch

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    if on:
        # read when cuBLAS starts: set before any CUDA work
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # warn_only: an op with no deterministic form warns instead of stopping
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def restore():
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]
    return restore


def _visual_fn(cfg, model):
    """The VisualizationHook of ``visual_config`` (tools/train.py:828-862),
    or None where the config has none (the shipped configs)."""
    vcfg = cfg.get("visual_config") or None
    if not vcfg or int(vcfg.get("interval", -1) or -1) <= 0:
        return None
    import torch

    from pnp_vcve_torch.train.train_step import _model_inputs
    from pnp_vcve_torch.train.visualization import VisualizationHook

    hook = VisualizationHook(
        output_dir=vcfg.get("output_dir", os.path.join(cfg.work_dir, "visual")),
        res_name_list=list(vcfg.get("res_name_list", ["lq", "gt", "output"])),
        interval=int(vcfg["interval"]),
        rerange=bool(vcfg.get("rerange", False)),
        nrow=int(vcfg.get("nrow", 1)),
        padding=int(vcfg.get("padding", 4)),
    )

    def visual_fn(step, batch, _state):
        if (step + 1) % hook.interval != 0:
            return
        with torch.no_grad():
            out = model(**_model_inputs(batch))
        hook(step, {"lq": batch["lq"].cpu().numpy(), "gt": batch["gt"].cpu().numpy(),
                    "output": out.cpu().numpy()})
    return visual_fn


def main(argv=None):
    args = parse_args(argv)

    import torch

    restore_determinism = _deterministic(args.deterministic)
    device = torch.device(args.device)
    distributed = args.multihost or args.launcher == "pytorch"
    if distributed:
        from pnp_vcve_torch.parallel.multihost import init_distributed

        os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
        device = init_distributed("pytorch", device.type)
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    try:
        return _train(args, device)
    finally:
        restore_determinism()
        if distributed:
            torch.distributed.destroy_process_group()


def _train(args, device):
    import torch

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
    from pnp_vcve_torch.kernels import LAUNCHES
    from pnp_vcve_torch.parallel.multihost import rank_and_world
    from pnp_vcve_torch.train.eval import evaluate_dataset
    from pnp_vcve_torch.train.loop import train_loop
    from pnp_vcve_torch.train.state import TrainState
    from pnp_vcve_torch.train.train_step import broadcast_module, make_train_step
    from pnp_vcve_torch.utils.logging import (
        JsonScalarWriter,
        TensorboardWriter,
        collect_env,
        get_root_logger,
    )

    rank, world = rank_and_world()
    launches_before = dict(LAUNCHES)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_options(dict(kv.split("=", 1) for kv in args.cfg_options))
    if args.exp_name:
        cfg.work_dir = os.path.join("./work_dirs", args.exp_name)
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

    logger = get_root_logger(log_file=os.path.join(cfg.work_dir, "train.log"))
    log = logger.info
    log("Environment:\n" + "\n".join(f"  {k}: {v}" for k, v in collect_env().items()))
    if args.autoscale_lr:
        log("--autoscale-lr is accepted and ignored (as tools/train.py does): the config's "
            "learning rate stands")

    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device, seed=args.seed)
    model = restorer.generator
    datasets = build_train_datasets(cfg.data["train"])
    loader_cfg = cfg.data.get("train_dataloader", {})
    weights = loader_cfg.get("weights", [1] * len(datasets))
    source = WeightedMixture(datasets, weights) if len(datasets) > 1 else datasets[0]
    samples_per_gpu = loader_cfg.get("samples_per_gpu", 5)
    log(f"device {device}; model params {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M; "
        f"global batch {samples_per_gpu * world} = {samples_per_gpu} x {world} rank(s)")

    optimizer, scheduler = build_optimizer(cfg.optimizers, model, cfg.get("lr_config"),
                                           total_iters)
    state = TrainState(step=0, model=model, optimizer=optimizer, scheduler=scheduler)
    ckpt = CheckpointManager(cfg.work_dir) if rank == 0 else None
    if args.resume_from:
        if world > 1:  # no rank reads a checkpoint another may still be writing
            torch.distributed.barrier()
        state, _ = restore_train_state(args.resume_from, state)
        log(f"resumed the full train state at iter {state.step}")
    elif args.load_from:
        load_generator_weights(model, args.load_from)
        log(f"loaded weights from {args.load_from}")
    if world > 1:
        broadcast_module(model)

    tr_cfg = cfg.get("train_cfg", {}) or {}
    # fix_iter freezes SPyNet/EDVR-style submodules for the warm-up
    # (reference basicvsr.py:95-103); the flagship has none of them
    fix_iter = tr_cfg.get("fix_iter", tr_cfg.get("fix_spynet_iter", 0)) or 0
    freeze_prefixes = tuple(tr_cfg.get("freeze_prefixes", ("spynet", "edvr")))
    train_step = make_train_step(model, restorer.loss_fn(), fix_iter=fix_iter,
                                 freeze_prefixes=freeze_prefixes, world=world,
                                 time_reduce=args.time_allreduce and rank == 0)

    # periodic validation (reference DistEvalIterHook): every rank evaluates
    # its share of the clips; the dataset is built at the first evaluation
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
            distributed=world > 1,
        )

    loader = PrefetchLoader(source, batch_size=samples_per_gpu, seed=args.seed,
                            num_threads=cfg.data.get("workers_per_gpu", 6), device=device,
                            start_step=state.step, rank=rank, world=world)
    ckpt_cfg = cfg.get("checkpoint_config", {}) or {}
    writer = JsonScalarWriter(os.path.join(cfg.work_dir, "scalars.json"),
                              TensorboardWriter(os.path.join(cfg.work_dir, "tb")))
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
            metrics_writer=writer,
            visual_fn=_visual_fn(cfg, model) if rank == 0 else None,
        )
    finally:
        loader.stop()
        writer.close()
    launches = {k: v - launches_before[k] for k, v in LAUNCHES.items()}
    if world > 1:
        every = [None] * world
        torch.distributed.all_gather_object(every, launches)
        log("kernel launches by rank: " + json.dumps(every))
    else:
        log("kernel launches: " + json.dumps(launches))
    return state


if __name__ == "__main__":
    main()
