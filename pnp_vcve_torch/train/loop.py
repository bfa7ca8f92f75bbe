"""Iteration-based training loop (counterpart of pnp_vcve_tpu/train/loop.py:
``train_loop`` :39-98; the reference's mmcv IterBasedRunner with its hooks,
mmedit/apis/train.py:75-239): a log line every ``log_interval`` iterations
(TextLoggerHook) and the writer's scalars, the visual hook after every
step (VisualizationHook, which gates on its own interval), a checkpoint
every ``checkpoint_interval`` (CheckpointHook), an evaluation every
``eval_interval`` (DistEvalIterHook) and a final checkpoint.

In a process group every rank runs the steps and the evaluations (each
evaluates its share of the clips); only rank 0 writes checkpoints, and the
other ranks wait at a barrier until each is on disk, so no rank reads a
checkpoint before it is whole. Logs, the writer and the visual hook are the
caller's to keep to rank 0 (tools/torch_train.py builds them there only).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from pnp_vcve_torch.parallel.multihost import rank_and_world

from .state import TrainState, state_payload

__all__ = ["train_loop"]


def train_loop(
    state: TrainState,
    train_step: Callable,
    loader: Iterable,
    total_iters: int,
    log_interval: int = 100,
    checkpoint_interval: int = 2000,
    eval_interval: int = 0,
    eval_fn: Optional[Callable] = None,
    ckpt_manager=None,
    logger: Callable[[str], None] = print,
    start_iter: int = 0,
    save_optimizer: bool = True,
    metrics_writer=None,
    visual_fn: Optional[Callable] = None,
) -> TrainState:
    """Run iterations ``start_iter .. total_iters - 1``. ``eval_fn(model)``
    returns a metrics dict; ``ckpt_manager`` is a
    :class:`pnp_vcve_torch.core.checkpoint.CheckpointManager`;
    ``metrics_writer.scalars(step, **values)`` takes the logged loss, the
    iteration rate and the evaluation's metrics (``val/<name>``);
    ``visual_fn(step, batch, state)`` runs after every step."""
    rank, world = rank_and_world()

    def save(step: int):
        if ckpt_manager is not None and rank == 0:
            ckpt_manager.save(step, state_payload(state, save_optimizer))
        if world > 1:
            torch.distributed.barrier()

    it = iter(loader)
    losses, reduce_s = [], []
    t_last = time.perf_counter()
    for step in range(start_iter, total_iters):
        batch = next(it)
        state, metrics = train_step(state, batch)
        losses.append(metrics["loss"])
        if "allreduce_s" in metrics:
            reduce_s.append(metrics["allreduce_s"])

        if visual_fn is not None:
            visual_fn(step, batch, state)

        if (step + 1) % log_interval == 0:
            loss = float(torch.stack(losses).mean())  # waits for the device
            losses.clear()
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            ips = log_interval / dt
            reduced = (f"; all-reduce {sum(reduce_s) / len(reduce_s):.4f} s/it over {world} ranks"
                       if reduce_s else "")
            reduce_s.clear()
            logger(f"iter {step + 1}/{total_iters} loss={loss:.5f} ({ips:.2f} it/s{reduced})")
            if metrics_writer is not None:
                metrics_writer.scalars(step + 1, loss=loss, iters_per_sec=ips)

        if (step + 1) % checkpoint_interval == 0:
            save(step + 1)

        if eval_fn is not None and eval_interval and (step + 1) % eval_interval == 0:
            metrics = eval_fn(state.model)
            logger(f"iter {step + 1} eval: "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
            if metrics_writer is not None:
                metrics_writer.scalars(step + 1, **{f"val/{k}": v for k, v in metrics.items()})
    save(total_iters)
    return state
