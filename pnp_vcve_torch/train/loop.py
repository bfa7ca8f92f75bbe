"""Iteration-based training loop (counterpart of pnp_vcve_tpu/train/loop.py:
``train_loop`` :39-98; the reference's mmcv IterBasedRunner with its hooks,
mmedit/apis/train.py:75-239): a log line every ``log_interval`` iterations
(TextLoggerHook), a checkpoint every ``checkpoint_interval``
(CheckpointHook), an evaluation every ``eval_interval`` (DistEvalIterHook)
and a final checkpoint."""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

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
) -> TrainState:
    """Run iterations ``start_iter .. total_iters - 1``. ``eval_fn(model)``
    returns a metrics dict; ``ckpt_manager`` is a
    :class:`pnp_vcve_torch.core.checkpoint.CheckpointManager`."""
    it = iter(loader)
    losses = []
    t_last = time.perf_counter()
    for step in range(start_iter, total_iters):
        state, metrics = train_step(state, next(it))
        losses.append(metrics["loss"])

        if (step + 1) % log_interval == 0:
            loss = float(torch.stack(losses).mean())  # waits for the device
            losses.clear()
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            logger(f"iter {step + 1}/{total_iters} loss={loss:.5f} "
                   f"({log_interval / dt:.2f} it/s)")

        if ckpt_manager is not None and (step + 1) % checkpoint_interval == 0:
            ckpt_manager.save(step + 1, state_payload(state, save_optimizer))

        if eval_fn is not None and eval_interval and (step + 1) % eval_interval == 0:
            metrics = eval_fn(state.model)
            logger(f"iter {step + 1} eval: "
                   + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    if ckpt_manager is not None:
        ckpt_manager.save(total_iters, state_payload(state, save_optimizer))
    return state
