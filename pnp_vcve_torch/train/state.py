"""The train state and its checkpoint payload (counterparts of
pnp_vcve_tpu/train/state.py and ``state_payload`` in train/loop.py:24-36)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["TrainState", "state_payload"]


@dataclass
class TrainState:
    """``step`` counts the updates applied; the model, the optimizer and
    the schedule are updated in place by the train step."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def state_payload(state: TrainState, save_optimizer: bool = True) -> dict:
    """Checkpoint payload ``{step, model[, optimizer, scheduler]}``: with the
    optimizer, a resumed run continues the Adam moments and the schedule's
    position exactly (reference CheckpointHook with save_optimizer,
    configs/HR_davis_LR_128x128.py:226); without it, weights only."""
    payload = {"step": state.step, "model": state.model.state_dict()}
    if save_optimizer:
        payload["optimizer"] = state.optimizer.state_dict()
        payload["scheduler"] = state.scheduler.state_dict()
    return payload
