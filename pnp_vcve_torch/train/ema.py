"""Exponential moving average of the weights (counterpart of
pnp_vcve_tpu/train/ema.py and pnp_vcve_tpu/utils/ema.py; reference
mmedit/core/hooks/ema.py:12-113, ``ExponentialMovingAverageHook``).

The average is a dict of tensors keyed like a state dict, made from a
module's parameters or from a state dict. One tick (reference
``after_train_iter``): before ``start_iter`` it copies the live weights;
from there, on every ``interval``-th iteration counted from
``start_iter``, ``ema = lerp(param, ema, momentum) = param + (ema - param)
* momentum`` (the reference's argument order: the new weight's share is
``1 - momentum``); other iterations leave it as it is. No config of the
flagship enables it.

utils/ema.py's tracker is the same hook counted from 1: its
``update(s, params)`` with ``s % interval == 0`` is :func:`ema_update` at
``step = s - 1`` with ``start_iter=0``, its ``momentum * ema + (1 -
momentum) * param`` the same average up to the last bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

__all__ = ["EmaState", "ema_init", "ema_update"]

Weights = Union[nn.Module, Mapping[str, torch.Tensor]]


def _tensors(weights: Weights) -> Dict[str, torch.Tensor]:
    if isinstance(weights, nn.Module):
        return {k: p.detach() for k, p in weights.named_parameters()}
    return {k: torch.as_tensor(v) for k, v in weights.items()}


def ema_init(weights: Weights) -> Dict[str, torch.Tensor]:
    """The average, started as a copy of the live weights."""
    return {k: v.clone() for k, v in _tensors(weights).items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], weights: Weights, step: int,
               momentum: float = 0.999, interval: int = 1,
               start_iter: int = 0) -> Dict[str, torch.Tensor]:
    """One tick of the average at iteration ``step`` (0-based), in place;
    returns ``ema``."""
    live = _tensors(weights)
    warm = step < start_iter
    tick = interval > 0 and (step + 1 - start_iter) % interval == 0
    for k, e in ema.items():
        p = live[k]
        if warm:
            e.copy_(p)
        elif tick:
            e.copy_(p + (e - p) * torch.tensor(momentum, dtype=e.dtype))
    return ema


class EmaState:
    """``ema = EmaState(model); ema.update(model, step)``; read
    ``ema.params`` to evaluate or publish the average."""

    def __init__(self, weights: Weights, momentum: float = 0.999, interval: int = 1,
                 start_iter: int = 0):
        self.params = ema_init(weights)
        self.momentum = momentum
        self.interval = interval
        self.start_iter = start_iter

    def update(self, weights: Weights, step: int) -> Dict[str, torch.Tensor]:
        return ema_update(self.params, weights, step, self.momentum, self.interval,
                          self.start_iter)
