"""The cosine-restart learning-rate schedule (counterpart of
pnp_vcve_tpu/train/schedule.py: ``cosine_restart_schedule`` :19-35, mmcv's
CosineRestartLrUpdaterHook as the flagship config sets it: periods
[300000], restart_weights [1], min_lr 1e-7).

Within period i, starting at step s_i with peak ``base_lr * w_i``:
``lr = min_lr + (peak - min_lr) * 0.5 * (1 + cos(pi * min(step - s_i, p_i) / p_i))``,
which is optax's ``join_schedules`` of ``cosine_decay_schedule(peak, p_i,
alpha=min_lr / peak)``. Optax applies ``schedule(count)`` before it counts the
update, so update k (from 0) uses ``lr(k)``; ``torch.optim.lr_scheduler.
LambdaLR`` stepped once after each update gives the same.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Sequence

__all__ = ["cosine_restart_schedule"]


def cosine_restart_schedule(base_lr: float, periods: Sequence[int],
                            restart_weights: Sequence[float] = (1.0,),
                            min_lr: float = 0.0) -> Callable[[int], float]:
    """``step -> lr``."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights length mismatch")
    starts = [0, *itertools.accumulate(periods)][:-1]

    def schedule(step: int) -> float:
        i = max(j for j, s in enumerate(starts) if step >= s)
        peak = base_lr * restart_weights[i]
        frac = min(step - starts[i], periods[i]) / periods[i]
        return min_lr + (peak - min_lr) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule
