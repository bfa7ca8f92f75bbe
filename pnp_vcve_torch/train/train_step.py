"""The train and eval steps (counterpart of pnp_vcve_tpu/train/train_step.py:
``_model_inputs`` :34-42, ``make_train_step`` :45-86, ``make_eval_step``
:89-106), on one device.

A train step is the forward, the loss, ``backward()``, the optimizer's
update and one step of the schedule. ``fix_iter`` with ``freeze_prefixes``
(reference basicvsr.py:95-103) zeroes the gradients of the top-level
submodules whose names start with a prefix while ``step < fix_iter``, as JAX
does (:72-81). The gradients are zeroed, not dropped: ``torch.optim.Adam``
skips a parameter whose ``grad`` is ``None``, and its own step count would
then fall behind optax's global count once the freeze ends. For the same
reason a parameter that the loss does not reach gets a zero gradient.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .losses import charbonnier_loss
from .state import TrainState

__all__ = ["MODEL_INPUT_KEYS", "make_train_step", "make_eval_step"]

MODEL_INPUT_KEYS = ("lq", "qps", "slices", "mvs", "base_qps", "partitions")


def _model_inputs(batch):
    return dict(
        lrs=batch["lq"],
        qps=batch["qps"],
        slices=batch["slices"],
        mvs=batch["mvs"],
        base_qps=batch["base_qps"],
        par_map=batch["partitions"],
    )


def make_train_step(model: torch.nn.Module, loss_fn: Callable = charbonnier_loss,
                    fix_iter: int = 0, freeze_prefixes: Sequence[str] = ()):
    """``train_step(state, batch) -> (state, {"loss": loss})``: one update of
    ``state`` in place; ``batch`` holds tensors on the model's device."""
    if getattr(model, "warp_impl", None) in ("block8", "pf"):
        raise ValueError(
            f"warp_impl={model.warp_impl!r} is a serving-only optimization "
            "(exact only on uncropped rasterized MV maps; 'pf' additionally "
            "has no VJP through the warp kernel); train with 'padgather'"
        )
    params = list(model.parameters())
    frozen = [
        p for name, p in model.named_parameters()
        if fix_iter and name.split(".")[0].startswith(tuple(freeze_prefixes))
    ]

    def train_step(state: TrainState, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(**_model_inputs(batch)), batch["gt"])
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if state.step < fix_iter:
            for p in frozen:
                p.grad.zero_()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step(model: torch.nn.Module):
    """``eval_step(batch, is_mirror_extended=False) -> (b, t, h, w, 3)`` float32
    numpy: the batch's numpy arrays go to the model's device, the forward
    runs under ``torch.inference_mode()``."""
    device = next(model.parameters()).device

    def eval_step(batch, is_mirror_extended: bool = False) -> np.ndarray:
        inputs = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in _model_inputs(batch).items()
        }
        with torch.inference_mode():
            out = model(**inputs, is_mirror_extended=is_mirror_extended)
        return out.cpu().numpy()

    return eval_step
