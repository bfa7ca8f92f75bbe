"""The train and eval steps (counterpart of pnp_vcve_tpu/train/train_step.py:
``_model_inputs`` :34-42, ``make_train_step`` :45-86, ``make_eval_step``
:89-106), on one device or data-parallel over the ranks of a process group.

A train step is the forward, the loss, ``backward()``, the optimizer's
update and one step of the schedule. ``fix_iter`` with ``freeze_prefixes``
(reference basicvsr.py:95-103) zeroes the gradients of the top-level
submodules whose names start with a prefix while ``step < fix_iter``, as JAX
does (:72-81). The gradients are zeroed, not dropped: ``torch.optim.Adam``
skips a parameter whose ``grad`` is ``None``, and its own step count would
then fall behind optax's global count once the freeze ends. For the same
reason a parameter that the loss does not reach gets a zero gradient.

With ``world > 1`` each rank computes the loss of its rows of the global
batch, and after the zero fill and the freeze the gradients and the loss
are averaged over the ranks in one ``all_reduce`` of a flat float32 buffer,
as XLA's psum over ``dp`` averages them (tools/train.py's mesh). Every rank
then applies the same update to the same weights (:func:`broadcast_module`
makes them equal at the start). The reduction runs after the whole
backward, not bucket by bucket inside it as ``DistributedDataParallel``
would: the zero fill must come first, the remat recompute and the
parameters that 'drt_woqp' never reaches need no special case, and the sum
has one fixed order. The process group picks the transport (NCCL for
device tensors where every rank has a card, else gloo, which stages device
tensors through the host itself).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from .losses import charbonnier_loss
from .state import TrainState

__all__ = ["MODEL_INPUT_KEYS", "make_train_step", "make_eval_step", "broadcast_module"]

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


def broadcast_module(module: torch.nn.Module):
    """Give every rank rank 0's parameters and buffers (one broadcast)."""
    import torch.distributed as dist

    tensors = [t.data for t in (*module.parameters(), *module.buffers())]
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.broadcast(flat, 0)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def make_train_step(model: torch.nn.Module, loss_fn: Callable = charbonnier_loss,
                    fix_iter: int = 0, freeze_prefixes: Sequence[str] = (), world: int = 1,
                    time_reduce: bool = False):
    """``train_step(state, batch) -> (state, {"loss": loss})``: one update of
    ``state`` in place; ``batch`` holds tensors on the model's device. With
    ``world > 1`` (the default process group's size) the loss and the
    gradients are the ranks' means. ``time_reduce`` (for profiling; it
    synchronises the device twice a step) adds ``allreduce_s`` to the
    metrics: the wall time from the end of the backward to the averaged
    gradients."""
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
        metrics = {"loss": loss.detach()}
        if world > 1:
            metrics = _average_over_ranks(params, metrics["loss"], world, time_reduce)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return train_step


def _average_over_ranks(params, loss: torch.Tensor, world: int, timed: bool) -> dict:
    """Average the gradients and the loss over the ranks in place: one
    ``all_reduce`` (sum) of ``[grads..., loss]``, then a division by the
    world size. The loss comes back as a tensor of its own: a view would
    keep the whole flat buffer alive while the loop holds the loss until
    its next log line."""
    import torch.distributed as dist

    sync = torch.cuda.synchronize if timed and loss.is_cuda else lambda: None
    sync()
    t0 = time.perf_counter()
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).float()])
    dist.all_reduce(flat)
    flat.div_(world)
    for g, v in zip(grads, flat.split([g.numel() for g in grads] + [1])):
        g.copy_(v.view_as(g))
    metrics = {"loss": flat[-1].clone()}
    if timed:
        sync()
        metrics["allreduce_s"] = time.perf_counter() - t0
    return metrics


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
