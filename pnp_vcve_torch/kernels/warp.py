"""K1: the MV warp of the sweeps' 64-channel carry (csrc/warp.cu).

Replaces ``pnp_vcve_tpu/kernels/warp_pf.py: warp_pf`` (:488). Unlike it the
flow is read per pixel and is not clamped to +-16 px: the kernel equals
``grid_sample(align_corners=True, padding_mode='zeros')`` for any flow, and
so the JAX ``block8`` warp on block-constant flows. It is bound by device
memory (one read of the taps, one write); the source note in ``warp.cu``
says how its threads map onto the channels.

In training, :class:`WarpFunction` carries the launch: the gradient for the
warped feature is the plain version's, and the flow gets none (it is data:
motion vectors from the bitstream).
"""

from __future__ import annotations

import torch

from pnp_vcve_torch.ops.warp import flow_warp as _flow_warp
from .launch import check_cuda_args, launch, on_cpu, plain_grads

__all__ = ["flow_warp", "flow_warp_plain", "WarpFunction"]


def flow_warp_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the per-pixel ('padgather') warp."""
    return _flow_warp(x, flow, impl="padgather")


def _launch(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    if c != 64 or flow.shape != (b, h, w, 2):
        raise ValueError(f"warp: need x (b,h,w,64), flow (b,h,w,2); got "
                         f"{tuple(x.shape)}, {tuple(flow.shape)}")
    check_cuda_args("warp", (x, flow))
    out = torch.empty_like(x)
    return launch("warp", "pnp_warp", out, x, flow, out, b, h, w)


class WarpFunction(torch.autograd.Function):
    """``run(x, flow)`` (the launch) forward; the plain version's gradient
    for ``x``, none for ``flow``."""

    @staticmethod
    def forward(ctx, run, x, flow):
        ctx.save_for_backward(x, flow)
        return run(x, flow)

    @staticmethod
    def backward(ctx, grad):
        gx, _ = plain_grads(flow_warp_plain, ctx.saved_tensors,
                            (ctx.needs_input_grad[1], False), grad)
        return None, gx, None


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``x (b, h, w, 64)`` by ``flow (b, h, w, 2)`` of the same type."""
    if on_cpu(x):
        return flow_warp_plain(x, flow)
    return WarpFunction.apply(_launch, x, flow)
