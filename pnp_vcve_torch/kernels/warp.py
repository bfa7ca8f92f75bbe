"""K1 and K1b: the MV warps of the sweeps' c-channel carry (csrc/warp.cu,
csrc/warp_block.cu), for any width c that is a multiple of 8 (the
flagship's 64 on a path of its own; K1b up to 712 channels, its 9 x 9
window's shared memory).

K1 replaces ``pnp_vcve_tpu/kernels/warp_pf.py: warp_pf`` (:488) where the
port trains and evaluates with ``padgather`` (and in the basic DCN
aligner's pre-warp): the flow is read per pixel and not clamped, so the
kernel equals ``grid_sample(align_corners=True, padding_mode='zeros')`` for
any flow. Nearest interpolation and border padding have no kernel: they
run ``ops.warp.flow_warp`` in plain PyTorch, as JAX runs them in XLA. In training, :class:`WarpFunction`
carries the launch: the gradient for the warped feature is the plain
version's, and the flow gets none (it is data: motion vectors from the
bitstream).

K1b replaces ``warp_pf_compact`` (:552), the serving warp of ``'pf'`` and
``'block8'``: it reads one flow per 8x8 block, at the block's top-left
pixel, from a ``(b, h/8, w/8, 2)`` float32 table that the wrapper cuts from
the flow field (clamped to +-``max_mv``, 16 px for ``'pf'``). JAX's
``warp_pf`` has no VJP and its train step refuses the serving warps, so K1b
has no Function: its wrapper refuses an input that requires a gradient.

Both are bound by device memory (one read of the taps, one write); the
source notes say how the threads map onto the channels. :func:`warp_args`
and :func:`warp_block_args` hold the checks a launch makes of the shapes and
the width; they run on any device. Each kernel is a registered op
(``torch.ops.pnp_vcve.flow_warp``, ``flow_warp_block``; :mod:`.ops_registry`)
whose CUDA implementation is the launch and whose CPU implementation is the
plain version.
"""

from __future__ import annotations

import torch

from pnp_vcve_torch.ops.warp import block_flow, flow_warp as _flow_warp, warp_blocks
from .launch import check_cuda_args, check_width, launch, on_cpu, plain_grads
from .ops_registry import flop_per_pixel, register, tracks_grad

__all__ = [
    "flow_warp", "flow_warp_plain", "WarpFunction", "flow_warp_block", "flow_warp_block_plain",
    "warp_args", "warp_block_args",
]


def flow_warp_plain(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the per-pixel ('padgather') warp."""
    return _flow_warp(x, flow, impl="padgather")


def warp_args(x: torch.Tensor, flow: torch.Tensor) -> int:
    """K1's shape and width checks; returns the width."""
    b, h, w, c = x.shape
    if flow.shape != (b, h, w, 2):
        raise ValueError(f"warp: need x (b,h,w,c), flow (b,h,w,2); got "
                         f"{tuple(x.shape)}, {tuple(flow.shape)}")
    check_width("warp", c)
    return c


def _warp_kernel(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: K1's launch."""
    c = warp_args(x, flow)
    check_cuda_args("warp", (x, flow))
    out = torch.empty_like(x)
    return launch("warp", "pnp_warp", out, x, flow, out, *x.shape[:3], c)


_flow_warp_op = register(
    "flow_warp", "(Tensor x, Tensor flow) -> Tensor", _warp_kernel, flow_warp_plain,
    lambda x, flow: x.new_empty(x.shape), lambda x, flow: flop_per_pixel("flow_warp", x[-1]),
)


def _launch(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The op, ``torch.ops.pnp_vcve.flow_warp``: K1 on CUDA tensors."""
    return _flow_warp_op(x, flow)


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
    """K1. Warp ``x (b, h, w, c)`` by ``flow (b, h, w, 2)`` of the same type."""
    cpu = on_cpu(x)
    if not tracks_grad(x, flow):
        return _launch(x, flow)
    if cpu:
        return flow_warp_plain(x, flow)
    return WarpFunction.apply(_launch, x, flow)


def flow_warp_block_plain(x: torch.Tensor, flow: torch.Tensor,
                          max_mv: float | None = None) -> torch.Tensor:
    """The plain PyTorch version of K1b: the block warp of ``ops.warp`` on
    the same table."""
    return warp_blocks(x, block_flow(flow, max_mv))


def warp_block_args(x: torch.Tensor, flow: torch.Tensor) -> int:
    """K1b's shape and width checks; returns the width."""
    b, h, w, c = x.shape
    if h % 8 or w % 8 or flow.shape != (b, h, w, 2):
        raise ValueError(f"warp_block: need x (b,h,w,c) with h, w multiples of 8 and flow "
                         f"(b,h,w,2); got {tuple(x.shape)}, {tuple(flow.shape)}")
    check_width("warp_block", c)
    return c


def _warp_block_kernel(x: torch.Tensor, flow: torch.Tensor,
                       max_mv: float | None) -> torch.Tensor:
    """The op's CUDA implementation: the block table, then K1b's launch."""
    c = warp_block_args(x, flow)
    fb = block_flow(flow, max_mv)
    check_cuda_args("warp_block", (x,), (fb,))
    out = torch.empty_like(x)
    return launch("warp_block", "pnp_warp_block", out, x, fb, out, *x.shape[:3], c)


_flow_warp_block_op = register(
    "flow_warp_block", "(Tensor x, Tensor flow, float? max_mv) -> Tensor", _warp_block_kernel,
    flow_warp_block_plain, lambda x, flow, max_mv: x.new_empty(x.shape),
    lambda x, flow, max_mv: flop_per_pixel("flow_warp_block", x[-1]),
)


def _block_launch(x: torch.Tensor, flow: torch.Tensor, max_mv: float | None) -> torch.Tensor:
    """The op, ``torch.ops.pnp_vcve.flow_warp_block``: K1b on CUDA tensors."""
    return _flow_warp_block_op(x, flow, max_mv)


def flow_warp_block(x: torch.Tensor, flow: torch.Tensor,
                    max_mv: float | None = None) -> torch.Tensor:
    """K1b. Warp ``x (b, h, w, c)``, h and w multiples of 8, by the flow of
    ``flow (b, h, w, 2)`` at each 8x8 block's top-left pixel, clamped to
    +-``max_mv`` in float32. Inference only."""
    if x.requires_grad:
        raise RuntimeError(
            "flow_warp_block has no gradient (the JAX package's warp_pf has no VJP): "
            "the serving warps 'pf' and 'block8' run under torch.inference_mode() or "
            "torch.no_grad(); train with warp_impl='padgather'"
        )
    on_cpu(x)  # refuses a device with no kernel
    return _block_launch(x, flow, max_mv)
