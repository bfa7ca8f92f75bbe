"""The seven model kernels as registered operators, ``torch.ops.pnp_vcve.*``.

Each wrapper of :mod:`.warp`, :mod:`.drt_stack` and :mod:`.conv_block`
reaches its kernel through one ``torch.library.custom_op`` of the
``pnp_vcve`` namespace:

=================  ====  ===================================================
op                 name  CUDA implementation (the launch)
=================  ====  ===================================================
flow_warp          K1    ``warp._warp_kernel``
flow_warp_block    K1b   ``warp._warp_block_kernel``
input_conv         K2    ``drt_stack._input_conv_kernel``
drt_block          K3    ``drt_stack._drt_block_kernel``
drt_block_select   K3s   ``drt_stack._drt_block_select_kernel``
head               K4    ``drt_stack._head_kernel``
conv3x3            K5    ``conv_block._conv3x3_kernel``
=================  ====  ===================================================

Each op has

- a CUDA implementation: the launch, which repacks the weights, checks the
  arguments, launches the kernel and counts it in ``LAUNCHES``;
- a CPU implementation: the kernel's plain PyTorch version, its outputs
  made contiguous as the kernels write theirs. The dispatcher picks it by
  the tensors' device, as :func:`.launch.on_cpu` routes the wrappers; a
  CUDA tensor never reaches it;
- a fake implementation: the output's shape and type (contiguous), so that
  ``torch.export`` and ``FakeTensorMode`` trace through the op without
  reading data (the JAX package's ``jax.export`` carries its Pallas kernels
  as custom calls the same way, tools/export_model.py);
- a FLOP formula for ``torch.utils.flop_counter`` (:func:`flop_per_pixel`
  times the output's pixels).

The ops take the weights as the JAX package gives them (HWIO taps, the
partition kernel ``(c, 3, c)``); the repacking for the tensor cores
(``drt_stack.tc_weights``) stays inside the CUDA implementation, so the CPU
and CUDA graphs of one model hold the same ops with the same arguments.
The ops have no autograd formula: the wrappers run them directly where no
gradient is recorded and inside their ``torch.autograd.Function`` where one
is (see :func:`tracks_grad`). Importing :mod:`pnp_vcve_torch.kernels`
registers them, which ``torch.export.load`` of an exported model needs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

__all__ = ["NAMESPACE", "OPS", "register", "flop_per_pixel", "tracks_grad"]

NAMESPACE = "pnp_vcve"
OPS: dict = {}  # op name -> torch.ops.pnp_vcve.<name>


def flop_per_pixel(name: str, c: int, c_in: int | None = None, parts=()) -> int:
    """FLOP an output pixel of op ``name`` at width ``c`` (2 a multiply-add,
    the count of ``tools/torch_kernel_bounds.py: model_flop_per_pixel``):
    the warps 0 (no product); K2 a 3x3 conv over ``parts``, the channels of
    each input part; K3 and K3s two 3x3 convs and three 1x1 partition
    convs; K4 the c -> c -> 3 convs; K5 a 3x3 conv ``c_in`` -> ``c``."""
    if name == "input_conv":
        return 2 * 9 * sum(parts) * c
    if name in ("drt_block", "drt_block_select"):
        return 2 * (9 * c * c + 3 * c * c + 9 * c * c)
    if name == "head":
        return 2 * 9 * c * (c + 3)
    if name == "conv3x3":
        return 2 * 9 * c_in * c
    return 0


def tracks_grad(*tensors) -> bool:
    """True when autograd records a graph through these tensors: the wrapper
    then runs its ``autograd.Function`` (on CUDA) or the plain version under
    autograd (on the CPU) instead of the bare op."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def register(name: str, schema: str, kernel: Callable, plain: Callable, fake: Callable,
             per_pixel: Callable):
    """Define ``pnp_vcve::<name>`` with ``schema``: ``kernel`` on CUDA
    tensors, ``plain`` on CPU tensors, ``fake`` for tracing. The FLOP
    counter's formula is ``per_pixel`` (called with the arguments, tensors
    as their shapes) times the pixels ``b * h * w`` of the (first) output.
    Returns the op, ``torch.ops.pnp_vcve.<name>``."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", kernel, mutates_args=(),
                                 device_types="cuda", schema=schema)

    def cpu(*args):
        out = plain(*args)
        return tuple(o.contiguous() for o in out) if isinstance(out, tuple) else out.contiguous()

    op.register_kernel("cpu")(cpu)
    op.register_fake(fake)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)

    def flop(*shapes, out_shape=None, **kwargs):
        out = out_shape[0] if isinstance(out_shape[0], (tuple, list)) else out_shape
        return per_pixel(*shapes, **kwargs) * out[0] * out[1] * out[2]

    register_flop_formula(packet)(flop)
    OPS[name] = packet
    return packet
