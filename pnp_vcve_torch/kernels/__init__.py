"""The port's hand-written Hopper kernels (CUDA C++ under ``csrc/``), their
PyTorch wrappers and plain versions.

``KERNELS`` and ``PLAIN`` name the same four operations: the wrappers (the
kernels on CUDA tensors, the plain versions on CPU tensors) and the plain
PyTorch versions alone. Models run ``KERNELS``; a comparison on the card
runs a model once more with ``PLAIN``.
"""

from types import SimpleNamespace

from .drt_stack import (
    drt_block,
    drt_block_plain,
    head,
    head_plain,
    input_conv,
    input_conv_plain,
)
from .launch import LAUNCHES, reset_launches
from .warp import flow_warp, flow_warp_plain

__all__ = ["KERNELS", "PLAIN", "LAUNCHES", "reset_launches"]

KERNELS = SimpleNamespace(
    flow_warp=flow_warp, input_conv=input_conv, drt_block=drt_block, head=head
)
PLAIN = SimpleNamespace(
    flow_warp=flow_warp_plain,
    input_conv=input_conv_plain,
    drt_block=drt_block_plain,
    head=head_plain,
)
