"""The port's hand-written Hopper kernels (CUDA C++ under ``csrc/``), their
PyTorch wrappers and plain versions.

``KERNELS`` and ``PLAIN`` name the same seven operations: the wrappers (the
kernels on CUDA tensors, the plain versions on CPU tensors) and the plain
PyTorch versions alone. Models run ``KERNELS``; a comparison on the card
runs a model once more with ``PLAIN``.

=================  ====  ==================================================
operation          name  kernel
=================  ====  ==================================================
flow_warp          K1    ``csrc/warp.cu``, per-pixel flow
flow_warp_block    K1b   ``csrc/warp_block.cu``, one flow per 8x8 block
input_conv         K2    ``csrc/input_conv.cu``
drt_block          K3    ``csrc/drt_block.cu``
drt_block_select   K3s   ``csrc/drt_block.cu``, K3 + keyframe-carry select
head               K4    ``csrc/head.cu``
conv3x3            K5    ``csrc/conv3x3.cu``, per-sample 3x3 conv + bias
=================  ====  ==================================================

The probe kernels K6-K10 (the TPU micro-benchmarks of ``tools/``), which no
model runs, live in :mod:`.probes`.
"""

from types import SimpleNamespace

from .conv_block import conv3x3, conv3x3_plain
from .drt_stack import (
    drt_block,
    drt_block_plain,
    drt_block_select,
    drt_block_select_plain,
    head,
    head_plain,
    input_conv,
    input_conv_plain,
)
from .launch import LAUNCHES, reset_launches
from .warp import flow_warp, flow_warp_block, flow_warp_block_plain, flow_warp_plain

__all__ = ["KERNELS", "PLAIN", "LAUNCHES", "reset_launches"]

KERNELS = SimpleNamespace(
    flow_warp=flow_warp, flow_warp_block=flow_warp_block, input_conv=input_conv,
    drt_block=drt_block, drt_block_select=drt_block_select, head=head, conv3x3=conv3x3,
)
PLAIN = SimpleNamespace(
    flow_warp=flow_warp_plain,
    flow_warp_block=flow_warp_block_plain,
    input_conv=input_conv_plain,
    drt_block=drt_block_plain,
    drt_block_select=drt_block_select_plain,
    head=head_plain,
    conv3x3=conv3x3_plain,
)
