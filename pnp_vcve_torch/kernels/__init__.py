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
conv3x3            K5    ``csrc/conv3x3.cu``, per-sample 3x3 conv, bias, gain
=================  ====  ==================================================

Each kernel is also a registered op, ``torch.ops.pnp_vcve.<operation>``
(:mod:`.ops_registry`; ``OPS`` maps the names to them): the launch on CUDA
tensors, the plain version on CPU tensors, a fake implementation for
``torch.export`` and a FLOP formula. Importing this package registers
them, which loading an exported model needs.

K2-K5 run on the tensor cores: K2-K4 at 64 channels on ``wgmma``
(``csrc/wg_conv.cuh``, ``csrc/drt_block.cu``), at any other width, and K5,
on ``mma.sync`` (``csrc/tc_conv.cuh``); K1 and K1b on the CUDA cores. K1-K4 take any width that is a multiple of 8
(:func:`.launch.check_width` says which they refuse), K5 any c_in. The
probe kernels K6-K13 (the TPU micro-benchmarks of ``tools/``), which no
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
from .ops_registry import OPS
from .warp import flow_warp, flow_warp_block, flow_warp_block_plain, flow_warp_plain

__all__ = ["KERNELS", "PLAIN", "OPS", "LAUNCHES", "reset_launches"]

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
