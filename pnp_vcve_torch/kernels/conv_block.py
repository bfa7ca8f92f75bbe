"""K5: a 'same' 3x3 convolution with per-sample kernels, biases and gains
(csrc/conv3x3.cu), named after the JAX module whose first function it ports.

One port function serves three TPU functions that compute the same math in
three layouts:

- ``pnp_vcve_tpu/kernels/conv_block.py: conv3x3_pallas`` (:86), row bands
  of the NHWC map;
- ``pnp_vcve_tpu/kernels/conv_packed.py: conv3x3_packed`` (:48) and
  ``conv3x3_packed_v2`` (:118), the pixel-pair packed layout (even w).

The TPU layouts and their ``th`` row bands are not carried over: K5 takes
the NHWC tensor as it is, for any h, w and c_in and any c_out that is a
multiple of 8. ``drt_block_pallas`` (:180), the module's second function,
is K3's function: :func:`pnp_vcve_torch.kernels.drt_stack.drt_block` takes
its arguments reordered, ``(x, par, dyn_kernels, dyn_biases, gamma,
par_kernel, conv1_kernel, conv1_bias)``.

K5 runs on the tensor cores: bfloat16 features with the per-sample kernels
rounded to bfloat16, as the plain version rounds them, float32 features in
3xTF32 (:func:`.drt_stack.tf32_split`). At 64 -> 64, the width of every
model path (the unfused DRT block forms' two convs), it runs a wgmma design
(``csrc/conv3x3.cu: conv3x3_wg``: persistent blocks over ``K5_TILE[dtype]``
output tiles, :func:`.drt_stack.wg_tile_walk`), whose per-sample weights
the wrapper packs into the shared-memory images its bulk copies move
(:func:`.drt_stack.wg_image`); at any other pair of widths K2's
``mma.sync`` GEMM loop (``csrc/tc_conv.cuh``); ``launch.kernel_design``
says which. The gain applies after the bias, in the
kernel's float32 epilogue (``gamma * (conv + b)``, as
``dynamic_conv2d(..., gamma=)``, pnp_vcve_tpu/ops/dynamic_conv.py:57-119),
not folded into the weights; so K5 also serves the DRT blocks'
expert-mixed convs with the SE gain. :func:`conv3x3_args` holds the checks
a launch makes and the weight repacking, :func:`conv3x3_operands` the
operands the launch hands the kernel; both run on any device. On CUDA
tensors each launch runs inside :class:`Conv3x3Function`, whose gradients
are the plain version's (``launch.plain_grads``), where a gradient is
recorded. The launch is the CUDA implementation of the registered op
``torch.ops.pnp_vcve.conv3x3`` (:mod:`.ops_registry`), whose CPU
implementation is the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pnp_vcve_torch.ops.dynamic_conv import dynamic_conv2d
from .drt_stack import K5_TILE, tc_weights, wg_image
from .launch import check_cuda_args, kernel_design, launch, on_cpu, plain_grads
from .ops_registry import flop_per_pixel, register, tracks_grad

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_args", "conv3x3_operands", "Conv3x3Function",
           "K5_TILE"]


def conv3x3_plain(x, kernels, biases=None, gamma=None):
    """``gamma * (conv3x3(x[b]; kernels[b]) + biases[b])`` in x's type:
    ``x (b, h, w, c_in)``, ``kernels (b, 3, 3, c_in, c_out)``, ``biases`` and
    ``gamma`` ``(b, c_out)`` or None."""
    return dynamic_conv2d(x, kernels, biases, gamma=gamma)


def conv3x3_args(x, kernels, biases, gamma):
    """K5's shape checks and its operands as the kernel takes them:
    ``(wk (NW, b, 9, c_out, wc), biases (b, c_out), gamma (b, c_out))``,
    the taps as :func:`.drt_stack.tc_weights` in x's type with each row
    zero-padded from c_in to ``wc``, c_in rounded up to a multiple of 8 (whole
    16-byte vectors), the bias and the gain float32, unscaled."""
    b, h, w, c_in = x.shape
    c_out = kernels.shape[-1]
    if kernels.shape != (b, 3, 3, c_in, c_out) or c_out % 8:
        raise ValueError(f"conv3x3: need kernels (b,3,3,c_in,c_out) with c_out % 8 == 0 for x "
                         f"{tuple(x.shape)}; got {tuple(kernels.shape)}")
    if biases.shape != (b, c_out) or gamma.shape != (b, c_out):
        raise ValueError(f"conv3x3: need biases and gamma ({b}, {c_out}); got "
                         f"{tuple(biases.shape)}, {tuple(gamma.shape)}")
    taps = F.pad(kernels.float().reshape(b, 9, c_in, c_out), (0, 0, 0, -c_in % 8))
    return tc_weights(taps, x.dtype), biases.float().contiguous(), gamma.float().contiguous()


def conv3x3_operands(x, kernels, biases, gamma):
    """What K5's launch hands its kernel: :func:`conv3x3_args`' operands, the
    taps at 64 -> 64 as the wgmma design's images (:func:`.drt_stack.wg_image`,
    ``(b, 9, KB, NW, 64, 128 bytes)``), at any other pair as they are."""
    wk, bias, gain = conv3x3_args(x, kernels, biases, gamma)
    if kernel_design("conv3x3", kernels.shape[-1], x.dtype, c_in=x.shape[-1])[0] == "wgmma":
        wk = wg_image(wk)
    return wk, bias, gain


def _conv3x3_kernel(x, kernels, biases, gamma):
    """The op's CUDA implementation: no bias reads as zeros and no gain as
    ones; the taps repacked, K5's launch."""
    b, c_out = x.shape[0], kernels.shape[-1]
    if biases is None:
        biases = torch.zeros((b, c_out), device=x.device)
    if gamma is None:
        gamma = torch.ones((b, c_out), device=x.device)
    operands = conv3x3_operands(x, kernels, biases, gamma)
    check_cuda_args("conv3x3", (x,), operands)
    b, h, w, c_in = x.shape
    out = torch.empty((b, h, w, kernels.shape[-1]), dtype=x.dtype, device=x.device)
    return launch("conv3x3", "pnp_conv3x3", out, x, *operands, out, b, h, w, c_in,
                  out.shape[-1])


_conv3x3_op = register(
    "conv3x3", "(Tensor x, Tensor kernels, Tensor? biases, Tensor? gamma) -> Tensor",
    _conv3x3_kernel, conv3x3_plain,
    lambda x, kernels, biases, gamma: x.new_empty((*x.shape[:3], kernels.shape[-1])),
    lambda x, kernels, biases, gamma: flop_per_pixel("conv3x3", kernels[-1], c_in=x[-1]),
)


def _conv3x3_launch(x, kernels, biases, gamma):
    """The op, ``torch.ops.pnp_vcve.conv3x3``: K5 on CUDA tensors."""
    return _conv3x3_op(x, kernels, biases, gamma)


class Conv3x3Function(torch.autograd.Function):
    """``run(x, kernels, biases, gamma)`` forward; :func:`conv3x3_plain`'s
    gradients."""

    @staticmethod
    def forward(ctx, run, *args):
        ctx.save_for_backward(*args)
        return run(*args)

    @staticmethod
    def backward(ctx, grad):
        return None, *plain_grads(conv3x3_plain, ctx.saved_tensors,
                                  ctx.needs_input_grad[1:], grad)


def conv3x3(x, kernels, biases=None, gamma=None):
    """K5. ``x (b, h, w, c_in)`` float32 or bfloat16; per-sample
    ``kernels (b, 3, 3, c_in, c_out)`` (HWIO), ``biases (b, c_out)`` or None,
    gain ``gamma (b, c_out)`` or None. Returns ``(b, h, w, c_out)`` in x's
    type."""
    cpu = on_cpu(x)
    if not tracks_grad(x, kernels, biases, gamma):
        return _conv3x3_launch(x, kernels, biases, gamma)
    if cpu:
        return conv3x3_plain(x, kernels, biases, gamma)
    b, c_out = x.shape[0], kernels.shape[-1]
    if biases is None:
        biases = torch.zeros((b, c_out), device=x.device)
    if gamma is None:
        gamma = torch.ones((b, c_out), device=x.device)
    return Conv3x3Function.apply(_conv3x3_launch, x, kernels, biases, gamma)
