"""Per-sample mixture-of-experts convolution, plain PyTorch (counterpart of
pnp_vcve_tpu/ops/dynamic_conv.py).

The expert bank is mixed per sample with one einsum, then applied as one
grouped convolution with ``groups=batch``, as the original reference does
(mmedit sr_backbone_utils.py ``Dynamic_conv2d``). Tensors are NHWC and
kernels HWIO, the JAX package's layouts; sums are taken in float32 and the
result is cast back to the input's type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "mix_expert_kernels", "per_sample_conv", "dynamic_conv2d", "conv2d_f32", "conv2d_nhwc",
]


def mix_expert_kernels(weights, kernel_bank, bias_bank=None):
    """``weights (b, K)`` x ``kernel_bank (K, kh, kw, cin, cout)`` ->
    ``(kernels (b, kh, kw, cin, cout), biases (b, cout) or None)``."""
    mixed = torch.einsum("bk,khwio->bhwio", weights.float(), kernel_bank.float())
    mixed_bias = None
    if bias_bank is not None:
        mixed_bias = torch.einsum("bk,ko->bo", weights.float(), bias_bank.float())
        mixed_bias = mixed_bias.to(bias_bank.dtype)
    return mixed.to(kernel_bank.dtype), mixed_bias


def per_sample_conv(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """'same' conv of each sample of ``x (b, h, w, cin)`` with its own kernel
    ``kernels (b, kh, kw, cin, cout)``; operands in x's type, result float32
    ``(b, h, w, cout)``."""
    b, h, w, cin = x.shape
    kh, kw, cout = kernels.shape[1], kernels.shape[2], kernels.shape[4]
    xg = x.permute(0, 3, 1, 2).reshape(1, b * cin, h, w)
    wg = kernels.to(x.dtype).permute(0, 4, 3, 1, 2).reshape(b * cout, cin, kh, kw)
    y = F.conv2d(xg, wg, padding=(kh // 2, kw // 2), groups=b)
    return y.reshape(b, cout, h, w).permute(0, 2, 3, 1).float()


def dynamic_conv2d(x, kernels, biases=None, gamma=None):
    """Per-sample conv; ``gamma (b, cout)`` scales (conv + bias), the with_se
    gain of the reference ``Dynamic_conv2d_se``."""
    out = per_sample_conv(x, kernels)
    if biases is not None:
        out = out + biases[:, None, None, :].float()
    if gamma is not None:
        out = out * gamma[:, None, None, :].float()
    return out.to(x.dtype)


def conv2d_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Shared-weight 'same' conv, ``kernel (kh, kw, cin, cout)``; operands in
    x's type, result float32 NHWC."""
    kh, kw = kernel.shape[:2]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), kernel.to(x.dtype).permute(3, 2, 0, 1),
        padding=(kh // 2, kw // 2),
    )
    return y.permute(0, 2, 3, 1).float()


def conv2d_nhwc(x, kernel, bias=None):
    """Shared-weight 'same' conv, NHWC / HWIO, stride 1."""
    out = conv2d_f32(x, kernel)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
