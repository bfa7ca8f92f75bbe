"""Shared-weight convolutions of the baseline models, NHWC, plain PyTorch
(the JAX package's ``flax.linen.Conv`` with ``padding='SAME'``, computed in
XLA there and by cuDNN here).

``'SAME'`` pads as XLA does: ``out = ceil(in / stride)``, the total padding
``(out - 1) * stride + k - in`` split with the odd pixel at the bottom and
right. At stride 1 that is the reference's symmetric ``k // 2``; at stride 2
on an even side it is 0 above and 1 below, where the reference's
``Conv2d(..., 3, 2, 1)`` pads 1 on both sides (ROADMAP Queue C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["conv_same"]


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """``conv`` (its OIHW weight and bias) over ``x (n, h, w, c)`` with XLA's
    'SAME' padding at ``stride``; NHWC out."""
    kh, kw = conv.weight.shape[2:]
    (t, b), (l, r) = _same(x.shape[1], kh, stride), _same(x.shape[2], kw, stride)
    y = x.permute(0, 3, 1, 2)
    if (t, l) == (b, r):
        y = F.conv2d(y, conv.weight, conv.bias, stride, (t, l))
    else:
        y = F.conv2d(F.pad(y, (l, r, t, b)), conv.weight, conv.bias, stride)
    return y.permute(0, 2, 3, 1)
