"""Modulated deformable convolution (DCNv2), plain PyTorch (counterpart of
pnp_vcve_tpu/ops/deform_conv.py).

The reference links mmcv's CUDA ``modulated_deform_conv2d`` for its
deformable aligners; the JAX package decomposes it in XLA, outside any
Pallas kernel, and so does the port: for each of the kernel's taps, a
bilinear zero-padded sample of each input channel group at ``base + tap +
offset`` (the warp's gather, ``ops/warp.py: _bilinear``), times the
modulation mask, then a ``(cin x cout)`` product accumulated in float32.
The bias is added at the end and the result cast to the input's type.

Layouts (NHWC, the JAX package's):
  x:       (b, h, w, cin)
  offsets: (b, h, w, groups, kh*kw, 2)  last dim (dy, dx) in pixels
  mask:    (b, h, w, groups, kh*kw)     already through the sigmoid
  kernel:  (kh, kw, cin, cout)          HWIO
Groups split the *input* channels (mmcv's deform_groups). 'same' padding,
stride 1, dilation 1, as at every reference call site.
"""

from __future__ import annotations

import torch

from .warp import _bilinear, _grid

__all__ = ["modulated_deform_conv2d"]


def modulated_deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, mask: torch.Tensor,
                            kernel: torch.Tensor, bias: torch.Tensor | None = None):
    b, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    groups = offsets.shape[3]
    if cin % groups:
        raise ValueError(f"cin={cin} not divisible by groups={groups}")
    ph, pw = kh // 2, kw // 2
    row, col = (a[..., None] for a in _grid(h, w, x.device))  # (1, h, 1, 1), (1, 1, w, 1)
    out = torch.zeros((b, h, w, cout), dtype=torch.float32, device=x.device)
    for k in range(kh * kw):
        ky, kx = divmod(k, kw)
        d = offsets[:, :, :, :, k, :].float()  # (b, h, w, groups, 2) = (dy, dx)
        # the tap's pixel flow first, then the base grid, as JAX adds them
        px = col + (d[..., 1] + (kx - pw))
        py = row + (d[..., 0] + (ky - ph))
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        sampled = _bilinear(x, x0, y0, px - x0, py - y0).reshape(b, h, w, groups, -1)
        sampled = (sampled * mask[..., k, None].to(x.dtype)).reshape(b, h, w, cin)
        out = out + torch.einsum("bhwi,io->bhwo", sampled.float(), kernel[ky, kx].float())
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
