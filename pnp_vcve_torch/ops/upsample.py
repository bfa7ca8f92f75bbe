"""Upsampling ops of the vsr head, plain PyTorch (counterpart of
pnp_vcve_tpu/ops/upsample.py).

- :func:`pixel_shuffle`: NHWC depth-to-space with torch ``nn.PixelShuffle``'s
  channel order (the reference's ``PixelShufflePack``);
- :func:`bilinear_resize`: half-pixel-center bilinear upsample, torch
  ``interpolate(mode='bilinear', align_corners=False)`` (the reference's
  ``img_upsample`` of the vsr branch).

The JAX package computes both in XLA, outside any Pallas kernel; they have
no kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pixel_shuffle", "bilinear_resize"]


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``(n, h, w, c * r * r) -> (n, h * r, w * r, c)``: input channel
    ``c * r * r + i * r + j`` goes to output position ``(h * r + i, w * r + j)``."""
    n, h, w, c = x.shape
    r = scale
    cout = c // (r * r)
    y = x.reshape(n, h, w, cout, r, r).permute(0, 1, 4, 2, 5, 3)  # n, h, r, w, r, c
    return y.reshape(n, h * r, w * r, cout)


def bilinear_resize(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` upsample of ``x (n, h, w, c)``, half-pixel centers,
    no antialiasing."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale, mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
