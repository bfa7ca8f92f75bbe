"""Pixel-adaptive convolution (PAC), plain PyTorch (counterpart of
pnp_vcve_tpu/ops/pac.py; reference pac_util.py, MW-GAN's ``MWP_Align``).

    out(p) = sum_d K(g, p, d) * (W_d @ x(p + d)) + b
    K(g, p, d) = exp(-0.5 * ||g(p) - g(p + d)||^2)   (summed over the
                                                      guidance channels)

3x3, stride 1, zero padding, the only form MW-GAN uses. The nine taps are
zero-padded shifts of the NHWC maps; each tap's product ``(cin x cout)`` is
accumulated in float32, in the tap order of JAX. The JAX package computes
this in XLA, outside any Pallas kernel; it has no kernel here either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pac_conv2d", "gauss_kernel2d"]


def _shifts3(x: torch.Tensor) -> list[torch.Tensor]:
    """The 3x3 neighbourhood of every pixel as nine (b, h, w, c) views, row
    major, zero outside the image."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def gauss_kernel2d(guide: torch.Tensor) -> torch.Tensor:
    """(b, h, w, cg) -> (b, h, w, 9): exp(-0.5 ||g(p) - g(p + d)||^2) per tap."""
    taps = _shifts3(guide)
    center = taps[4]
    return torch.stack([torch.exp(-0.5 * ((t - center) ** 2).sum(-1)) for t in taps], -1)


def pac_conv2d(x: torch.Tensor, guide: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x (b, h, w, cin)``, ``guide (b, h, w, cg)``, ``kernel (3, 3, cin,
    cout)`` HWIO -> ``(b, h, w, cout)`` in x's type."""
    k = gauss_kernel2d(guide)
    out = None
    for i, t in enumerate(_shifts3(x)):
        dy, dx = divmod(i, 3)
        term = torch.einsum("bhwi,io->bhwo", (t * k[..., i:i + 1]).float(),
                            kernel[dy, dx].float())
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
