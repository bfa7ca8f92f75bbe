"""Haar wavelet transforms of the MW-GAN family, NHWC, plain PyTorch
(counterpart of pnp_vcve_tpu/ops/wavelet.py; reference wavelet_util.py:
20-52). The /2 scaling, the channel-block order (LL, HL, LH, HH) and the
sub-bands' signs are the reference's: a checkpoint's 1x1 convs read them."""

from __future__ import annotations

import torch

__all__ = ["dwt", "iwt"]


def dwt(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, h/2, w/2, 4c), channel blocks (LL, HL, LH, HH)."""
    x01 = x[:, 0::2] / 2
    x02 = x[:, 1::2] / 2
    x1 = x01[:, :, 0::2]
    x2 = x02[:, :, 0::2]
    x3 = x01[:, :, 1::2]
    x4 = x02[:, :, 1::2]
    ll = x1 + x2 + x3 + x4
    hl = -x1 - x2 + x3 + x4
    lh = -x1 + x2 - x3 + x4
    hh = x1 - x2 - x3 + x4
    return torch.cat([ll, hl, lh, hh], -1)


def iwt(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`dwt`: (b, h, w, 4c) -> (b, 2h, 2w, c)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x1, x2, x3, x4 = (x[..., i * c:(i + 1) * c] / 2 for i in range(4))
    e0 = x1 - x2 - x3 + x4  # rows 0::2, columns 0::2
    o0 = x1 - x2 + x3 - x4  # rows 1::2, columns 0::2
    e1 = x1 + x2 - x3 - x4  # rows 0::2, columns 1::2
    o1 = x1 + x2 + x3 + x4  # rows 1::2, columns 1::2
    rows_e = torch.stack([e0, e1], 3).reshape(b, h, 2 * w, c)
    rows_o = torch.stack([o0, o1], 3).reshape(b, h, 2 * w, c)
    return torch.stack([rows_e, rows_o], 2).reshape(b, 2 * h, 2 * w, c)
