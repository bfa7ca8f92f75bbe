"""Pixel losses (counterpart of the pixel losses of
pnp_vcve_tpu/train/losses.py; reference mmedit/models/losses/
pixelwise_loss.py). The flagship config trains with Charbonnier (eps 1e-12,
mean reduction, weight 1). Sums are taken in float32."""

from __future__ import annotations

import torch

__all__ = ["charbonnier_loss", "l1_loss", "mse_loss", "LOSSES"]


def _diff(pred, target):
    return pred.float() - target.float()


def charbonnier_loss(pred, target, eps: float = 1e-12, weight: float = 1.0):
    """``mean(sqrt((pred - target)^2 + eps))`` (pixelwise_loss.py:40-51)."""
    d = _diff(pred, target)
    return weight * torch.sqrt(d * d + eps).mean()


def l1_loss(pred, target, weight: float = 1.0):
    return weight * _diff(pred, target).abs().mean()


def mse_loss(pred, target, weight: float = 1.0):
    d = _diff(pred, target)
    return weight * (d * d).mean()


# a config's ``pixel_loss.type`` -> the loss (pnp_vcve_tpu/models/restorer.py:53-57)
LOSSES = {"CharbonnierLoss": charbonnier_loss, "L1Loss": l1_loss, "MSELoss": mse_loss}
