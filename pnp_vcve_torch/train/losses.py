"""Losses (counterpart of pnp_vcve_tpu/train/losses.py:1-102; reference
mmedit/models/losses/): the pixel losses (the flagship config trains with
Charbonnier, eps 1e-12, mean reduction, weight 1), the adversarial loss
(``lsgan``, ``vanilla``), the discriminator feature-matching term and the
VGG perceptual and style loss. Sums are taken in float32."""

from __future__ import annotations

import torch

__all__ = ["charbonnier_loss", "l1_loss", "mse_loss", "LOSSES", "gan_loss",
           "feature_matching_loss", "make_perceptual_loss"]


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


def gan_loss(pred, target_is_real: bool, gan_type: str = "lsgan", weight: float = 1.0):
    """The adversarial loss of ``pred`` against a real (1) or fake (0)
    target: ``lsgan`` the mean squared error, ``vanilla`` the binary cross
    entropy on logits, ``max(p, 0) - p * t + log1p(exp(-|p|))`` (reference
    gan_loss.py)."""
    pred = pred.float()
    target = 1.0 if target_is_real else 0.0
    if gan_type == "lsgan":
        return weight * ((pred - target) ** 2).mean()
    if gan_type == "vanilla":
        return weight * (pred.clamp(min=0) - pred * target
                         + torch.log1p(torch.exp(-pred.abs()))).mean()
    raise ValueError(f"Unknown gan_type {gan_type!r}")


def feature_matching_loss(fake_feats, real_feats, weight: float = 1.0):
    """The mean over the discriminator's maps of each map's L1 distance."""
    total = 0.0
    for f, r in zip(fake_feats, real_feats):
        total = total + _diff(f, r).abs().mean()
    return weight * total / max(len(fake_feats), 1)


def make_perceptual_loss(vgg, layer_weights: dict, perceptual_weight: float = 1.0,
                         style_weight: float = 0.0, norm_img: bool = False,
                         criterion: str = "l1"):
    """``loss_fn(pred, gt) -> (perceptual, style)`` on NHWC [0, 1] images
    (reference ``PerceptualLoss``, perceptual_loss.py:97-233): per requested
    layer index of ``vgg`` (a ``models.vgg.VGGFeatures``, frozen here), the
    l1 or mse distance of the prediction's maps to the detached GT's,
    weighted and summed; the style term compares their Gram matrices
    ``F^T F / (c h w)`` at the same layers with the same weights.
    ``norm_img`` maps [-1, 1] inputs to [0, 1]. A term whose weight is 0 is
    0.0."""
    from pnp_vcve_torch.models.vgg import vgg_features

    vgg.requires_grad_(False)
    names = sorted(layer_weights, key=int)
    crit = l1_loss if criterion == "l1" else mse_loss

    def gram(feat):
        b, h, w, c = feat.shape
        f = feat.reshape(b, h * w, c).float()
        return torch.einsum("bnc,bnd->bcd", f, f) / (c * h * w)

    def loss_fn(pred, gt):
        if norm_img:
            pred, gt = (pred + 1.0) * 0.5, (gt + 1.0) * 0.5
        f_pred = vgg_features(vgg, pred, names)
        f_gt = vgg_features(vgg, gt.detach(), names)
        percep = 0.0
        if perceptual_weight > 0:
            for k, w in layer_weights.items():
                percep = percep + w * crit(f_pred[k], f_gt[k])
            percep = percep * perceptual_weight
        style = 0.0
        if style_weight > 0:
            for k, w in layer_weights.items():
                style = style + w * crit(gram(f_pred[k]), gram(f_gt[k]))
            style = style * style_weight
        return percep, style

    return loss_fn
