"""The adversarial train step of DCNGAN (counterpart of
pnp_vcve_tpu/train/gan.py: ``make_gan_train_step`` :23-86; reference
restorers/dcngan.py:144-228).

One step updates both networks, in JAX's order. The fake is computed once,
without a gradient, from the generator as it stands. The discriminator
scores the GT and the fake, ``0.5 * (gan(real, 1) + gan(fake, 0))``, and
its optimizer steps. Then the generator recomputes the fake, and the
updated discriminator scores it: the Charbonnier pixel loss times
``pixel_weight``, plus ``gan_weight * gan(fake, 1)``, plus the feature-
matching term on the discriminator's maps of the fake and the GT, plus the
VGG perceptual and style terms; its backward reaches the generator's
parameters only (``backward(inputs=...)``), and its optimizer steps. As in
``train_step.make_train_step``, a parameter the loss does not reach gets a
zero gradient, so each Adam keeps optax's step count.
"""

from __future__ import annotations

from typing import Callable

import torch

from .losses import charbonnier_loss, feature_matching_loss, gan_loss
from .state import TrainState

__all__ = ["make_gan_train_step"]


def _update(state: TrainState, params):
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_gan_train_step(generator: torch.nn.Module, discriminator: torch.nn.Module,
                        gan_type: str = "lsgan", pixel_weight: float = 1.0,
                        gan_weight: float = 0.01,
                        fm_weight: float = 0.0, perceptual_loss: Callable | None = None):
    """``step(g_state, d_state, batch) -> (g_state, d_state, {"loss_g",
    "loss_d"})``, both states updated in place. ``batch``: ``lq (b, t, h, w,
    c)`` the window, ``gt (b, h, w, c)`` its centre frame, ``base_qps (b, t)``
    (optional), tensors on the networks' device. ``perceptual_loss(fake,
    gt) -> (perceptual, style)``, its weights inside."""
    g_params = list(generator.parameters())
    d_params = list(discriminator.parameters())

    def train_step(g_state: TrainState, d_state: TrainState, batch):
        lq, gt, base_qps = batch["lq"], batch["gt"], batch.get("base_qps")
        with torch.no_grad():
            fake = generator(lq, base_qps=base_qps)

        d_state.optimizer.zero_grad(set_to_none=True)
        real_out, fake_out = discriminator(gt), discriminator(fake)
        d_loss = 0.5 * (gan_loss(real_out["prediction"], True, gan_type)
                        + gan_loss(fake_out["prediction"], False, gan_type))
        d_loss.backward()
        _update(d_state, d_params)

        g_state.optimizer.zero_grad(set_to_none=True)
        fake_g = generator(lq, base_qps=base_qps)
        fake_out = discriminator(fake_g)
        loss = pixel_weight * charbonnier_loss(fake_g, gt)
        loss = loss + gan_weight * gan_loss(fake_out["prediction"], True, gan_type)
        if fm_weight:
            with torch.no_grad():
                real_out = discriminator(gt)
            loss = loss + feature_matching_loss(fake_out["feature_maps"],
                                                real_out["feature_maps"], fm_weight)
        if perceptual_loss is not None:
            percep, style = perceptual_loss(fake_g, gt)
            loss = loss + percep + style
        loss.backward(inputs=g_params)
        _update(g_state, g_params)
        return g_state, d_state, {"loss_g": loss.detach(), "loss_d": d_loss.detach()}

    return train_step
