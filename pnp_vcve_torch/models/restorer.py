"""Restorer: the generator, its pixel loss and the eval metric protocol
(counterpart of pnp_vcve_tpu/models/restorer.py:60-155): per-frame metrics
on uint8-quantised images, averaged over the clip, then over the dataset;
:class:`CenterFrameRestorer` for the window -> centre-frame models (STDF,
MFQEv2, DCNGAN, MW-GAN), whose metrics run per centre frame, and
:func:`evaluate_center_frame_dataset` over their test samples."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable

import numpy as np
import torch
from torch import nn

from pnp_vcve_torch.metrics import l1_evaluation, mae, niqe, psnr, ssim, tensor2img
from pnp_vcve_torch.train.losses import LOSSES

__all__ = ["Restorer", "CenterFrameRestorer", "ALLOWED_METRICS", "average_clip_metrics",
           "evaluate_center_frame_dataset"]

ALLOWED_METRICS: Dict[str, Callable] = {
    "PSNR": psnr,
    "SSIM": ssim,
    "MAE": mae,
    "L1Evaluation": l1_evaluation,
    "NIQE": lambda out, gt, crop_border=0: niqe(out, crop_border=crop_border),
}


@dataclass
class Restorer:
    """The generator, the pixel loss by its config name, and the test
    config's metric protocol."""

    generator: nn.Module
    pixel_loss: str = "CharbonnierLoss"
    loss_weight: float = 1.0
    test_cfg: dict = field(default_factory=lambda: {"metrics": ["PSNR", "SSIM"], "crop_border": 0})

    def loss_fn(self) -> Callable:
        """``loss(pred, target)`` with the config's weight."""
        if self.pixel_loss not in LOSSES:
            raise NotImplementedError(
                f"pixel loss {self.pixel_loss!r} is not ported yet (ROADMAP Queue A item 8)"
            )
        base, weight = LOSSES[self.pixel_loss], self.loss_weight
        return lambda pred, target: base(pred, target, weight=weight)

    def evaluate_clip(self, output: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
        """Per-frame metrics averaged over the clip; ``output``, ``gt``:
        ``(t, h, w, 3)`` floats in [0, 1]."""
        crop_border = int(self.test_cfg.get("crop_border", 0))
        metrics = self.test_cfg.get("metrics", ["PSNR", "SSIM"])
        sums = {m: 0.0 for m in metrics}
        t = output.shape[0]
        for i in range(t):
            out_img = tensor2img(output[i])
            gt_img = tensor2img(gt[i])
            for m in metrics:
                sums[m] += ALLOWED_METRICS[m](out_img, gt_img, crop_border=crop_border)
        return {m: v / t for m, v in sums.items()}


def average_clip_metrics(per_clip: list[Dict[str, float]]) -> Dict[str, float]:
    """Dataset mean over clips."""
    if not per_clip:
        return {}
    return {k: float(np.mean([c[k] for c in per_clip])) for k in per_clip[0]}


@dataclass
class CenterFrameRestorer(Restorer):
    """Restorer of a model that maps a ``(b, t, h, w, c)`` window to its
    enhanced centre frame ``(b, h, w, c)`` (STDF, MFQEv2, DCNGAN, MW-GAN;
    reference restorers/stdf.py:13-120, mfqev2_restorer.py:14-140). Its
    clips are scored with :meth:`Restorer.evaluate_clip`, its centre frames
    with :meth:`evaluate_frame` (:func:`evaluate_center_frame_dataset`)."""

    def evaluate_frame(self, output: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
        """The test config's metrics of one frame, ``(h, w, 3)`` floats in [0, 1]."""
        crop_border = int(self.test_cfg.get("crop_border", 0))
        metrics = self.test_cfg.get("metrics", ["PSNR", "SSIM"])
        out_img, gt_img = tensor2img(output), tensor2img(gt)
        return {m: ALLOWED_METRICS[m](out_img, gt_img, crop_border=crop_border) for m in metrics}


def evaluate_center_frame_dataset(restorer: CenterFrameRestorer, samples: Iterable[dict],
                                  verbose: bool = True) -> Dict[str, float]:
    """Score ``(lq window, gt centre)`` samples (``LDPTripleDataset.iter_test``)
    one window at a time on the generator's device and average the
    per-frame metrics. Each window runs as ``generator(lq[None],
    base_qps=base_qps[None])`` under inference mode."""
    gen = restorer.generator
    device = next(gen.parameters()).device
    per_frame = []
    for s in samples:
        with torch.inference_mode():
            out = gen(torch.as_tensor(np.asarray(s["lq"][None], np.float32), device=device),
                      base_qps=torch.as_tensor(np.asarray(s["base_qps"][None], np.float32),
                                               device=device))
        m = restorer.evaluate_frame(out[0].float().cpu().numpy(), s["gt"][0])
        per_frame.append(m)
        if verbose:
            name = s.get("clip_name", str(len(per_frame)))
            print(f"[eval] {name}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))
    return average_clip_metrics(per_frame)
