"""Evaluation metrics, plain numpy on the host (counterparts of
pnp_vcve_tpu/metrics/quality.py and niqe.py)."""

from .niqe import niqe
from .quality import l1_evaluation, mae, psnr, ssim, tensor2img

__all__ = ["psnr", "ssim", "mae", "l1_evaluation", "niqe", "tensor2img"]
