"""Full-reference quality metrics of the evaluation protocol (counterpart of
pnp_vcve_tpu/metrics/quality.py), plain numpy on the host.

The reference computes PSNR/SSIM on uint8 images made by clamping a float
image to [0, 1], scaling by 255 and rounding (mmedit/core/misc.py:9-74
``tensor2img``), then

- PSNR over all channels jointly, ``20*log10(255/sqrt(mse))``
  (mmedit/core/evaluation/metrics.py:170-215);
- SSIM per channel with an 11x11 Gaussian window (sigma 1.5), the filtered
  maps cropped by 5 pixels on every side, C1=(0.01*255)^2,
  C2=(0.03*255)^2, and the channel means averaged (metrics.py:266-355).
  The crop keeps only border-independent pixels, so the filter is a
  valid-mode separable correlation and cv2's border mode does not matter.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["psnr", "ssim", "mae", "l1_evaluation", "tensor2img"]


def tensor2img(tensor, out_type=np.uint8, min_max=(0, 1)) -> np.ndarray:
    """NHWC / HWC float array -> image array: clamp to ``min_max``, rescale
    to [0, 1] and, for ``np.uint8``, scale by 255 and round. RGB order is
    kept (PSNR and SSIM do not depend on it)."""
    arr = np.asarray(tensor, dtype=np.float32)
    while arr.ndim > 3 and arr.shape[0] == 1:
        arr = arr[0]
    arr = np.clip(arr, min_max[0], min_max[1])
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if out_type == np.uint8:
        arr = (arr * 255.0).round()
    return arr.astype(out_type)


def _to_hwc(img: np.ndarray, input_order: str) -> np.ndarray:
    if input_order not in ("HWC", "CHW"):
        raise ValueError(f"Wrong input_order {input_order!r}; use 'HWC' or 'CHW'")
    img = np.asarray(img)
    if img.ndim == 2:
        return img[..., None]
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def _crop(img1, img2, crop_border):
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border]
    return img1, img2


def psnr(img1, img2, crop_border: int = 0, input_order: str = "HWC") -> float:
    """PSNR between two images in [0, 255]; inf on identical images."""
    img1 = _to_hwc(img1, input_order).astype(np.float32)
    img2 = _to_hwc(img2, input_order).astype(np.float32)
    if img1.shape != img2.shape:
        raise ValueError(f"Image shapes differ: {img1.shape} vs {img2.shape}")
    img1, img2 = _crop(img1, img2, crop_border)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * math.log10(255.0 / math.sqrt(mse)))


def mae(img1, img2, crop_border: int = 0, input_order: str = "HWC") -> float:
    """Mean absolute error on [0, 1]-normalised images (metrics.py:218-263)."""
    img1 = _to_hwc(img1, input_order).astype(np.float32) / 255.0
    img2 = _to_hwc(img2, input_order).astype(np.float32) / 255.0
    img1, img2 = _crop(img1, img2, crop_border)
    return float(np.mean(np.abs(img1 - img2)))


def _gaussian_kernel_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), L1-normalised."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


_SSIM_K1D = _gaussian_kernel_1d(11, 1.5)


def _filter_valid(img: np.ndarray) -> np.ndarray:
    """Separable 11x11 Gaussian correlation, valid region only, in float64:
    ``cv2.filter2D(img, -1, window)[5:-5, 5:-5]`` for any border mode."""
    k = _SSIM_K1D
    n = len(k)
    h, w = img.shape
    out = np.zeros((h - n + 1, w), dtype=np.float64)
    for i, kv in enumerate(k):
        out += kv * img[i : i + h - n + 1, :]
    out2 = np.zeros((h - n + 1, w - n + 1), dtype=np.float64)
    for j, kv in enumerate(k):
        out2 += kv * out[:, j : j + w - n + 1]
    return out2


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mu1 = _filter_valid(img1)
    mu2 = _filter_valid(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter_valid(img1**2) - mu1_sq
    sigma2_sq = _filter_valid(img2**2) - mu2_sq
    sigma12 = _filter_valid(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def ssim(img1, img2, crop_border: int = 0, input_order: str = "HWC") -> float:
    """SSIM between two images in [0, 255]; per channel, then averaged."""
    img1 = _to_hwc(img1, input_order)
    img2 = _to_hwc(img2, input_order)
    if img1.shape != img2.shape:
        raise ValueError(f"Image shapes differ: {img1.shape} vs {img2.shape}")
    img1, img2 = _crop(img1, img2, crop_border)
    return float(np.mean([_ssim_single(img1[..., i], img2[..., i])
                          for i in range(img1.shape[2])]))


def l1_evaluation(img1, img2, crop_border: int = 0, input_order: str = "HWC") -> float:
    """The reference's ``L1Evaluation`` metric (metrics.py:358-378): the
    mean absolute error on [0, 1]-normalised images."""
    return mae(img1, img2, crop_border=crop_border, input_order=input_order)
