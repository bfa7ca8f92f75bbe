"""NIQE, the no-reference Natural Image Quality Evaluator (counterpart of
pnp_vcve_tpu/metrics/niqe.py; reference mmedit/core/evaluation/
metrics.py:380-572, after the official MATLAB release of Mittal et al.,
2013). ``niqe_pris_params.npz`` holds the released pristine-model constants:
the MVG mean and covariance and the 7x7 Gaussian window.

MSCN coefficients (local mean/std normalisation with the window), 96x96
blocks, per block 18 AGGD-fit features (the block and 4 orientations of
neighbour products) at two scales (the second after a MATLAB-style
antialiased bicubic half-size resize), then the Mahalanobis-style distance
between the fitted MVG of the image's features and the pristine one.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as _gamma

__all__ = ["niqe"]

_PARAMS_PATH = Path(__file__).parent / "niqe_pris_params.npz"

# AGGD shape-parameter search grid (official implementation: 0.2..10, 1e-3)
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma(2.0 / _GAM)) / (_gamma(1.0 / _GAM) * _gamma(3.0 / _GAM))


def estimate_aggd_param(block: np.ndarray):
    """Asymmetric generalised Gaussian fit by moment matching over the alpha
    grid: ``(alpha, beta_l, beta_r)`` (metrics.py:380-408)."""
    v = block.reshape(-1)
    neg = v[v < 0]
    pos = v[v > 0]
    left_std = math.sqrt(float(np.mean(neg**2))) if neg.size else 0.0
    right_std = math.sqrt(float(np.mean(pos**2))) if pos.size else 0.0
    gammahat = left_std / right_std if right_std else np.inf
    m2 = float(np.mean(v**2))
    rhat = float(np.mean(np.abs(v))) ** 2 / m2 if m2 else 0.0
    rhatnorm = (rhat * (gammahat**3 + 1) * (gammahat + 1)) / ((gammahat**2 + 1) ** 2)
    alpha = _GAM[int(np.argmin((_R_GAM - rhatnorm) ** 2))]
    scale = math.sqrt(_gamma(1.0 / alpha) / _gamma(3.0 / alpha))
    return alpha, left_std * scale, right_std * scale


def _block_features(block: np.ndarray) -> list:
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat = [alpha, (beta_l + beta_r) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(prod)
        mean = (beta_r - beta_l) * (_gamma(2.0 / alpha) / _gamma(1.0 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic kernel, a = -0.5 (MATLAB's bicubic)."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
    ) * ((ax > 1) & (ax <= 2))


def _resize_weights(n_in: int, scale: float):
    """Per-output-pixel weights and indices of MATLAB ``imresize``
    ('bicubic', antialiasing on for scale < 1)."""
    n_out = int(np.ceil(n_in * scale))
    kernel_width = 4.0 / scale if scale < 1 else 4.0
    u = (np.arange(1, n_out + 1)) / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    inds = left[:, None] + np.arange(p)[None, :]
    dist = u[:, None] - inds
    w = scale * _cubic(scale * dist) if scale < 1 else _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    inds = np.clip(inds, 1, n_in).astype(np.int64) - 1  # replicate border
    keep = ~np.all(w == 0, axis=0)
    return w[:, keep], inds[:, keep]


def matlab_resize_half(img: np.ndarray) -> np.ndarray:
    """MATLAB ``imresize(img, 0.5, 'bicubic')`` (antialiased) on a 2D image."""
    out = img
    for axis in (0, 1):
        w, inds = _resize_weights(out.shape[axis], 0.5)
        moved = np.moveaxis(out, axis, 0)
        out = np.moveaxis(np.einsum("ok,ok...->o...", w, moved[inds]), 0, axis)
    return out


def _rgb_to_y255(img_rgb_255: np.ndarray) -> np.ndarray:
    """BT.601 studio-swing luma of an RGB [0, 255] image, in [16, 235]."""
    r, g, b = img_rgb_255[..., 0], img_rgb_255[..., 1], img_rgb_255[..., 2]
    return (65.481 * r + 128.553 * g + 24.966 * b) / 255.0 + 16.0


def niqe(img, crop_border: int = 0, input_order: str = "HWC", convert_to: str = "y",
         block_size: int = 96) -> float:
    """NIQE of one image in [0, 255] (lower is better); HWC is RGB.
    ``convert_to``: 'y' (BT.601 luma) or 'gray'."""
    params = np.load(_PARAMS_PATH)
    mu_pris = params["mu_pris_param"]
    cov_pris = params["cov_pris_param"]
    window = params["gaussian_window"]

    img = np.asarray(img, np.float64)
    if img.ndim == 3 and input_order == "CHW":
        img = np.transpose(img, (1, 2, 0))
    if img.ndim == 3:
        if convert_to == "y":
            img = _rgb_to_y255(img)
        elif convert_to == "gray":
            img = img @ np.array([0.299, 0.587, 0.114])
        else:
            raise ValueError(f"unknown convert_to={convert_to!r}")
        img = np.squeeze(img)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = img.round()  # the official implementation quantises first

    h, w = img.shape
    nbh, nbw = h // block_size, w // block_size
    if nbh == 0 or nbw == 0:
        raise ValueError(f"image {h}x{w} smaller than the {block_size} NIQE block")
    img = img[: nbh * block_size, : nbw * block_size]

    feats = []
    for scale in (1, 2):
        mu = convolve(img, window, mode="nearest")
        sigma = np.sqrt(np.abs(convolve(img * img, window, mode="nearest") - mu * mu))
        mscn = (img - mu) / (sigma + 1)
        bs = block_size // scale
        feats.append(np.asarray([
            _block_features(mscn[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs])
            for j in range(nbw)
            for i in range(nbh)
        ]))
        if scale == 1:
            img = matlab_resize_half(img / 255.0) * 255.0
    feats = np.concatenate(feats, axis=1)

    mu_dist = np.nanmean(feats, axis=0)
    clean = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(clean, rowvar=False)
    inv_cov = np.linalg.pinv((cov_pris + cov_dist) / 2)
    diff = mu_pris - mu_dist
    return float(np.squeeze(np.sqrt(diff @ inv_cov @ diff.T)))
