"""Bilinear resize with torch ``F.interpolate``'s sampling (counterpart of
pnp_vcve_tpu/ops/resize.py).

Both forms build separable interpolation matrices in float64 (numpy), cast
them to float32 and apply ``out = A_h @ x @ A_w^T`` per channel in float32,
as the JAX package does; unlike an antialiased resize they sample at the
position in both directions.

:func:`resize_bilinear`: half-pixel centers (``align_corners=False``),
``src = (i + 0.5) * n_in / n_out - 0.5`` clamped to the valid range.
:func:`resize_bilinear_align_corners`: ``src = i * (n_in - 1) / (n_out - 1)``.
:func:`resize_bicubic`: ``jax.image.resize(method='bicubic')``, which the
JAX package's BasicVSR++ uses to bring full-size frames to the flow
network's quarter size: Keys' cubic (a = -0.5) at half-pixel centers,
widened by the factor when it shrinks (antialiasing), each output's weights
normalised to sum 1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resize_bilinear", "resize_bilinear_align_corners", "resize_bicubic"]


def _matrix_from_pos(pos: np.ndarray, n_in: int) -> np.ndarray:
    """Rows of bilinear weights for float64 source positions ``pos``."""
    n_out = pos.shape[0]
    pos = np.clip(pos, 0.0, n_in - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, max(n_in - 2, 0))
    frac = pos - lo
    a = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    a[rows, lo] += 1.0 - frac
    a[rows, np.minimum(lo + 1, n_in - 1)] += frac
    return a


def _half_pixel_matrix(n_out: int, n_in: int) -> np.ndarray:
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    return _matrix_from_pos(pos, n_in)


def _align_corners_matrix(n_out: int, n_in: int) -> np.ndarray:
    if n_out == 1 or n_in == 1:
        return np.full((n_out, n_in), 1.0 / n_in)
    pos = np.arange(n_out, dtype=np.float64) * ((n_in - 1) / (n_out - 1))
    return _matrix_from_pos(pos, n_in)


def _keys_cubic_matrix(n_out: int, n_in: int) -> np.ndarray:
    """JAX ``image.scale.compute_weight_mat`` with the Keys kernel, translation
    0 and antialiasing, as rows ``(n_out, n_in)``."""
    inv_scale = n_in / n_out
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(pos[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / max(inv_scale, 1.0)
    k = ((1.5 * x - 2.5) * x) * x + 1.0
    k = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, k)
    k = np.where(x >= 2.0, 0.0, k)
    total = k.sum(axis=1, keepdims=True)
    k = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 k / np.where(total != 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[:, None], k, 0.0)


def _apply(x: torch.Tensor, ah: np.ndarray, aw: np.ndarray) -> torch.Tensor:
    ah_t, aw_t = (torch.from_numpy(a.astype(np.float32)).to(x.device) for a in (ah, aw))
    out = torch.einsum("oh,bhwc->bowc", ah_t, x.float())
    out = torch.einsum("pw,bhwc->bhpc", aw_t, out)
    return out.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(b, h, w, c) -> (b, *size, c), torch ``align_corners=False``."""
    _, h, w, _ = x.shape
    if (h, w) == tuple(size):
        return x
    return _apply(x, _half_pixel_matrix(size[0], h), _half_pixel_matrix(size[1], w))


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(b, h, w, c) -> (b, *size, c), torch ``align_corners=True``."""
    _, h, w, _ = x.shape
    if (h, w) == tuple(size):
        return x
    return _apply(x, _align_corners_matrix(size[0], h), _align_corners_matrix(size[1], w))


def resize_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(b, h, w, c) -> (b, *size, c), ``jax.image.resize(method='bicubic')``
    (antialiased when it shrinks)."""
    _, h, w, _ = x.shape
    if (h, w) == tuple(size):
        return x
    return _apply(x, _keys_cubic_matrix(size[0], h), _keys_cubic_matrix(size[1], w))
