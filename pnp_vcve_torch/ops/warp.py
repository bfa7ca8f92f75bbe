"""Motion-vector warp, plain PyTorch (counterpart of pnp_vcve_tpu/ops/warp.py).

``grid_sample(align_corners=True, padding_mode='zeros')`` on pixel-space
flows: the sample position of output pixel (y, x) is (x + fx, y + fy), a
bilinear blend of its four taps, taps outside the image reading zero.
Layout NHWC: ``x (n, h, w, c)``, ``flow (n, h, w, 2)`` with x first.

Two modes, as in the JAX package:

- ``'padgather'``: the flow is read per pixel (any flow);
- ``'block8'``: the flow is read at each 8x8 block's top-left pixel, the
  structure the MV rasterizer emits; equal to ``'padgather'`` on
  block-constant flows (JAX ``_warp_single_block8``).

The blend order (rows, then columns) and the weights' cast to the feature
type follow the JAX warp, so the two agree to float rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flow_warp"]

_BLOCK = 8


def _padgather(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    dtype = x.dtype
    dev = x.device
    row = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    col = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    px = col + flow[..., 0].float()
    py = row + flow[..., 1].float()
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    # a tap 1 px outside reads the zero border of the padded image; farther
    # taps read a clamped pixel and get weight 0
    zero = torch.zeros((), device=dev)
    wx1 = torch.where((x0 + 1 >= 0) & (x0 + 1 <= w), wx, zero).to(dtype)
    wx0 = torch.where((x0 >= -1) & (x0 <= w - 1), 1.0 - wx, zero).to(dtype)
    wy1 = torch.where((y0 + 1 >= 0) & (y0 + 1 <= h), wy, zero).to(dtype)
    wy0 = torch.where((y0 >= -1) & (y0 <= h - 1), 1.0 - wy, zero).to(dtype)
    x0i = x0.clamp(-1, w - 1).long() + 1
    y0i = y0.clamp(-1, h - 1).long() + 1

    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(n, (h + 2) * (w + 2), c)
    idx = (y0i * (w + 2) + x0i).reshape(n, h * w, 1)

    def tap(dy, dx):
        i = (idx + dy * (w + 2) + dx).expand(n, h * w, c)
        return torch.gather(xp, 1, i).reshape(n, h, w, c)

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    wy0, wy1, wx0, wx1 = (t[..., None] for t in (wy0, wy1, wx0, wx1))
    row0 = v00 * wy0 + v10 * wy1
    row1 = v01 * wy0 + v11 * wy1
    return row0 * wx0 + row1 * wx1


def flow_warp(x: torch.Tensor, flow: torch.Tensor, impl: str = "padgather") -> torch.Tensor:
    """Warp ``x`` (n, h, w, c) by pixel-space ``flow`` (n, h, w, 2), bilinear
    with zero padding. Nearest interpolation, border padding and the other
    JAX ``impl`` values are ROADMAP Queue A item 1."""
    if x.shape[1:3] != flow.shape[1:3]:
        raise ValueError(
            f"Spatial sizes of input {tuple(x.shape[1:3])} and flow "
            f"{tuple(flow.shape[1:3])} differ"
        )
    if impl not in ("padgather", "block8"):
        raise NotImplementedError(f"{impl=} is not ported (ROADMAP Queue A item 1)")
    h, w = x.shape[1:3]
    if impl == "block8" and h % _BLOCK == 0 and w % _BLOCK == 0:
        fb = flow[:, ::_BLOCK, ::_BLOCK]
        flow = fb.repeat_interleave(_BLOCK, 1).repeat_interleave(_BLOCK, 2)
    return _padgather(x, flow)
