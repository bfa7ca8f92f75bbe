"""Motion-vector warp, plain PyTorch (counterpart of pnp_vcve_tpu/ops/warp.py
and of the flow read of pnp_vcve_tpu/kernels/warp_pf.py).

``grid_sample(align_corners=True, padding_mode='zeros')`` on pixel-space
flows: the sample position of output pixel (y, x) is (x + fx, y + fy), a
bilinear blend of its four taps, taps outside the image reading zero.
Layout NHWC: ``x (n, h, w, c)``, ``flow (n, h, w, 2)`` with x first.

Three modes, as in the JAX package:

- ``'padgather'``: the flow is read per pixel (any flow);
- ``'block8'``: the flow is read at each 8x8 block's top-left pixel, the
  structure the MV rasterizer emits (JAX ``_warp_single_block8``); equal to
  ``'padgather'`` on block-constant flows up to float rounding. Falls back to
  ``'padgather'`` when h or w is not a multiple of 8;
- ``'pf'``: ``'block8'`` with each block's flow clamped to +-16 px in float32
  (JAX ``warp_pf._flow_to_terms``, the serving warp); needs h and w
  multiples of 16.

The block modes take each block's integer offset and fractions from its own
flow (floor(y + fy) == y + floor(fy) for integer y), as the JAX block warps
do. The blend order (rows, then columns) and the weights' cast to the
feature type follow the JAX warp, so the two agree to float rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flow_warp", "block_flow", "warp_blocks", "PF_MAX_MV"]

_BLOCK = 8
PF_MAX_MV = 16.0  # JAX kernels/warp_pf.py MAX_MV: the H.264 search range


def _padgather(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[1:3]
    dev = x.device
    row = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    col = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    px = col + flow[..., 0].float()
    py = row + flow[..., 1].float()
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return _bilinear(x, x0, y0, px - x0, py - y0)


def _bilinear(x, x0, y0, wx, wy):
    """Blend the taps (y0 + {0,1}, x0 + {0,1}) of ``x`` with fractions
    ``wx, wy``; ``x0, y0, wx, wy`` are float32 (n, h, w) maps."""
    n, h, w, c = x.shape
    dtype = x.dtype
    dev = x.device
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


def block_flow(flow: torch.Tensor, max_mv: float | None = None) -> torch.Tensor:
    """The per-block flow table: ``flow (n, h, w, 2)`` read at each 8x8
    block's top-left pixel, cast to float32 and, with ``max_mv``, clamped to
    +-max_mv -> a fresh contiguous ``(n, ceil(h/8), ceil(w/8), 2)`` float32."""
    fb = flow[:, ::_BLOCK, ::_BLOCK].to(torch.float32, memory_format=torch.contiguous_format,
                                         copy=True)
    if max_mv is not None:
        fb.clamp_(-max_mv, max_mv)
    return fb


def warp_blocks(x: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """Warp ``x (n, h, w, c)``, h and w multiples of 8, by the per-block
    flow ``fb (n, h/8, w/8, 2)`` float32: each block's pixels share the
    block's integer offset floor(f) and fractions f - floor(f)."""
    n, h, w, _ = x.shape
    if h % _BLOCK or w % _BLOCK or fb.shape != (n, h // _BLOCK, w // _BLOCK, 2):
        raise ValueError(f"warp_blocks: need h, w multiples of 8 and fb (n, h/8, w/8, 2); "
                         f"got x {tuple(x.shape)}, fb {tuple(fb.shape)}")
    d = torch.floor(fb)
    frac = fb - d

    def up(a):  # (n, h/8, w/8) -> (n, h, w)
        return a.repeat_interleave(_BLOCK, 1).repeat_interleave(_BLOCK, 2)

    dev = x.device
    row = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    col = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    # integer offsets: exact in float32 once clamped to where every tap of
    # the block lies outside the image (weight zero, as in the unclamped case)
    dx = up(d[..., 0]).clamp(-(w + 2 * _BLOCK), w + 2 * _BLOCK)
    dy = up(d[..., 1]).clamp(-(h + 2 * _BLOCK), h + 2 * _BLOCK)
    return _bilinear(x, col + dx, row + dy, up(frac[..., 0]), up(frac[..., 1]))


def flow_warp(x: torch.Tensor, flow: torch.Tensor, impl: str = "padgather") -> torch.Tensor:
    """Warp ``x`` (n, h, w, c) by pixel-space ``flow`` (n, h, w, 2), bilinear
    with zero padding; ``impl`` as in the module docstring. Nearest
    interpolation, border padding and the other JAX ``impl`` values are
    ROADMAP Queue A item 1."""
    if x.shape[1:3] != flow.shape[1:3]:
        raise ValueError(
            f"Spatial sizes of input {tuple(x.shape[1:3])} and flow "
            f"{tuple(flow.shape[1:3])} differ"
        )
    if impl not in ("padgather", "block8", "pf"):
        raise NotImplementedError(f"{impl=} is not ported (ROADMAP Queue A item 1)")
    h, w = x.shape[1:3]
    if impl == "pf":
        if h % (2 * _BLOCK) or w % (2 * _BLOCK):
            raise ValueError(f"warp impl='pf' needs h, w multiples of 16, got {h}x{w}")
        return warp_blocks(x, block_flow(flow, PF_MAX_MV))
    if impl == "block8" and h % _BLOCK == 0 and w % _BLOCK == 0:
        return warp_blocks(x, block_flow(flow))
    return _padgather(x, flow)
