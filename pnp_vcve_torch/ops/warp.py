"""Motion-vector warp, plain PyTorch (counterpart of pnp_vcve_tpu/ops/warp.py
and of the flow read of pnp_vcve_tpu/kernels/warp_pf.py).

``grid_sample(align_corners=True)`` on pixel-space flows: the sample
position of output pixel (y, x) is (x + fx, y + fy). Layout NHWC:
``x (n, h, w, c)``, ``flow (n, h, w, 2)`` with x first. ``interpolation`` is
``'bilinear'`` (a blend of the four taps) or ``'nearest'`` (the tap at the
position rounded half to even, as grid_sample's ``nearbyint``);
``padding_mode`` is ``'zeros'`` (taps outside the image read zero) or
``'border'`` (they read the edge pixel).

The ``impl`` values of the JAX package, each its reading of the same
function:

- ``'padgather'``: the flow is read per pixel, the taps from the image
  padded by one zero pixel, every edge rule folded into the four weights;
- ``'blockgather'``: each pixel's 2x2 block starts clamped into
  ``[0, h-2] x [0, w-2]``, each corner masked by its own validity (JAX
  ``_warp_single_blockgather``);
- ``'corner'``: four single-tap gathers, each masked (JAX ``_warp_single``,
  the semantics baseline; nearest interpolation always runs here);
- ``'block8'``: the flow is read at each 8x8 block's top-left pixel, the
  structure the MV rasterizer emits (JAX ``_warp_single_block8``); equal to
  ``'padgather'`` on block-constant flows up to float rounding. Bilinear
  with zeros padding on multiples of 8 only, else ``'padgather'``;
- ``'pf'`` (the port's name for the serving warp): ``'block8'`` with each
  block's flow clamped to +-16 px in float32 (JAX
  ``warp_pf._flow_to_terms``); needs h and w multiples of 16, bilinear with
  zeros padding.

The dispatch is JAX ``flow_warp``'s (:408-466): what ``'block8'`` and
``'blockgather'`` do not take falls through to ``'padgather'`` or to the
per-tap form, and border padding there clamps the flow so that every
sample lands inside. The kernels (``kernels.flow_warp``,
``flow_warp_block``) compute the bilinear zeros-padding forms only; nearest
and border run here, as they run in XLA in the JAX package.

The block modes take each block's integer offset and fractions from its own
flow (floor(y + fy) == y + floor(fy) for integer y), as the JAX block warps
do. The blend orders and the weights' cast to the feature type follow each
JAX form, so the two agree to float rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["flow_warp", "block_flow", "warp_blocks", "PF_MAX_MV"]

_BLOCK = 8
PF_MAX_MV = 16.0  # JAX kernels/warp_pf.py MAX_MV: the H.264 search range


def _grid(h: int, w: int, dev):
    """float32 pixel rows (1, h, 1) and columns (1, 1, w)."""
    row = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    col = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    return row, col


def _positions(flow: torch.Tensor, h: int, w: int):
    """The float32 sample positions ``(px, py)``, (n, h, w) each."""
    row, col = _grid(h, w, flow.device)
    return col + flow[..., 0].float(), row + flow[..., 1].float()


def _padgather(x: torch.Tensor, flow: torch.Tensor, border: bool = False) -> torch.Tensor:
    h, w = x.shape[1:3]
    px, py = _positions(flow, h, w)
    if border:  # border padding is coordinate clamping for bilinear
        px = px.clamp(0, w - 1)
        py = py.clamp(0, h - 1)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return _bilinear(x, x0, y0, px - x0, py - y0)


def _bilinear(x, x0, y0, wx, wy):
    """Blend the taps (y0 + {0,1}, x0 + {0,1}) of ``x`` with fractions
    ``wx, wy``, taps outside the image reading zero; ``x0, y0, wx, wy`` are
    float32 (n, h, w) maps, or (n, h, w, g) maps that place each of ``g``
    equal groups of x's channels apart (the deformable conv's groups)."""
    n, h, w, c = x.shape
    if x0.dim() == 3:
        x0, y0, wx, wy = (a[..., None] for a in (x0, y0, wx, wy))
    g = x0.shape[3]
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

    cg = c // g
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(n, (h + 2) * (w + 2), g, cg)
    idx = (y0i * (w + 2) + x0i).reshape(n, h * w, g, 1)

    def tap(dy, dx):
        i = (idx + dy * (w + 2) + dx).expand(n, h * w, g, cg)
        return torch.gather(xp, 1, i).reshape(n, h, w, g, cg)

    v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    wy0, wy1, wx0, wx1 = (t[..., None] for t in (wy0, wy1, wx0, wx1))
    row0 = v00 * wy0 + v10 * wy1
    row1 = v01 * wy0 + v11 * wy1
    return (row0 * wx0 + row1 * wx1).reshape(n, h, w, c)


def _gather_pixels(x: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """``x[n, iy, ix]`` for (n, h, w) integer maps already inside the image."""
    n, h, w, c = x.shape
    idx = (iy * w + ix).reshape(n, h * w, 1).expand(n, h * w, c)
    return torch.gather(x.reshape(n, h * w, c), 1, idx).reshape(n, h, w, c)


def _tap(x, iy, ix):
    """One tap per pixel, zero where (iy, ix) lies outside the image."""
    h, w = x.shape[1:3]
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    v = _gather_pixels(x, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
    return torch.where(valid[..., None], v, torch.zeros((), dtype=x.dtype, device=x.device))


def _corner(x: torch.Tensor, flow: torch.Tensor, interpolation: str) -> torch.Tensor:
    """Four masked single-tap gathers, or one for nearest (JAX
    ``_warp_single``, :35-78), zeros padding."""
    h, w = x.shape[1:3]
    dtype = x.dtype
    px, py = _positions(flow, h, w)
    if interpolation == "nearest":
        # torch.round rounds half to even, as grid_sample's nearbyint
        return _tap(x, torch.round(py).long(), torch.round(px).long())
    if interpolation != "bilinear":
        raise ValueError(f"Unsupported interpolation: {interpolation!r}")
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0).to(dtype)[..., None]
    wy = (py - y0).to(dtype)[..., None]
    x0, y0 = x0.long(), y0.long()
    v00, v01 = _tap(x, y0, x0), _tap(x, y0, x0 + 1)
    v10, v11 = _tap(x, y0 + 1, x0), _tap(x, y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _blockgather(x: torch.Tensor, flow: torch.Tensor, border: bool = False) -> torch.Tensor:
    """Bilinear warp from each pixel's 2x2 block, its start clamped into
    [0, h-2] x [0, w-2]; each corner is read at its clamped offset in the
    block and masked by its own validity (JAX ``_warp_single_blockgather``,
    :81-148; h, w >= 2). With ``border`` every corner counts."""
    h, w = x.shape[1:3]
    dtype = x.dtype
    px, py = _positions(flow, h, w)
    y0f = torch.floor(py)
    x0f = torch.floor(px)
    wx = (px - x0f).to(dtype)
    wy = (py - y0f).to(dtype)
    y0, x0 = y0f.long(), x0f.long()
    y0c = y0.clamp(0, h - 2)
    x0c = x0.clamp(0, w - 2)
    b00, b01 = _gather_pixels(x, y0c, x0c), _gather_pixels(x, y0c, x0c + 1)
    b10, b11 = _gather_pixels(x, y0c + 1, x0c), _gather_pixels(x, y0c + 1, x0c + 1)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    out = None
    for dy in range(2):
        wrow = (1 - wy) if dy == 0 else wy
        yy = y0 + dy
        # block-local offset: equals dy except at clamped image borders
        oy = ((yy - y0c).clamp(0, 1) == 1)[..., None]
        for dx in range(2):
            wcol = (1 - wx) if dx == 0 else wx
            xx = x0 + dx
            ox = ((xx - x0c).clamp(0, 1) == 1)[..., None]
            v = torch.where(oy, torch.where(ox, b11, b10), torch.where(ox, b01, b00))
            term = v * (wrow * wcol)[..., None]
            if not border:
                valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                term = torch.where(valid[..., None], term, zero)
            out = term if out is None else out + term
    return out


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

    row, col = _grid(h, w, x.device)
    # integer offsets: exact in float32 once clamped to where every tap of
    # the block lies outside the image (weight zero, as in the unclamped case)
    dx = up(d[..., 0]).clamp(-(w + 2 * _BLOCK), w + 2 * _BLOCK)
    dy = up(d[..., 1]).clamp(-(h + 2 * _BLOCK), h + 2 * _BLOCK)
    return _bilinear(x, col + dx, row + dy, up(frac[..., 0]), up(frac[..., 1]))


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = "bilinear",
              impl: str = "padgather", padding_mode: str = "zeros") -> torch.Tensor:
    """Warp ``x`` (n, h, w, c) by pixel-space ``flow`` (n, h, w, 2);
    ``interpolation``, ``impl`` and ``padding_mode`` as in the module
    docstring."""
    if x.shape[1:3] != flow.shape[1:3]:
        raise ValueError(
            f"Spatial sizes of input {tuple(x.shape[1:3])} and flow "
            f"{tuple(flow.shape[1:3])} differ"
        )
    h, w = x.shape[1:3]
    bilinear_zeros = interpolation == "bilinear" and padding_mode == "zeros"
    if impl == "pf":
        if not bilinear_zeros:
            raise ValueError("warp impl='pf' is bilinear with zeros padding")
        if h % (2 * _BLOCK) or w % (2 * _BLOCK):
            raise ValueError(f"warp impl='pf' needs h, w multiples of 16, got {h}x{w}")
        return warp_blocks(x, block_flow(flow, PF_MAX_MV))
    if bilinear_zeros and impl == "block8" and h % _BLOCK == 0 and w % _BLOCK == 0:
        # exact only for flows constant over the 8x8 macroblock grid
        return warp_blocks(x, block_flow(flow))
    border = padding_mode == "border"
    if interpolation == "bilinear" and impl in ("padgather", "block8"):
        return _padgather(x, flow, border)
    if interpolation == "bilinear" and impl == "blockgather" and h >= 2 and w >= 2:
        return _blockgather(x, flow, border)
    if border:
        # clamp the flow so that every sample lands inside: border padding
        # for bilinear (the tiny-image fallback of JAX :455-463)
        px, py = _positions(flow, h, w)
        row, col = _grid(h, w, flow.device)
        flow = torch.stack([px.clamp(0, w - 1) - col, py.clamp(0, h - 1) - row],
                           dim=-1).to(flow.dtype)
    elif padding_mode != "zeros":
        raise NotImplementedError(f"{padding_mode=} requires impl='blockgather'")
    return _corner(x, flow, interpolation)
