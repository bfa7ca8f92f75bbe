"""Keyframe aligners (counterpart of pnp_vcve_tpu/models/alignment.py;
reference iconvsr_mv.py:12-85).

- :class:`VOSAlignment`: the bitstream-flow warp (``deform='vos'``, every
  shipped config);
- :class:`BasicDeformableAlignment`: the flow warp, an offset head on
  [warped, flow] and a modulated DCN whose offsets are the head's plus the
  flow (``deform='basic'``);
- :class:`FVCDeformableAlignment`: the offset head on [feature, flow] and
  the DCN on the head's offsets alone (``deform='fvc'``).

The warps go through an ops namespace (``pnp_vcve_torch.kernels.KERNELS``:
K1 on the card) when they are bilinear; nearest runs as plain PyTorch, as
it runs in XLA in the JAX package. The offset head and the DCN
(:func:`ops.deform_conv.modulated_deform_conv2d`) are plain PyTorch in
float32, as JAX computes them in XLA.

The reference's quirks are kept, as JAX keeps them: the head's two offset
thirds are concatenated and read as ``(groups, 9, (dy, dx))``, so the pairs
interleave per (group, tap); the flow is flipped to (dy, dx) and added
without the tanh bound the reference computes and leaves unused
(iconvsr_mv.py:75-78); the mask is a sigmoid.

Parameters carry the reference's names (``weight``, ``bias``,
``conv_offset.{0,2}``): a sweep's aligner loads the reference's
``deform_align.*`` (core/convert.py).
"""

from __future__ import annotations

import torch
from torch import nn

from pnp_vcve_torch.kernels import KERNELS
from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d
from pnp_vcve_torch.ops.dynamic_conv import conv2d_nhwc
from pnp_vcve_torch.ops.warp import flow_warp
from .bae import hwio
from .init import torch_default_

__all__ = ["VOSAlignment", "BasicDeformableAlignment", "FVCDeformableAlignment"]

_KK = 9  # 3x3 taps


def _warp(feat, flow, interpolation, ops):
    """The aligners' flow warp: the ops' K1 when bilinear (zeros padding,
    the per-pixel flow), else the plain warp."""
    if interpolation == "bilinear":
        return ops.flow_warp(feat, flow)
    return flow_warp(feat, flow, interpolation)


class VOSAlignment(nn.Module):
    def __init__(self, flow_interpolation: str = "bilinear"):
        super().__init__()
        self.flow_interpolation = flow_interpolation

    def forward(self, feat, flow, ops=KERNELS):
        """``feat (b, h, w, c)``; ``flow (b, h, w, 2)``, (dx, dy) pixels."""
        return _warp(feat, flow, self.flow_interpolation, ops)


class _DeformableAlignment(nn.Module):
    """The DCN's weights and the offset head: conv(c + 2 -> c), leaky ReLU
    0.1, conv(c -> groups * 9 * 3), the last zero-initialised (reference
    iconvsr_mv.py:25-29, 58-62)."""

    def __init__(self, channels: int = 64, deform_groups: int = 16):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(channels))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(channels + 2, channels, 3, 1, 1),
            nn.LeakyReLU(0.1),
            nn.Conv2d(channels, deform_groups * _KK * 3, 3, 1, 1),
        )

    def reset_parameters(self, generator: torch.Generator):
        torch_default_(self, generator)
        torch_default_(self.conv_offset[0], generator)
        with torch.no_grad():
            self.conv_offset[2].weight.zero_()
            self.conv_offset[2].bias.zero_()

    def _offset_head(self, x):
        c0, c1 = self.conv_offset[0], self.conv_offset[2]
        y = nn.functional.leaky_relu(conv2d_nhwc(x.float(), hwio(c0.weight), c0.bias), 0.1)
        return conv2d_nhwc(y, hwio(c1.weight), c1.bias)

    def _dcn(self, feat, head_in, flow=None):
        """The head on ``head_in``, then the DCN of ``feat`` at the head's
        offsets (plus ``flow`` flipped to (dy, dx), where given)."""
        b, h, w, _ = feat.shape
        g = self.deform_groups
        o1, o2, mask = self._offset_head(head_in).chunk(3, dim=-1)
        offsets = torch.cat([o1, o2], dim=-1).reshape(b, h, w, g, _KK, 2)
        if flow is not None:
            offsets = offsets + flow.flip(-1).float()[:, :, :, None, None, :]
        mask = torch.sigmoid(mask).reshape(b, h, w, g, _KK)
        return modulated_deform_conv2d(feat, offsets, mask, hwio(self.weight), self.bias)


class BasicDeformableAlignment(_DeformableAlignment):
    def __init__(self, channels: int = 64, deform_groups: int = 16,
                 flow_interpolation: str = "bilinear"):
        super().__init__(channels, deform_groups)
        self.flow_interpolation = flow_interpolation

    def forward(self, feat, flow, ops=KERNELS):
        warped = _warp(feat, flow, self.flow_interpolation, ops)
        return self._dcn(feat, torch.cat([warped, flow.to(warped.dtype)], dim=-1), flow)


class FVCDeformableAlignment(_DeformableAlignment):
    def forward(self, feat, offset_info, ops=KERNELS):
        """``offset_info (b, h, w, 2)``: the flow, read by the head only."""
        return self._dcn(feat, torch.cat([feat, offset_info.to(feat.dtype)], dim=-1))
