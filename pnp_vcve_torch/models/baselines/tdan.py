"""TDAN, the temporally-deformable alignment network (counterpart of
pnp_vcve_tpu/models/baselines/tdan.py; reference sr_backbones/tdan_net.py:
15-165).

Residual-block features of every frame; each frame but the centre one is
aligned to it by deformable convs (DCNv1: the port's modulated DCN with a
mask of ones, as JAX computes it) and brought back to RGB; the aligned
frames, stacked into channels, go through residual blocks, two x2 pixel
shuffles and a bias-free output conv. The model returns the pair ``(hr
(b, 4h, 4w, 3), aligned_lrs (b, t, h, w, 3))``, TDAN's auxiliary output
included, as JAX does. The window is 5 frames, the reference's fixed
count (JAX reads it from the input at init).

A ``DeformConv2dPack`` regresses ``groups x 9 x (dy, dx)`` offsets from its
own input (from an extra feature when ``augmented``) with a conv that
starts at zero. Plain PyTorch, as JAX computes it in XLA; no TPU kernel is
on this path. Parameter names follow the JAX module tree in PyTorch's forms
(``feat_extract.main.*``, ``feat_agg_dcn1.{weight, bias, conv_offset.*}``,
``upsample1.upsample_conv``, ``conv_out``; ``core/convert.py:
tdan_state_dict``).
"""

from __future__ import annotations

import torch
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d
from ..bae import hwio
from ..init import torch_default_
from ..pnp_vcve import PixelShufflePack
from .basicvsr_pp import ResidualBlocksWithInputConv

__all__ = ["DeformConv2dPack", "TDANNet"]


class DeformConv2dPack(nn.Module):
    """DCNv1 with offsets regressed from its input, or from ``extra_feat``
    when ``augmented``."""

    def __init__(self, channels: int, deform_groups: int = 8, augmented: bool = False):
        super().__init__()
        self.deform_groups, self.augmented = deform_groups, augmented
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(channels))
        self.conv_offset = nn.Conv2d(channels, 18 * deform_groups, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator):
        torch_default_(self, generator)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x, extra_feat=None):
        b, h, w, _ = x.shape
        g = self.deform_groups
        offsets = conv_same(extra_feat if self.augmented else x, self.conv_offset)
        offsets = offsets.reshape(b, h, w, g, 9, 2)
        mask = torch.ones((b, h, w, g, 9), dtype=x.dtype, device=x.device)
        return modulated_deform_conv2d(x, offsets, mask, hwio(self.weight), self.bias)


class TDANNet(nn.Module):
    """A window of t frames -> ``(hr centre frame (b, 4h, 4w, 3), aligned
    frames (b, t, h, w, 3))``."""

    NUM_FRAMES = 5

    def __init__(self, in_channels: int = 3, mid_channels: int = 64, out_channels: int = 3,
                 num_blocks_before_align: int = 5, num_blocks_after_align: int = 10):
        super().__init__()
        cm = mid_channels
        self.feat_extract = ResidualBlocksWithInputConv(in_channels, cm, num_blocks_before_align)
        self.feat_agg_conv = nn.Conv2d(2 * cm, cm, 3, 1, 1)
        self.feat_agg_dcn1 = DeformConv2dPack(cm)
        self.feat_agg_dcn2 = DeformConv2dPack(cm)
        self.align_1 = DeformConv2dPack(cm, augmented=True)
        self.align_2 = DeformConv2dPack(cm)
        self.to_rgb = nn.Conv2d(cm, 3, 3, 1, 1)
        self.reconstruct = ResidualBlocksWithInputConv(3 * self.NUM_FRAMES, cm,
                                                       num_blocks_after_align)
        self.upsample1 = PixelShufflePack(cm, 2)
        self.upsample2 = PixelShufflePack(cm, 2)
        self.conv_out = nn.Conv2d(cm, out_channels, 3, 1, 1, bias=False)

    def reset_parameters(self, generator: torch.Generator):
        self.feat_extract.reset_parameters(generator)
        for m in (self.feat_agg_dcn1, self.feat_agg_dcn2, self.align_1, self.align_2):
            m.reset_parameters(generator)
        for conv in (self.feat_agg_conv, self.to_rgb, self.upsample1.upsample_conv,
                     self.upsample2.upsample_conv, self.conv_out):
            torch_default_(conv, generator)
        self.reconstruct.reset_parameters(generator)

    def forward(self, lrs, **_ignored):
        b, t, h, w, c = lrs.shape
        if t != self.NUM_FRAMES:
            raise ValueError(f"TDAN takes windows of {self.NUM_FRAMES} frames, got {t}")
        center = t // 2
        feats = self.feat_extract(lrs.reshape(b * t, h, w, c)).reshape(b, t, h, w, -1)
        # every frame but the centre one in one batch
        others = [i for i in range(t) if i != center]
        nbr = feats[:, others].reshape(b * (t - 1), h, w, -1)
        ref = feats[:, center, None].expand(-1, t - 1, -1, -1, -1).reshape(nbr.shape)
        agg = self.feat_agg_dcn2(self.feat_agg_dcn1(conv_same(torch.cat([ref, nbr], -1),
                                                              self.feat_agg_conv)))
        rgb = conv_same(self.align_2(self.align_1(nbr, agg)), self.to_rgb)
        rgb = rgb.reshape(b, t - 1, h, w, 3)
        aligned = torch.cat([rgb[:, :center], lrs[:, center, None], rgb[:, center:]], dim=1)
        aligned_lrs = aligned.permute(0, 2, 3, 1, 4).reshape(b, h, w, 3 * t)

        y = self.reconstruct(aligned_lrs)
        y = self.upsample2(self.upsample1(y))
        return conv_same(y, self.conv_out), aligned
