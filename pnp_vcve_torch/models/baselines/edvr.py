"""EDVR: pyramid cascading deformable (PCD) alignment and temporal-spatial
attention (TSA) fusion (counterpart of pnp_vcve_tpu/models/baselines/edvr.py;
reference sr_backbones/edvr_net.py:15-470), and EDVR-M up to its fused
features, the information-refill extractor of IconVSR (reference
iconvsr.py:528-653).

A residual-block feature extractor and two stride-2 convs make a 3-level
pyramid of every frame; PCD aligns each frame's pyramid to the centre
frame's with modulated deformable convs whose offsets and masks come from a
separate feature (``ModulatedDCNPack``), coarse to fine, then once more at
level 1; TSA weights each aligned frame by its correlation with the centre
frame and gates the fused feature with a two-level spatial attention. EDVR
reconstructs with residual blocks, two x2 pixel shuffles, ``conv_hr`` and
``conv_last``, plus the centre frame upsampled bilinearly x4.

JAX's arithmetic is kept: the DCN reads ``cat(o1, o2)`` of its offset head
as ``(b, h, w, groups, 9, (dy, dx))`` and the sigmoid of the last third as
the mask (edvr.py:44-46); the stride-2 convs pad as XLA's 'SAME'
(``ops/conv.py``); PCD upsamples the coarser offsets and features with
``ops/resize.py: resize_bilinear`` (the offsets x2); TSA's pools are 3x3
stride 2 with one pixel of padding, max over -inf padding and mean over the
pixels inside only. Frame sides must be multiples of 4 (two halvings):
JAX fails on other sides, the port refuses them with a message. PCD runs
every frame of the window as one batch.

Everything is plain PyTorch, as JAX computes it in XLA: the DCN is
``ops/deform_conv.py``, the convolutions cuDNN's; no TPU kernel is on this
path. Parameter names follow the JAX module tree in PyTorch's forms
(``feat_extract.main.*``, ``pcd_alignment.dcn_pack_l1.{weight, bias,
conv_offset.*}``, ``fusion.temporal_attn1``, ``upsample1.upsample_conv``,
...; ``core/convert.py: edvr_state_dict``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d
from pnp_vcve_torch.ops.resize import resize_bilinear
from pnp_vcve_torch.ops.upsample import bilinear_resize
from ..bae import hwio
from ..init import torch_default_
from ..pnp_vcve import PixelShufflePack
from .basicvsr_pp import ResidualBlocksWithInputConv

__all__ = ["ModulatedDCNPack", "PCDAlignment", "TSAFusion", "EDVRNet", "EDVRFeatureExtractor"]


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _nchw(fn, x):
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _maxpool(x):
    return _nchw(lambda y: F.max_pool2d(y, 3, 2, 1), x)


def _avgpool(x):
    return _nchw(lambda y: F.avg_pool2d(y, 3, 2, 1, count_include_pad=False), x)


class ModulatedDCNPack(nn.Module):
    """A 3x3 modulated DCN whose offsets and masks a conv regresses from a
    separate feature (edvr_net.py:15-59). The offset head starts at zero."""

    def __init__(self, in_channels: int, channels: int, deform_groups: int = 8,
                 extra_channels: int | None = None):
        super().__init__()
        self.deform_groups = deform_groups
        self.weight = nn.Parameter(torch.empty(channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(channels))
        self.conv_offset = nn.Conv2d(extra_channels or in_channels, 27 * deform_groups, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator):
        torch_default_(self, generator)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def forward(self, x, extra_feat):
        b, h, w, _ = x.shape
        g = self.deform_groups
        o1, o2, mask = conv_same(extra_feat, self.conv_offset).chunk(3, dim=-1)
        offsets = torch.cat([o1, o2], dim=-1).reshape(b, h, w, g, 9, 2)
        mask = torch.sigmoid(mask).reshape(b, h, w, g, 9)
        return modulated_deform_conv2d(x, offsets, mask, hwio(self.weight), self.bias)


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, 1, k // 2)


class PCDAlignment(nn.Module):
    """3-level pyramid cascading deformable alignment (edvr_net.py:61-188):
    ``neighbor``, ``ref`` lists of the three levels' ``(n, h, w, c)`` maps."""

    def __init__(self, mid_channels: int = 64, deform_groups: int = 8):
        super().__init__()
        c = mid_channels
        for i in (3, 2, 1):
            setattr(self, f"offset_conv1_l{i}", _conv(2 * c, c))
            setattr(self, f"offset_conv2_l{i}", _conv(c if i == 3 else 2 * c, c))
            if i < 3:
                setattr(self, f"offset_conv3_l{i}", _conv(c, c))
                setattr(self, f"feat_conv_l{i}", _conv(2 * c, c))
            setattr(self, f"dcn_pack_l{i}", ModulatedDCNPack(c, c, deform_groups))
        self.cas_offset_conv1 = _conv(2 * c, c)
        self.cas_offset_conv2 = _conv(c, c)
        self.cas_dcnpack = ModulatedDCNPack(c, c, deform_groups)

    def _c(self, name, *xs):
        return conv_same(torch.cat(xs, -1) if len(xs) > 1 else xs[0], getattr(self, name))

    def forward(self, neighbor, ref):
        up_offset = up_feat = feat = None
        for i in (3, 2, 1):
            offset = _lrelu(self._c(f"offset_conv1_l{i}", neighbor[i - 1], ref[i - 1]))
            if i == 3:
                offset = _lrelu(self._c(f"offset_conv2_l{i}", offset))
            else:
                offset = _lrelu(self._c(f"offset_conv2_l{i}", offset, up_offset))
                offset = _lrelu(self._c(f"offset_conv3_l{i}", offset))
            feat = getattr(self, f"dcn_pack_l{i}")(neighbor[i - 1], offset)
            if i == 3:
                feat = _lrelu(feat)
            else:
                feat = self._c(f"feat_conv_l{i}", feat, up_feat)
                if i == 2:
                    feat = _lrelu(feat)
            if i > 1:
                size = (2 * offset.shape[1], 2 * offset.shape[2])
                up_offset = resize_bilinear(offset, size) * 2.0
                up_feat = resize_bilinear(feat, size)
        offset = _lrelu(self._c("cas_offset_conv1", feat, ref[0]))
        offset = _lrelu(self._c("cas_offset_conv2", offset))
        return _lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    """Temporal-spatial attention fusion (edvr_net.py:190-298) of ``aligned
    (b, t, h, w, c)`` -> ``(b, h, w, c)``."""

    _CONVS = (("temporal_attn1", 1, 3), ("temporal_attn2", 1, 3), ("feat_fusion", "t", 1),
              ("spatial_attn1", "t", 1), ("spatial_attn2", 2, 1), ("spatial_attn_l1", 1, 1),
              ("spatial_attn_l2", 2, 3), ("spatial_attn_l3", 1, 3), ("spatial_attn3", 1, 3),
              ("spatial_attn4", 1, 1), ("spatial_attn5", 1, 3), ("spatial_attn_add1", 1, 1),
              ("spatial_attn_add2", 1, 1))

    def __init__(self, mid_channels: int = 64, num_frames: int = 5, center_frame_idx: int = 2):
        super().__init__()
        c = mid_channels
        self.center_frame_idx = center_frame_idx
        for name, mult, k in self._CONVS:
            setattr(self, name, _conv((num_frames if mult == "t" else mult) * c, c, k))

    def _c(self, name, x):
        return conv_same(x, getattr(self, name))

    def forward(self, aligned):
        b, t, h, w, c = aligned.shape
        emb_ref = self._c("temporal_attn1", aligned[:, self.center_frame_idx])
        emb = self._c("temporal_attn2", aligned.reshape(b * t, h, w, c)).reshape(b, t, h, w, c)
        corr = (emb * emb_ref[:, None]).sum(-1)
        prob = torch.sigmoid(corr)[..., None]
        gated = (aligned * prob).permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)

        feat = _lrelu(self._c("feat_fusion", gated))
        attn = _lrelu(self._c("spatial_attn1", gated))
        attn = _lrelu(self._c("spatial_attn2", torch.cat([_maxpool(attn), _avgpool(attn)], -1)))
        level = _lrelu(self._c("spatial_attn_l1", attn))
        level = _lrelu(self._c("spatial_attn_l2",
                               torch.cat([_maxpool(level), _avgpool(level)], -1)))
        level = _lrelu(self._c("spatial_attn_l3", level))
        level = resize_bilinear(level, attn.shape[1:3])
        attn = _lrelu(self._c("spatial_attn3", attn)) + level
        attn = _lrelu(self._c("spatial_attn4", attn))
        attn = self._c("spatial_attn5", resize_bilinear(attn, (h, w)))
        attn_add = self._c("spatial_attn_add2", _lrelu(self._c("spatial_attn_add1", attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class _EDVRTrunk(nn.Module):
    """The feature pyramid, PCD to the centre frame and TSA: ``lrs (b, t,
    h, w, 3)`` -> fused ``(b, h, w, c)``."""

    def __init__(self, mid_channels: int, num_frames: int, deform_groups: int,
                 num_blocks_extraction: int):
        super().__init__()
        c = mid_channels
        self.mid_channels, self.num_frames = c, num_frames
        self.feat_extract = ResidualBlocksWithInputConv(3, c, num_blocks_extraction)
        for name in ("feat_l2_conv1", "feat_l2_conv2", "feat_l3_conv1", "feat_l3_conv2"):
            setattr(self, name, _conv(c, c))
        self.pcd_alignment = PCDAlignment(c, deform_groups)
        self.fusion = TSAFusion(c, num_frames, num_frames // 2)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            if isinstance(m, nn.Conv2d):
                torch_default_(m, generator)
        self.feat_extract.reset_parameters(generator)
        for m in self.pcd_alignment.children():
            if isinstance(m, ModulatedDCNPack):
                m.reset_parameters(generator)
            else:
                torch_default_(m, generator)
        for m in self.fusion.children():
            torch_default_(m, generator)

    def _fused(self, lrs):
        b, t, h, w, c_in = lrs.shape
        if h % 4 or w % 4:
            raise ValueError(f"EDVR needs frame sides that are multiples of 4, got {h}x{w}")
        if t != self.num_frames:
            raise ValueError(f"EDVR takes windows of {self.num_frames} frames, got {t}")
        c, center = self.mid_channels, self.num_frames // 2
        l1 = self.feat_extract(lrs.reshape(b * t, h, w, c_in))
        l2 = _lrelu(conv_same(l1, self.feat_l2_conv1, 2))
        l2 = _lrelu(conv_same(l2, self.feat_l2_conv2))
        l3 = _lrelu(conv_same(l2, self.feat_l3_conv1, 2))
        l3 = _lrelu(conv_same(l3, self.feat_l3_conv2))
        pyramid = [lv.reshape(b, t, *lv.shape[1:]) for lv in (l1, l2, l3)]
        # every frame of the window in one batch, each against the centre
        neighbor = [lv.reshape(b * t, *lv.shape[2:]) for lv in pyramid]
        ref = [lv[:, center, None].expand(-1, t, -1, -1, -1).reshape(b * t, *lv.shape[2:])
               for lv in pyramid]
        aligned = self.pcd_alignment(neighbor, ref).reshape(b, t, h, w, c)
        return self.fusion(aligned)


class EDVRNet(_EDVRTrunk):
    """EDVR x4 VSR (edvr_net.py:300-470): a window of ``num_frames`` frames
    -> the centre frame at x4, ``(b, 4h, 4w, 3)``."""

    def __init__(self, mid_channels: int = 64, num_frames: int = 5, deform_groups: int = 8,
                 num_blocks_extraction: int = 5, num_blocks_reconstruction: int = 10):
        super().__init__(mid_channels, num_frames, deform_groups, num_blocks_extraction)
        c = mid_channels
        self.reconstruction = ResidualBlocksWithInputConv(c, c, num_blocks_reconstruction)
        self.upsample1 = PixelShufflePack(c, 2)
        self.upsample2 = PixelShufflePack(c, 2, out_channels=64)
        self.conv_hr = _conv(64, 64)
        self.conv_last = _conv(64, 3)

    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        self.reconstruction.reset_parameters(generator)
        for up in (self.upsample1, self.upsample2):
            torch_default_(up.upsample_conv, generator)

    def forward(self, lrs, **_ignored):
        out = self.reconstruction(self._fused(lrs))
        out = _lrelu(self.upsample1(out))
        out = _lrelu(self.upsample2(out))
        out = _lrelu(conv_same(out, self.conv_hr))
        out = conv_same(out, self.conv_last)
        return out + bilinear_resize(lrs[:, self.num_frames // 2], 4)


class EDVRFeatureExtractor(_EDVRTrunk):
    """EDVR-M up to the fused features (iconvsr.py:528-653): a window of
    ``num_frames`` frames -> ``(b, h, w, c)``."""

    def __init__(self, mid_channels: int = 64, num_frames: int = 5, deform_groups: int = 8,
                 num_blocks_extraction: int = 5):
        super().__init__(mid_channels, num_frames, deform_groups, num_blocks_extraction)

    def forward(self, lrs):
        return self._fused(lrs)
