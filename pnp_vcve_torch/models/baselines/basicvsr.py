"""BasicVSR and IconVSR (counterpart of pnp_vcve_tpu/models/baselines/
basicvsr.py; reference sr_backbones/basicvsr_net.py:15-175 and iconvsr.py:
15-341), the bidirectional recurrent x4 VSR models the flagship descends
from.

SPyNet flows between neighbouring frames, both ways; a backward sweep over
the frames in reverse and then a forward sweep, each step warping the
carried feature to the current frame by the flow and running residual
blocks over [the current frame, the warped feature] (the forward sweep
also takes the backward sweep's feature of the frame: ``[bwd, lr, warped]``
in BasicVSR, ``[lr, bwd, warped]`` in IconVSR); then per frame two x2
pixel shuffles, ``conv_hr`` and ``conv_last`` (BasicVSR first fuses both
sweeps with a 1x1 conv), plus the frame upsampled bilinearly x4.

IconVSR refills the propagated feature at keyframes (every
``keyframe_stride`` frames and the last frame): a 3x3 conv fuses it with
the EDVR-M features (``edvr.py: EDVRFeatureExtractor``) of the window of
``2 * padding + 1`` frames around the keyframe, the clip mirrored at its
ends as JAX mirrors it (frames 4, 3 before and -4, -5 after at padding 2;
6, 5, 4 and -5, -6, -7 at padding 3). JAX gathers those frames with
clamped indices, so a clip shorter than 5 (7) frames repeats its end
frames instead of failing; the port computes the same indices. The fusion
runs at keyframes only: JAX runs it every step and selects, with the same
result.

Step 0 of a sweep has no neighbour: JAX warps the zero carry and zeroes
the result (``where(i == 0, 0, warped)``); the port starts from zeros and
warps from step 1. So a clip of t frames warps its feature 2 (t - 1)
times, each through ``self.ops.flow_warp``: K1 on the card, its plain
version on the CPU, as BasicVSR++'s feature warps. SPyNet's border warp,
the convolutions (cuDNN), the DCN of the refill, the pixel shuffles and the
resizes are plain PyTorch, as JAX computes them in XLA.

Layout NHWC: ``lrs (b, t, h, w, 3)`` in [0, 1] -> ``(b, t, 4h, 4w, 3)``.
Parameter names follow the JAX module tree in PyTorch's forms, each sweep's
scan collapsed into ``{backward, forward}_resblocks.main.*`` (and IconVSR's
``{backward, forward}_fusion``), SPyNet under the reference's names
(``core/convert.py: basicvsr_state_dict``, ``iconvsr_state_dict``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.kernels import KERNELS
from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.upsample import bilinear_resize
from ..init import torch_default_
from ..pnp_vcve import PixelShufflePack
from ..spynet import SPyNet
from .basicvsr_pp import ResidualBlocksWithInputConv
from .edvr import EDVRFeatureExtractor

__all__ = ["BasicVSRNet", "IconVSRNet", "mirror_indices"]

# the mirrored end frames of IconVSR's refill windows (JAX basicvsr.py:177-184)
_MIRROR = {2: ((4, 3), (-4, -5)), 3: ((6, 5, 4), (-5, -6, -7))}


def mirror_indices(t: int, padding: int) -> list[int]:
    """Frame indices of the mirrored clip ``[front, 0..t-1, back]`` of
    IconVSR's refill: negative indices wrapped once and every index clamped
    to ``[0, t - 1]``, as JAX's gather does."""
    if padding not in _MIRROR:
        raise ValueError(f"padding must be 2 or 3, got {padding}")
    front, back = _MIRROR[padding]

    def clamp(i):
        i = i + t if i < 0 else i
        return min(max(i, 0), t - 1)
    return [clamp(i) for i in front] + list(range(t)) + [clamp(i) for i in back]


class _Recurrent(nn.Module):
    """SPyNet, the two sweeps' residual blocks and the x4 head."""

    def __init__(self, mid_channels: int, num_blocks: int, forward_extra: int):
        super().__init__()
        c = mid_channels
        self.mid_channels = c
        self.spynet = SPyNet()
        self.backward_resblocks = ResidualBlocksWithInputConv(c + 3, c, num_blocks)
        self.forward_resblocks = ResidualBlocksWithInputConv(c + 3 + forward_extra, c,
                                                             num_blocks)
        self.upsample1 = PixelShufflePack(c, 2)
        self.upsample2 = PixelShufflePack(c, 2, out_channels=64)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        # the c-channel feature warps (kernels.KERNELS or PLAIN)
        self.ops = KERNELS

    def reset_parameters(self, generator: torch.Generator):
        self.spynet.reset_parameters(generator)
        self.backward_resblocks.reset_parameters(generator)
        self.forward_resblocks.reset_parameters(generator)
        for conv in (self.upsample1.upsample_conv, self.upsample2.upsample_conv, self.conv_hr,
                     self.conv_last):
            torch_default_(conv, generator)

    def _warp(self, feat, flow):
        """A feature warp: K1 on the card."""
        return self.ops.flow_warp(feat.contiguous(), flow.contiguous())

    def _flows(self, lrs):
        """``(backward, forward)`` flows ``(b, t - 1, h, w, 2)``: backward[i]
        from frame i to i + 1, forward[i] from i + 1 to i."""
        b, t, h, w, c = lrs.shape
        prev = lrs[:, :-1].reshape(b * (t - 1), h, w, c)
        nxt = lrs[:, 1:].reshape(b * (t - 1), h, w, c)
        return (self.spynet(prev, nxt).reshape(b, t - 1, h, w, 2),
                self.spynet(nxt, prev).reshape(b, t - 1, h, w, 2))

    def _sweep(self, lrs, order, flow_of, step):
        """The carry over frames ``order``: at each frame, the carry warped by
        ``flow_of(j)`` (zeros at the first), then ``step(j, warped)``.
        Returns the features by frame."""
        b, _, h, w, _ = lrs.shape
        carry = None
        out = {}
        for j in order:
            if carry is None:
                warped = lrs.new_zeros((b, h, w, self.mid_channels))
            else:
                warped = self._warp(carry, flow_of(j))
            carry = out[j] = step(j, warped)
        return out

    def _head(self, feat, lr):
        """One frame's ``(b, h, w, c)`` feature -> ``(b, 4h, 4w, 3)``."""
        y = F.leaky_relu(self.upsample1(feat), 0.1)
        y = F.leaky_relu(self.upsample2(y), 0.1)
        y = F.leaky_relu(conv_same(y, self.conv_hr), 0.1)
        return conv_same(y, self.conv_last) + bilinear_resize(lr, 4)


class BasicVSRNet(_Recurrent):
    """Bidirectional SPyNet propagation + x4 upsampling (basicvsr_net.py:
    15-175)."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 30):
        super().__init__(mid_channels, num_blocks, mid_channels)
        self.fusion = nn.Conv2d(2 * mid_channels, mid_channels, 1)

    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        torch_default_(self.fusion, generator)

    def forward(self, lrs, **_ignored):
        t = lrs.shape[1]
        flows_backward, flows_forward = self._flows(lrs)
        bwd = self._sweep(lrs, range(t - 1, -1, -1), lambda j: flows_backward[:, j],
                          lambda j, warped: self.backward_resblocks(
                              torch.cat([lrs[:, j], warped], -1)))
        fwd = self._sweep(lrs, range(t), lambda i: flows_forward[:, i - 1],
                          lambda i, warped: self.forward_resblocks(
                              torch.cat([bwd[i], lrs[:, i], warped], -1)))
        outs = []
        for i in range(t):  # the head a frame at a time (its convs are per frame)
            feat = F.leaky_relu(conv_same(torch.cat([bwd[i], fwd[i]], -1), self.fusion), 0.1)
            outs.append(self._head(feat, lrs[:, i]))
        return torch.stack(outs, dim=1)


class IconVSRNet(_Recurrent):
    """IconVSR with EDVR-M information refill (iconvsr.py:15-265)."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 30, keyframe_stride: int = 5,
                 padding: int = 2):
        mirror_indices(1, padding)  # refuses a padding JAX refuses
        super().__init__(mid_channels, num_blocks, mid_channels)
        c = mid_channels
        self.keyframe_stride, self.padding = keyframe_stride, padding
        self.edvr = EDVRFeatureExtractor(c, 2 * padding + 1)
        self.backward_fusion = nn.Conv2d(2 * c, c, 3, 1, 1)
        self.forward_fusion = nn.Conv2d(2 * c, c, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator):
        super().reset_parameters(generator)
        self.edvr.reset_parameters(generator)
        torch_default_(self.backward_fusion, generator)
        torch_default_(self.forward_fusion, generator)

    def keyframes(self, t: int) -> list[int]:
        """Every ``keyframe_stride``-th frame and the last."""
        keys = list(range(0, t, self.keyframe_stride))
        return keys if keys[-1] == t - 1 else keys + [t - 1]

    def forward(self, lrs, **_ignored):
        b, t, h, w, c = lrs.shape
        keys = self.keyframes(t)
        nf = 2 * self.padding + 1
        padded = lrs[:, mirror_indices(t, self.padding)]
        windows = torch.stack([padded[:, i:i + nf] for i in keys], dim=1)
        feats = self.edvr(windows.reshape(b * len(keys), nf, h, w, c))
        refill = dict(zip(keys, feats.reshape(b, len(keys), h, w, -1).unbind(1)))

        def fused(fusion, j, warped):
            if j not in refill:
                return warped
            return conv_same(torch.cat([warped, refill[j]], -1), fusion)

        flows_backward, flows_forward = self._flows(lrs)
        bwd = self._sweep(lrs, range(t - 1, -1, -1), lambda j: flows_backward[:, j],
                          lambda j, warped: self.backward_resblocks(torch.cat(
                              [lrs[:, j], fused(self.backward_fusion, j, warped)], -1)))
        fwd = self._sweep(lrs, range(t), lambda i: flows_forward[:, i - 1],
                          lambda i, warped: self.forward_resblocks(torch.cat(
                              [lrs[:, i], bwd[i], fused(self.forward_fusion, i, warped)], -1)))
        return torch.stack([self._head(fwd[i], lrs[:, i]) for i in range(t)], dim=1)
