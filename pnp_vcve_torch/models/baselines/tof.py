"""TOFlow and RealBasicVSR (counterpart of pnp_vcve_tpu/models/baselines/
tof.py; reference sr_backbones/tof.py:144-252 and real_basicvsr_net.py:
13-110).

- TOFlow: a 7-frame window (already at the output size, as the reference
  feeds it bicubically upsampled frames), ImageNet-normalised; a 4-level
  SPyNet aligns the six other frames to the reference frame, then 9x9,
  9x9, 1x1 and 1x1 convs with ReLUs reconstruct the reference frame's
  residual. ``adapt_official_weights`` reorders the window so the
  reference frame comes first. SPyNet normalises its inputs once more (they
  already are): JAX does so, and so does the port. The six flows and the
  six warps each run as one batch. Its image warps are 3 channels wide, so
  they are the plain ``ops/warp.py: flow_warp`` (K1 takes widths that are
  multiples of 8), as JAX computes them in XLA.
- RealBasicVSR: one pass of an image-cleaning residual module (a conv,
  ``num_cleaning_blocks`` residual blocks, a conv back to RGB, plus the
  frame), then BasicVSR (``basicvsr.py``, its feature warps on K1). The
  reference repeats the cleaning while the mean residual is at least
  ``dynamic_refine_thres`` (at most three passes); JAX runs one pass, and
  so does the port. ``dynamic_refine_thres``, ``is_fix_cleaning`` and
  ``is_sequential_cleaning`` are accepted and unused, as in JAX.

Layout NHWC, [0, 1] frames. Parameter names follow the JAX module tree in
PyTorch's forms (``conv1``..``conv4``, ``clean_in``, ``clean{i}_conv{1,2}``,
``clean_out``, ``basicvsr.*``), SPyNet under the reference's names
(``core/convert.py: toflow_state_dict``, ``realbasicvsr_state_dict``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.warp import flow_warp
from ..init import torch_default_
from ..spynet import SPyNet
from .basicvsr import BasicVSRNet

__all__ = ["TOFlow", "RealBasicVSRNet"]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class TOFlow(nn.Module):
    """``lrs (b, 7, h, w, 3)`` -> the reference frame restored, ``(b, h, w,
    3)``."""

    def __init__(self, adapt_official_weights: bool = False):
        super().__init__()
        self.adapt_official_weights = adapt_official_weights
        self.spynet = SPyNet(levels=4)
        self.conv1 = nn.Conv2d(21, 64, 9, 1, 4)
        self.conv2 = nn.Conv2d(64, 64, 9, 1, 4)
        self.conv3 = nn.Conv2d(64, 64, 1)
        self.conv4 = nn.Conv2d(64, 3, 1)

    def reset_parameters(self, generator: torch.Generator):
        self.spynet.reset_parameters(generator)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            torch_default_(conv, generator)

    def forward(self, lrs):
        b, t, h, w, c = lrs.shape
        if t != 7:
            raise ValueError(f"TOFlow takes windows of 7 frames, got {t}")
        if self.adapt_official_weights:
            lrs = lrs[:, [3, 0, 1, 2, 4, 5, 6]]
            ref_idx = 0
        else:
            ref_idx = 3
        mean = torch.tensor(_MEAN, dtype=lrs.dtype, device=lrs.device)
        std = torch.tensor(_STD, dtype=lrs.dtype, device=lrs.device)
        lrs = (lrs - mean) / std
        ref = lrs[:, ref_idx]
        others = [i for i in range(7) if i != ref_idx]
        supp = lrs[:, others].reshape(b * 6, h, w, c)
        refs = ref[:, None].expand(-1, 6, -1, -1, -1).reshape(supp.shape)
        warped = flow_warp(supp, self.spynet(refs, supp)).reshape(b, 6, h, w, c)
        aligned = torch.cat([warped[:, :ref_idx], ref[:, None], warped[:, ref_idx:]], dim=1)
        hr = aligned.permute(0, 2, 3, 1, 4).reshape(b, h, w, 7 * c)
        hr = F.relu(conv_same(hr, self.conv1))
        hr = F.relu(conv_same(hr, self.conv2))
        hr = F.relu(conv_same(hr, self.conv3))
        hr = conv_same(hr, self.conv4) + ref
        return hr * std + mean


class RealBasicVSRNet(nn.Module):
    """``lqs (b, t, h, w, 3)`` -> ``(b, t, 4h, 4w, 3)`` (and the cleaned
    frames with ``return_lqs``)."""

    def __init__(self, mid_channels: int = 64, num_propagation_blocks: int = 20,
                 num_cleaning_blocks: int = 20, dynamic_refine_thres: float = 255.0,
                 is_fix_cleaning: bool = False, is_sequential_cleaning: bool = False):
        super().__init__()
        c = mid_channels
        self.num_cleaning_blocks = num_cleaning_blocks
        self.clean_in = nn.Conv2d(3, c, 3, 1, 1)
        for i in range(num_cleaning_blocks):
            setattr(self, f"clean{i}_conv1", nn.Conv2d(c, c, 3, 1, 1))
            setattr(self, f"clean{i}_conv2", nn.Conv2d(c, c, 3, 1, 1))
        self.clean_out = nn.Conv2d(c, 3, 3, 1, 1)
        self.basicvsr = BasicVSRNet(c, num_propagation_blocks)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.children():
            if isinstance(m, nn.Conv2d):
                torch_default_(m, generator)
        self.basicvsr.reset_parameters(generator)

    def clean(self, lqs):
        """One pass of the cleaning module."""
        b, t, h, w, c = lqs.shape
        x = lqs.reshape(b * t, h, w, c)
        feat = F.leaky_relu(conv_same(x, self.clean_in), 0.1)
        for i in range(self.num_cleaning_blocks):
            y = F.relu(conv_same(feat, getattr(self, f"clean{i}_conv1")))
            feat = feat + conv_same(y, getattr(self, f"clean{i}_conv2"))
        return (x + conv_same(feat, self.clean_out)).reshape(b, t, h, w, c)

    def forward(self, lqs, return_lqs: bool = False):
        lqs = self.clean(lqs)
        out = self.basicvsr(lqs)
        return (out, lqs) if return_lqs else out
