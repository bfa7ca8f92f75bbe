"""SPyNet optical flow (counterpart of pnp_vcve_tpu/models/spynet.py;
reference basicvsr_net.py:561-756).

A 6-level spatial pyramid: at each level a 5-conv module refines the x2
upsampled coarser flow from [ref, supp warped by it, flow]. The frames are
resized to a multiple of 32 first (``ops/resize.py: resize_bilinear``) and
the flow is resized back and rescaled; each coarser flow is upsampled with
``resize_bilinear_align_corners`` and doubled. The warp of ``supp`` pads
with the border pixel: the plain ``ops/warp.py: flow_warp``, as JAX runs it
in XLA (no kernel computes border padding).

Layout NHWC; flows ``(b, h, w, 2)`` in pixels, (dx, dy). Parameters carry
the reference's names, ``basic_module.{i}.basic_module.{j}.conv.{weight,
bias}``, so a reference state dict loads directly; the reference's
``mean`` / ``std`` buffers are constants here (core/checkpoint.py drops
them on loading).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.resize import resize_bilinear, resize_bilinear_align_corners
from pnp_vcve_torch.ops.warp import flow_warp
from .init import torch_default_

__all__ = ["SPyNet", "SPyNetBasicModule"]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class _ConvModule(nn.Module):
    """mmcv ``ConvModule``'s parameters: ``conv.{weight,bias}``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 7, 1, 3)


class SPyNetBasicModule(nn.Module):
    """[ref (3), warped supp (3), flow (2)] -> flow residual (2): 7x7 convs
    8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU between."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16, 2)
        self.basic_module = nn.Sequential(*[_ConvModule(a, b)
                                            for a, b in zip(chans[:-1], chans[1:])])

    def forward(self, x):
        last = len(self.basic_module) - 1
        for j, m in enumerate(self.basic_module):
            x = conv_same(x, m.conv)
            if j < last:
                x = F.relu(x)
        return x


class SPyNet(nn.Module):
    """Flow from ``ref`` to ``supp``, both ``(b, h, w, 3)`` in [0, 1]."""

    def __init__(self, levels: int = 6):
        super().__init__()
        self.levels = levels
        self.basic_module = nn.ModuleList([SPyNetBasicModule() for _ in range(levels)])

    def reset_parameters(self, generator: torch.Generator):
        for m in self.basic_module:
            for c in m.basic_module:
                torch_default_(c.conv, generator)

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = ref.shape
        h_up, w_up = -(-h // 32) * 32, -(-w // 32) * 32
        mean = torch.tensor(_MEAN, dtype=ref.dtype, device=ref.device)
        std = torch.tensor(_STD, dtype=ref.dtype, device=ref.device)
        refs = [(resize_bilinear(ref, (h_up, w_up)) - mean) / std]
        supps = [(resize_bilinear(supp, (h_up, w_up)) - mean) / std]
        pool = lambda x: F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)  # noqa: E731
        for _ in range(self.levels - 1):
            refs.append(pool(refs[-1]))
            supps.append(pool(supps[-1]))
        refs, supps = refs[::-1], supps[::-1]

        flow = torch.zeros_like(refs[0][..., :2])
        for level in range(self.levels):
            if level == 0:
                flow_up = flow
            else:
                flow_up = resize_bilinear_align_corners(flow, refs[level].shape[1:3]) * 2.0
            warped = flow_warp(supps[level], flow_up, padding_mode="border")
            flow = flow_up + self.basic_module[level](
                torch.cat([refs[level], warped, flow_up], dim=-1))

        flow = resize_bilinear(flow, (h, w))
        return flow * torch.tensor([w / w_up, h / h_up], dtype=flow.dtype, device=flow.device)
