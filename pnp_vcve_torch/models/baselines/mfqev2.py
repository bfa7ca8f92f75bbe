"""MFQEv2 and the MFQE two-model joint protocol (counterpart of
pnp_vcve_tpu/models/baselines/mfqev2.py; reference sr_backbones/
mfqev2.py:12-179, restorers/mfqev2_restorer.py).

SPyNet aligns the left and right peak-quality frames (PQFs) to the centre
frame (a bilinear, zeros-padded warp of the 3-channel frames: the plain
``ops/warp.py: flow_warp``), 3x3 / 5x5 / 7x7 conv banks read the three
frames, five conv + PReLU + BatchNorm blocks each read every earlier
block's output, ``rec5`` maps to 3 channels and the centre frame is added.
BatchNorm runs on its running statistics, the test-time form
(``use_running_average=not train`` in JAX); training this model waits for
ROADMAP Queue A item 8. Everything is plain PyTorch, as JAX computes it in
XLA: no TPU kernel is on this path.

Parameter names: ``spynet.*`` under the reference's names; the rest follow
the JAX package's module tree in PyTorch's form (``ks{3,5,7}_conv{0,1,2}``,
``rec{0..4}.{conv,prelu,bn}``, ``rec5``), since no reference MFQEv2 state
dict is in the repository (ROADMAP Queue C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.data.ldp import PQF_SLICES, find_left_right_pqf
from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.warp import flow_warp
from ..init import torch_default_
from ..spynet import SPyNet

__all__ = ["MFQEv2", "mfqe_joint_enhance"]

_KS = (3, 5, 7)


class _RecBlock(nn.Module):
    """conv + PReLU + BatchNorm (reference rec_conv entries c10-c14)."""

    def __init__(self, cin: int, nf: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, nf, 3, 1, 1)
        self.prelu = nn.PReLU()
        self.bn = nn.BatchNorm2d(nf)

    def reset_parameters(self, generator: torch.Generator):
        torch_default_(self.conv, generator)
        with torch.no_grad():
            self.prelu.weight.fill_(0.25)
        self.bn.reset_parameters()

    def forward(self, x):
        y = conv_same(x, self.conv)
        y = torch.where(y >= 0, y, self.prelu.weight * y)
        bn = self.bn
        return (y - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps) * bn.weight + bn.bias


class MFQEv2(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, nf: int = 32):
        super().__init__()
        self.spynet = SPyNet()
        for ks in _KS:
            for j in range(3):
                setattr(self, f"ks{ks}_conv{j}", nn.Conv2d(in_channels, nf, ks, 1, ks // 2))
        self.rec0 = _RecBlock(9 * nf, nf)
        for i in range(1, 5):
            setattr(self, f"rec{i}", _RecBlock(i * nf, nf))
        self.rec5 = nn.Conv2d(nf, out_channels, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator):
        """PyTorch's default init for the convs and PReLU (0.25), BatchNorm's
        unit scale and zero shift on zero mean and unit variance."""
        self.spynet.reset_parameters(generator)
        for ks in _KS:
            for j in range(3):
                torch_default_(getattr(self, f"ks{ks}_conv{j}"), generator)
        for i in range(5):
            getattr(self, f"rec{i}").reset_parameters(generator)
        torch_default_(self.rec5, generator)

    def forward(self, lrs: torch.Tensor, **_ignored) -> torch.Tensor:
        """``lrs (b, 3, h, w, c)`` = [left PQF, centre, right PQF] ->
        ``(b, h, w, c)``."""
        center = lrs[:, 1]

        def align(frame):
            return flow_warp(frame, self.spynet(center, frame))

        frames = (align(lrs[:, 0]), center, align(lrs[:, 2]))
        feat = torch.cat([conv_same(f, getattr(self, f"ks{ks}_conv{j}"))
                          for ks in _KS for j, f in enumerate(frames)], dim=-1)
        outs = [self.rec0(feat)]
        for i in range(1, 4):
            outs.append(getattr(self, f"rec{i}")(torch.cat(outs, -1)))
        out = self.rec4(torch.cat(outs, -1))
        return conv_same(out, self.rec5) + center


def mfqe_joint_enhance(pqf_apply, nonpqf_apply, frames, slice_types):
    """The MFQE two-model test protocol: pass 1 enhances every PQF with the
    PQF model from the decoded frames (neighbours: the nearest other PQFs),
    pass 2 each non-PQF with the non-PQF model against the nearest enhanced
    PQFs.

    ``pqf_apply`` / ``nonpqf_apply``: ``(1, 3, h, w, c)`` numpy ->
    ``(1, h, w, c)``; ``frames (t, h, w, c)`` the decoded clip in [0, 1];
    ``slice_types`` t letters 'I' / 'P' / 'B'. Returns ``(t, h, w, c)``
    float32 numpy."""
    t = frames.shape[0]
    is_pqf = [slice_types[i] in PQF_SLICES for i in range(t)]
    out = np.array(frames, np.float32, copy=True)

    def triple(apply, i, left, right, source):
        return np.asarray(apply(np.stack([source[left], source[i], source[right]])[None])[0])

    enhanced = {}
    for i in range(t):
        if not is_pqf[i]:
            continue
        left = i - 1
        while left >= 0 and not is_pqf[left]:
            left -= 1
        right = i + 1
        while right < t and not is_pqf[right]:
            right += 1
        left = i if left < 0 else left
        right = i if right >= t else right
        enhanced[i] = triple(pqf_apply, i, left, right, frames)
    for i, v in enhanced.items():
        out[i] = v
    for i in range(t):
        if not is_pqf[i]:
            left, right = find_left_right_pqf(lambda k: slice_types[k], i, t, compressed=True)
            out[i] = triple(nonpqf_apply, i, left, right, out)
    return out
