"""SIDECVSR: x4 VSR of the Y channel with codec side information
(counterpart of pnp_vcve_tpu/models/baselines/sidecvsr.py; reference
plug_and_play/SIDECVSR_J_fast.py:70-431).

Seven frames; SFT residual blocks embed the side maps (residual, partition,
unfiltered) into each frame's features; an MV-guided local attention aligns
each neighbour: its 3x3 patches (9c channels) are warped by ``mv * 32`` px
with border padding (``ops/warp.py: flow_warp``, bilinear, the plain form:
K1 computes zero padding only, and JAX runs this warp in XLA) and fused
with 9 softmax weights predicted from them and the centre's patches. A
3-level feature pyramid is fused per level and reconstructed by SCNet
(multi-scale groups exchanging up and down), then pixel-shuffled to x4 and
added to the bilinear x4 centre frame. ``pre_l1_fea`` (the previous
window's frame features) makes a sliding window extract only its newest
frame (SIDECVSR_J_fast.py:121-136).

Parameter names follow the JAX module tree in PyTorch's forms
(``side_to_fea{i}``, ``conv_first``, ``RB_wSide_{i}.{sft0,conv0,sft1,
conv1}``, ``mv_patch_attn.kpred{0,1}``, ``tmp_fea_attn.tAtt``,
``tsa_fusion``, ``scg{g}.block{i}.{body{j}_0,body{j}_1,down{j},up{j}}``,
``scg{g}.conv{j}``, ``upconv1_L{2,3}``, ``upconv{1,2}``, ``conv_last``): no
reference SIDECVSR state dict is in the repository. Plain PyTorch; no TPU
kernel is on this path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.resize import resize_bilinear
from pnp_vcve_torch.ops.upsample import pixel_shuffle
from pnp_vcve_torch.ops.warp import flow_warp
from ..init import torch_default_all_

__all__ = ["SIDECVSR"]

_LEVELS = 3


def _lrelu(x):
    return F.leaky_relu(x, 0.1)


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, 1, k // 2)


def _unfold3(x: torch.Tensor) -> torch.Tensor:
    """(b, h, w, c) -> (b, h, w, 9, c): each pixel's 3x3 patch, zero padded."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], 3)


class _SFTLayer(nn.Module):
    def __init__(self, nf: int, side: int = 32):
        super().__init__()
        self.scale0, self.scale1 = _conv(nf + side, nf, 1), _conv(nf, nf, 1)
        self.shift0, self.shift1 = _conv(nf + side, nf, 1), _conv(nf, nf, 1)

    def forward(self, feas, side):
        x = torch.cat([feas, side], -1)
        scale = conv_same(_lrelu(conv_same(x, self.scale0)), self.scale1)
        shift = conv_same(_lrelu(conv_same(x, self.shift0)), self.shift1)
        return feas * (scale + 1.0) + shift


class _ResBlockSFT(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.sft0, self.conv0 = _SFTLayer(nf), _conv(nf, nf)
        self.sft1, self.conv1 = _SFTLayer(nf), _conv(nf, nf)

    def forward(self, feas, side):
        y = F.relu(conv_same(self.sft0(feas, side), self.conv0))
        return feas + conv_same(self.sft1(y, side), self.conv1)


class _MVLocalAttn(nn.Module):
    """Kernel-predicted fusion of the MV-warped neighbour patches
    (SIDECVSR_J_fast.py:36-68)."""

    def __init__(self, nf: int):
        super().__init__()
        self.kpred0, self.kpred1 = _conv(18 * nf, nf, 1), _conv(nf, 9, 1)

    def forward(self, nbh, cen, mv):
        b, h, w, c = cen.shape
        aligned = flow_warp(_unfold3(nbh).reshape(b, h, w, 9 * c), mv * 32.0,
                            padding_mode="border")
        a = torch.cat([aligned, _unfold3(cen).reshape(b, h, w, 9 * c)], -1)
        a = torch.softmax(conv_same(_lrelu(conv_same(a, self.kpred0)), self.kpred1), -1)
        return (aligned.reshape(b, h, w, 9, c) * a[..., None]).mean(3)


class _FeaFusion(nn.Module):
    """Temporal correlation gating (SIDECVSR_J_fast.py:231-253)."""

    def __init__(self, nf: int, n: int):
        super().__init__()
        self.nf, self.n = nf, n
        self.tAtt = _conv(nf, nf)

    def forward(self, feas):
        b, h, w, _ = feas.shape
        x = feas.reshape(b, h, w, self.n, self.nf).permute(0, 3, 1, 2, 4)  # b, n, h, w, nf
        emb = conv_same(x.reshape(b * self.n, h, w, self.nf), self.tAtt)
        emb = emb.reshape(b, self.n, h, w, self.nf)
        ref = emb[:, self.n // 2]
        cor = torch.stack([(emb[:, i] * ref).sum(-1) for i in range(self.n)], 1)
        gated = x * torch.sigmoid(cor)[..., None]
        return gated.permute(0, 2, 3, 1, 4).reshape(b, h, w, self.n * self.nf)


class _Block(nn.Module):
    """Multi-scale exchange block (SIDECVSR_J_fast.py:268-311)."""

    def __init__(self, nf: int):
        super().__init__()
        for i in range(_LEVELS):
            setattr(self, f"body{i}_0", _conv(nf, 2 * nf))
            setattr(self, f"body{i}_1", _conv(2 * nf, nf))
        for i in range(_LEVELS - 1):
            setattr(self, f"down{i}", _conv(nf, nf, 1))
            setattr(self, f"up{i}", _conv(nf, nf, 1))

    def forward(self, xs):
        res = [conv_same(_lrelu(conv_same(x, getattr(self, f"body{i}_0"))),
                         getattr(self, f"body{i}_1")) for i, x in enumerate(xs)]
        down = [res[0]] + [
            resize_bilinear(conv_same(r, getattr(self, f"down{i}")),
                            (r.shape[1] // 2, r.shape[2] // 2))
            for i, r in enumerate(res[:-1])]
        up = [
            resize_bilinear(conv_same(r, getattr(self, f"up{i}")),
                            (r.shape[1] * 2, r.shape[2] * 2))
            for i, r in enumerate(res[1:])] + [res[-1]]
        return [x + r + d + u for x, r, d, u in zip(xs, res, down, up)]


class _SCGroup(nn.Module):
    def __init__(self, nf: int, n_blocks: int = 3):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            setattr(self, f"block{i}", _Block(nf))
        for i in range(_LEVELS):
            setattr(self, f"conv{i}", _conv(nf, nf))

    def forward(self, xs):
        res = xs
        for i in range(self.n_blocks):
            res = getattr(self, f"block{i}")(res)
        return [x + conv_same(r, getattr(self, f"conv{i}"))
                for i, (x, r) in enumerate(zip(xs, res))]


class SIDECVSR(nn.Module):
    """7 Y-channel frames with their side maps -> the x4 centre frame."""

    def __init__(self, nf: int = 64, nframes: int = 7, scg_n: int = 4):
        super().__init__()
        self.nf, self.nframes, self.scg_n = nf, nframes, scg_n
        self.side_to_fea0 = _conv(3, 32)
        for i in range(1, 4):
            setattr(self, f"side_to_fea{i}", _conv(32, 32))
        self.conv_first = _conv(1, nf)
        for i in range(7):
            setattr(self, f"RB_wSide_{i + 1}", _ResBlockSFT(nf))
        self.mv_patch_attn = _MVLocalAttn(nf)
        self.tmp_fea_attn = _FeaFusion(nf, nframes)
        self.tsa_fusion = _conv(nframes * nf, nf, 1)
        for g in range(scg_n):
            setattr(self, f"scg{g}", _SCGroup(nf))
        self.upconv1_L3 = _conv(nf, nf, 1)
        self.upconv1_L2 = _conv(nf, nf, 1)
        self.upconv1 = _conv(nf + nf // 4 + nf // 16, 4 * nf)
        self.upconv2 = _conv(nf, 4 * nf, 1)
        self.conv_last = _conv(nf, 1)

    def reset_parameters(self, generator: torch.Generator):
        """PyTorch's default init for every conv, in module order."""
        torch_default_all_(self, generator)

    def _extract(self, frames, sides):
        s = sides
        for i in range(4):
            s = _lrelu(conv_same(s, getattr(self, f"side_to_fea{i}")))
        f = _lrelu(conv_same(frames, self.conv_first))
        for i in range(7):
            f = getattr(self, f"RB_wSide_{i + 1}")(f, s)
        return f

    def forward(self, x, mvs, pms, rms, ufs, pre_l1_fea: Optional[torch.Tensor] = None):
        """``x (b, n, h, w, 1)``, ``mvs (b, n, h, w, 2)``, ``pms``/``rms``/``ufs``
        ``(b, n, h, w, 1)`` -> ``(out (b, 4h, 4w, 1), l1 (b, n, h, w, nf))``:
        the frame features come back for the next window's ``pre_l1_fea``."""
        b, n, h, w, c = x.shape
        nf, center = self.nf, self.nframes // 2
        if pre_l1_fea is None:
            sides = torch.cat([rms.reshape(b * n, h, w, c), pms.reshape(b * n, h, w, c),
                               ufs.reshape(b * n, h, w, c)], -1)
            l1 = self._extract(x.reshape(b * n, h, w, c), sides).reshape(b, n, h, w, nf)
        else:
            new = self._extract(x[:, -1], torch.cat([rms[:, -1], pms[:, -1], ufs[:, -1]], -1))
            l1 = torch.cat([pre_l1_fea[:, 1:], new[:, None]], 1)

        fused, feat = [], l1
        for lv in range(_LEVELS):
            hh, ww = feat.shape[2:4]
            aligned = []
            for i in range(n):
                if i == n // 2:
                    aligned.append(feat[:, i])
                    continue
                mv = mvs[:, i]
                if lv:
                    mv = resize_bilinear(mv, (hh, ww)) / (2.0 ** lv)
                aligned.append(self.mv_patch_attn(feat[:, i], feat[:, n // 2], mv))
            stack = self.tmp_fea_attn(torch.cat(aligned, -1))
            fused.append(_lrelu(conv_same(stack, self.tsa_fusion)))
            if lv < _LEVELS - 1:
                feat = resize_bilinear(feat.reshape(b * n, hh, ww, nf), (hh // 2, ww // 2))
                feat = feat.reshape(b, n, hh // 2, ww // 2, nf)

        out = fused
        for g in range(self.scg_n):
            out = getattr(self, f"scg{g}")(out)
        out = [x0 + r for x0, r in zip(fused, out)]  # SCNet's outer residual

        l3 = _lrelu(conv_same(out[2], self.upconv1_L3))
        l3 = pixel_shuffle(pixel_shuffle(l3, 2), 2)
        l2 = pixel_shuffle(_lrelu(conv_same(out[1], self.upconv1_L2)), 2)
        y = _lrelu(pixel_shuffle(conv_same(torch.cat([out[0], l2, l3], -1), self.upconv1), 2))
        y = _lrelu(pixel_shuffle(conv_same(y, self.upconv2), 2))
        y = conv_same(y, self.conv_last)
        return y + resize_bilinear(x[:, center], (4 * h, 4 * w)), l1
