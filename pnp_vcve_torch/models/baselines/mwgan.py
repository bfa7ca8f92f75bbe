"""MW-GAN's PSNR generator, ``DenseMWNet_Mini_PSNR`` (counterpart of
pnp_vcve_tpu/models/baselines/mwgan.py; reference sr_backbones/mwgan.py:
764-880): wavelet-domain multi-frame enhancement. Haar DWT + 1x1 conv
downsamplers (``ops/wavelet.py``), a 3-level pyramid aligner on
pixel-adaptive convs (``MWPAlign``, ``ops/pac.py``), residual-dense
wavelet blocks and IWT + 1x1 conv upsampling, residual to the centre frame.

Two reference quirks are kept, as JAX keeps them: ``DWT_1`` is applied
twice (mwgan.py:833-836), and ``_MultiExtFea`` applies ``conv1`` twice (its
``conv0`` is never used, so it has none). Frame sides must be multiples of
16 (four halvings); JAX fails on other sides, the port refuses them with a
message. Parameter names follow the JAX module tree in PyTorch's forms
(``conv_first_1``, ``DWT_1.conv``, ``multi_fea_l1.conv{1,2,3,_out}``,
``motion_align.L3_pcnpack.{weight,bias}``, ``WDRB{i}.RDB{j}.conv{k}``, ...):
no reference MW-GAN state dict is in the repository. Plain PyTorch, as JAX
computes it in XLA; no TPU kernel is on this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.pac import pac_conv2d
from pnp_vcve_torch.ops.resize import resize_bilinear
from pnp_vcve_torch.ops.wavelet import dwt, iwt
from ..init import torch_default_all_

__all__ = ["DenseMWNetMiniPSNR", "MWPAlign"]


def _lrelu(x, s=0.2):
    return F.leaky_relu(x, s)


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, 1, k // 2)


class _DWTCNN(nn.Module):
    """DWT, then a 1x1 conv from 4c to ``ch``, LeakyReLU 0.1."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv = _conv(4 * cin, ch, 1)

    def forward(self, x):
        return _lrelu(conv_same(dwt(x), self.conv), 0.1)


class _IWTCNN(nn.Module):
    """IWT, then a 1x1 conv from c/4 to ``ch``, LeakyReLU 0.1."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv = _conv(cin // 4, ch, 1)

    def forward(self, x):
        return _lrelu(conv_same(iwt(x), self.conv), 0.1)


class _RDB5C(nn.Module):
    """Residual dense block (mwgan.py:237-258)."""

    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", _conv(nf + i * gc, gc))
        self.conv5 = _conv(nf + 4 * gc, nf)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(_lrelu(conv_same(torch.cat(feats, -1), getattr(self, f"conv{i + 1}"))))
        return conv_same(torch.cat(feats, -1), self.conv5) * 0.2 + x


class _WDRBMini(nn.Module):
    """Wavelet-domain residual-in-residual dense block (mwgan.py:278-298)."""

    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        self.dwt = _DWTCNN(nf, nf)
        for i in range(3):
            setattr(self, f"RDB{i + 1}", _RDB5C(nf, gc))
        self.iwt = _IWTCNN(nf, nf)

    def forward(self, x):
        y = self.dwt(x)
        for i in range(3):
            y = getattr(self, f"RDB{i + 1}")(y)
        return self.iwt(y) * 0.2 + x


class _PacPack(nn.Module):
    """A PAC's ``weight (out, in, 3, 3)`` and ``bias``."""

    def __init__(self, cin: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nf, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(nf))

    def forward(self, x, guide):
        return pac_conv2d(x, guide, self.weight.permute(2, 3, 1, 0), self.bias)


class MWPAlign(nn.Module):
    """Pyramid cascading alignment with PAC (mwgan.py:161-235):
    ``nbr``, ``ref`` lists of the three levels' (b, h, w, nf) maps."""

    def __init__(self, nf: int = 64):
        super().__init__()
        for name, cin in (("L3_offset_conv1", 2), ("L3_offset_conv2", 1),
                          ("L2_offset_conv1", 2), ("L2_offset_conv2", 2), ("L2_offset_conv3", 1),
                          ("L2_fea_conv", 2), ("L1_offset_conv1", 2), ("L1_offset_conv2", 2),
                          ("L1_offset_conv3", 1), ("L1_fea_conv", 2), ("cas_offset_conv1", 2),
                          ("cas_offset_conv2", 1)):
            setattr(self, name, _conv(cin * nf, nf))
        for name in ("L3_pcnpack", "L2_pcnpack", "L1_pcnpack", "cas_pcnpack"):
            setattr(self, name, _PacPack(nf, nf))

    def _c(self, name, *xs):
        return conv_same(torch.cat(xs, -1) if len(xs) > 1 else xs[0], getattr(self, name))

    def forward(self, nbr, ref):
        l3_off = _lrelu(self._c("L3_offset_conv1", nbr[2], ref[2]), 0.1)
        l3_off = _lrelu(self._c("L3_offset_conv2", l3_off), 0.1)
        l3_fea = _lrelu(self.L3_pcnpack(nbr[2], l3_off), 0.1)

        l2_off = _lrelu(self._c("L2_offset_conv1", nbr[1], ref[1]), 0.1)
        l3_off_up = resize_bilinear(l3_off, l2_off.shape[1:3])
        l2_off = _lrelu(self._c("L2_offset_conv2", l2_off, l3_off_up * 2), 0.1)
        l2_off = _lrelu(self._c("L2_offset_conv3", l2_off), 0.1)
        l2_fea = self.L2_pcnpack(nbr[1], l2_off)
        l3_fea_up = resize_bilinear(l3_fea, l2_fea.shape[1:3])
        l2_fea = _lrelu(self._c("L2_fea_conv", l2_fea, l3_fea_up), 0.1)

        l1_off = _lrelu(self._c("L1_offset_conv1", nbr[0], ref[0]), 0.1)
        l2_off_up = resize_bilinear(l2_off, l1_off.shape[1:3])
        l1_off = _lrelu(self._c("L1_offset_conv2", l1_off, l2_off_up * 2), 0.1)
        l1_off = _lrelu(self._c("L1_offset_conv3", l1_off), 0.1)
        l1_fea = self.L1_pcnpack(nbr[0], l1_off)
        l2_fea_up = resize_bilinear(l2_fea, l1_fea.shape[1:3])
        l1_fea = self._c("L1_fea_conv", l1_fea, l2_fea_up)

        off = _lrelu(self._c("cas_offset_conv1", l1_fea, ref[0]), 0.1)
        off = _lrelu(self._c("cas_offset_conv2", off), 0.1)
        return _lrelu(self.cas_pcnpack(l1_fea, off), 0.1)


class _MultiExtFea(nn.Module):
    """3x3 (applied twice, as the reference does), 5x5 and 7x7 convs, then a
    3x3 fusion (mwgan.py:341-370)."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = _conv(nf, nf, 3)
        self.conv2 = _conv(nf, nf, 5)
        self.conv3 = _conv(nf, nf, 7)
        self.conv_out = _conv(4 * nf, nf, 3)

    def forward(self, x):
        x0 = _lrelu(conv_same(x, self.conv1))
        x1 = _lrelu(conv_same(x, self.conv1))
        x2 = _lrelu(conv_same(x, self.conv2))
        x3 = _lrelu(conv_same(x, self.conv3))
        return conv_same(torch.cat([x0, x1, x2, x3], -1), self.conv_out)


class DenseMWNetMiniPSNR(nn.Module):
    """``nframes`` frames -> the enhanced centre frame, same size; sides
    multiples of 16."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64, nb: int = 6,
                 nframes: int = 5, front_rbs: int = 3, gc: int = 32):
        super().__init__()
        self.nf, self.nb, self.nframes, self.front_rbs = nf, nb, nframes, front_rbs
        self.conv_first_1 = _conv(in_nc, nf)
        self.DWT_1 = _DWTCNN(nf, nf)
        self.conv_first_2 = _conv(nf, nf)
        self.conv_first_3 = _conv(nf, nf)
        self.multi_fea_l1 = _MultiExtFea(nf)
        for i in range(front_rbs):
            setattr(self, f"fe{i}_conv1", _conv(nf, nf))
            setattr(self, f"fe{i}_conv2", _conv(nf, nf))
        self.DWT_3 = _DWTCNN(nf, nf)
        self.fea_L2_conv1 = _conv(nf, nf)
        self.fea_L2_conv2 = _conv(nf, nf)
        self.DWT_4 = _DWTCNN(nf, nf)
        self.fea_L3_conv1 = _conv(nf, nf)
        self.fea_L3_conv2 = _conv(nf, nf)
        self.motion_align = MWPAlign(nf)
        self.attention_fusion = _conv(nframes * nf, nf, 1)
        for i in range(nb):
            setattr(self, f"WDRB{i}", _WDRBMini(nf, gc))
        self.IWT_1 = _IWTCNN(nf, nf)
        self.upconv1 = _conv(nf, nf)
        self.IWT_2 = _IWTCNN(nf, nf)
        self.upconv2 = _conv(nf, nf)
        self.conv_last = _conv(nf, out_nc)

    def reset_parameters(self, generator: torch.Generator):
        """PyTorch's default init for every conv and PAC, in module order."""
        torch_default_all_(self, generator)

    def forward(self, lrs: torch.Tensor, **_ignored) -> torch.Tensor:
        """``lrs (b, nframes, h, w, c)``, h and w multiples of 16 -> ``(b, h, w, c)``."""
        b, n, h, w, c = lrs.shape
        if h % 16 or w % 16:
            raise ValueError(f"DenseMWNetMiniPSNR needs sides that are multiples of 16 "
                             f"(four wavelet halvings), got {h}x{w}")
        nf, center = self.nf, self.nframes // 2
        lrelu = lambda v: _lrelu(v, 0.1)  # noqa: E731
        y = lrelu(conv_same(lrs.reshape(b * n, h, w, c), self.conv_first_1))
        y = self.DWT_1(y)
        y = lrelu(conv_same(y, self.conv_first_2))
        y = self.DWT_1(y)  # the reference applies DWT_1 twice
        y = lrelu(conv_same(y, self.conv_first_3))
        hh, ww = h // 4, w // 4

        y = self.multi_fea_l1(y)
        for i in range(self.front_rbs):
            r = F.relu(conv_same(y, getattr(self, f"fe{i}_conv1")))
            y = y + conv_same(r, getattr(self, f"fe{i}_conv2"))
        l2 = lrelu(conv_same(self.DWT_3(y), self.fea_L2_conv1))
        l2 = lrelu(conv_same(l2, self.fea_L2_conv2))
        l3 = lrelu(conv_same(self.DWT_4(l2), self.fea_L3_conv1))
        l3 = lrelu(conv_same(l3, self.fea_L3_conv2))

        l1 = y.reshape(b, n, hh, ww, nf)
        l2 = l2.reshape(b, n, hh // 2, ww // 2, nf)
        l3 = l3.reshape(b, n, hh // 4, ww // 4, nf)
        ref = [l1[:, center], l2[:, center], l3[:, center]]
        aligned = [self.motion_align([l1[:, i], l2[:, i], l3[:, i]], ref) for i in range(n)]
        fea = conv_same(torch.cat(aligned, -1), self.attention_fusion)
        for i in range(self.nb):
            fea = getattr(self, f"WDRB{i}")(fea)

        out = lrelu(conv_same(self.IWT_1(fea), self.upconv1))
        out = lrelu(conv_same(self.IWT_2(out), self.upconv2))
        return conv_same(out, self.conv_last) + lrs[:, center]
