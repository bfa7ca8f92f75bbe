"""STDF, spatio-temporal deformable fusion (counterpart of
pnp_vcve_tpu/models/baselines/stdf.py; reference sr_backbones/stdf.py:21-262).

A U-net over the window stacked into channels regresses per-pixel offsets
and masks for one modulated deformable conv that fuses every frame at once
(``deform_groups`` = the stacked channels, 21 at radius 3), then a plain
quality-enhancement net adds its residual to the centre frame. Everything
is plain PyTorch, as JAX computes it in XLA: the DCN is the port's
``ops/deform_conv.py``, the convolutions cuDNN's, and no TPU kernel is on
this path.

JAX's arithmetic is kept where it differs from the reference's: the
stride-2 3x3 convs pad as XLA's 'SAME' (``ops/conv.py``: 0 above, 1 below
on an even side), a decoder map that does not match its skip's odd size is
bilinearly resized (``ops/resize.py``, no antialiasing), and the offsets
are read from the head's output as ``(b, h, w, in_nc, k*k, 2)`` (dy, dx),
the masks as ``(b, h, w, in_nc, k*k)``. The transposed convs are
``ConvTranspose2d(k=4, s=2, p=1)``, flax's ``ConvTranspose(4, 2, 'SAME')``
with the kernel flipped and its in/out axes swapped.

Parameter names are the reference's (``stdf.in_conv.0``, ``stdf.dn_conv{i}
.{0,2}``, ``stdf.tr_conv.{0,2,4}``, ``stdf.up_conv{i}.{0,2}``,
``stdf.out_conv.0``, ``stdf.offset_mask``, ``stdf.deform_conv``,
``qenet.in_conv``, ``qenet.hid_conv.{1,3,..}``, ``qenet.out_conv.1``), the
ones that ``pnp_vcve_tpu/core/convert_baselines.py: convert_stdf`` reads, so
a reference STDF state dict loads directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d
from pnp_vcve_torch.ops.resize import resize_bilinear
from ..init import torch_default_all_

__all__ = ["STDFNet"]


def _conv_transpose_x2(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """``ConvTranspose2d(k=4, s=2, p=1)`` on NHWC: (b, h, w, c) -> (b, 2h, 2w, c')."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


class _DeformConv(nn.Module):
    """The modulated deformable conv's ``weight (out, in, k, k)`` and ``bias``
    (mmcv ``ModulatedDeformConv2d``'s parameters)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))


class _STDF(nn.Module):
    """The U-net offset head and the deformable fusion: ``(b, h, w, in_nc)``
    -> ``(b, h, w, out_nc)``."""

    def __init__(self, in_nc: int, out_nc: int = 64, nf: int = 32, nb: int = 3,
                 deform_ks: int = 3):
        super().__init__()
        self.in_nc, self.nb, self.deform_ks = in_nc, nb, deform_ks
        kk = deform_ks ** 2
        self.in_conv = nn.Sequential(nn.Conv2d(in_nc, nf, 3, 1, 1), nn.ReLU())
        for i in range(1, nb):
            setattr(self, f"dn_conv{i}", nn.Sequential(
                nn.Conv2d(nf, nf, 3, 2, 1), nn.ReLU(), nn.Conv2d(nf, nf, 3, 1, 1), nn.ReLU()))
            setattr(self, f"up_conv{i}", nn.Sequential(
                nn.Conv2d(2 * nf, nf, 3, 1, 1), nn.ReLU(), nn.ConvTranspose2d(nf, nf, 4, 2, 1),
                nn.ReLU()))
        self.tr_conv = nn.Sequential(
            nn.Conv2d(nf, nf, 3, 2, 1), nn.ReLU(), nn.Conv2d(nf, nf, 3, 1, 1), nn.ReLU(),
            nn.ConvTranspose2d(nf, nf, 4, 2, 1), nn.ReLU())
        self.out_conv = nn.Sequential(nn.Conv2d(nf, nf, 3, 1, 1), nn.ReLU())
        self.offset_mask = nn.Conv2d(nf, in_nc * 3 * kk, 3, 1, 1)
        self.deform_conv = _DeformConv(in_nc, out_nc, deform_ks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.deform_ks ** 2
        skips = [F.relu(conv_same(x, self.in_conv[0]))]
        for i in range(1, self.nb):
            dn = getattr(self, f"dn_conv{i}")
            y = F.relu(conv_same(skips[-1], dn[0], 2))
            skips.append(F.relu(conv_same(y, dn[2])))
        out = F.relu(conv_same(skips[-1], self.tr_conv[0], 2))
        out = F.relu(conv_same(out, self.tr_conv[2]))
        out = F.relu(_conv_transpose_x2(out, self.tr_conv[4]))
        for i in range(self.nb - 1, 0, -1):
            up = getattr(self, f"up_conv{i}")
            if out.shape[1:3] != skips[i].shape[1:3]:
                out = resize_bilinear(out, skips[i].shape[1:3])
            out = F.relu(conv_same(torch.cat([out, skips[i]], -1), up[0]))
            out = F.relu(_conv_transpose_x2(out, up[2]))
        out = F.relu(conv_same(out, self.out_conv[0]))
        if out.shape[1:3] != x.shape[1:3]:
            out = resize_bilinear(out, x.shape[1:3])
        off_msk = conv_same(out, self.offset_mask)
        b, h, w, _ = x.shape
        n_off = self.in_nc * 2 * kk
        off = off_msk[..., :n_off].reshape(b, h, w, self.in_nc, kk, 2)
        msk = torch.sigmoid(off_msk[..., n_off:]).reshape(b, h, w, self.in_nc, kk)
        dc = self.deform_conv
        return F.relu(modulated_deform_conv2d(x, off, msk, dc.weight.permute(2, 3, 1, 0), dc.bias))


class _QENet(nn.Module):
    """Plain 3x3 convs with ReLUs: ``in_conv``, ``nb`` hidden, ``out_conv``."""

    def __init__(self, in_nc: int, nf: int = 48, nb: int = 6, out_nc: int = 3):
        super().__init__()
        self.nb = nb
        self.in_conv = nn.Conv2d(in_nc, nf, 3, 1, 1)
        hidden = []
        for _ in range(nb):
            hidden += [nn.ReLU(), nn.Conv2d(nf, nf, 3, 1, 1)]
        self.hid_conv = nn.Sequential(*hidden)
        self.out_conv = nn.Sequential(nn.ReLU(), nn.Conv2d(nf, out_nc, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_same(x, self.in_conv)
        for k in range(self.nb):
            out = conv_same(F.relu(out), self.hid_conv[2 * k + 1])
        return conv_same(F.relu(out), self.out_conv[1])


class STDFNet(nn.Module):
    """A window of ``2 * radius + 1`` frames -> the enhanced centre frame."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, radius: int = 3,
                 nf_stdf: int = 32, nb_stdf: int = 3, nf_stdf_out: int = 64, deform_ks: int = 3,
                 nf_qe: int = 48, nb_qe: int = 6):
        super().__init__()
        self.radius = radius
        self.stdf = _STDF((2 * radius + 1) * in_channels, nf_stdf_out, nf_stdf, nb_stdf,
                          deform_ks)
        self.qenet = _QENet(nf_stdf_out, nf_qe, nb_qe, out_channels)

    def reset_parameters(self, generator: torch.Generator):
        """PyTorch's default init for every conv, in module order."""
        torch_default_all_(self, generator)

    def forward(self, lrs: torch.Tensor, **_ignored) -> torch.Tensor:
        """``lrs (b, t, h, w, c)``, t = 2 * radius + 1 -> ``(b, h, w, c)``."""
        b, t, h, w, c = lrs.shape
        x = lrs.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        return self.qenet(self.stdf(x)) + lrs[:, self.radius]
