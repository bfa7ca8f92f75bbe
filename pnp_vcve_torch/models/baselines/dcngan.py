"""DCNGAN (counterpart of pnp_vcve_tpu/models/baselines/dcngan.py; reference
sr_backbones/dcngan.py): the generator's FA module is STDF's U-net and
deformable fusion over a 3-frame window (``stdf._STDF``, 64 channels out);
its QE module is a pix2pixHD-style encoder-decoder whose 9 residual blocks
are gated by an embedding of the base QP; the discriminator is DCGAN-style
and also returns its four intermediate maps for the feature-matching loss.

JAX's forms, kept here:

- :class:`BatchStatsNorm` normalises with the current batch's statistics
  (biased variance, eps 1e-5) in training and in evaluation alike and keeps
  no running statistics; its parameters are ``scale`` and ``bias``. The
  reference uses ``nn.BatchNorm2d`` (ROADMAP Queue C);
- the QP goes through ``one_hot(clip(int(base_qp), 0, 3), 4)``, a Linear to
  512 and a softplus (the batches' base QPs are rescaled by 1/255, so a
  training batch lands in class 0, as in JAX);
- the stride-2 convs pad as XLA's 'SAME' (``ops/conv.py``); the 7x7 head and
  tail and the blocks' 3x3 convs pad by reflection; the decoder resizes x2
  bilinearly, then runs a stride-1 3x3 conv.

Parameter names: ``FA.*`` are STDF's (the reference's), the rest follow the
JAX module tree in PyTorch's forms (``QE.fc``, ``QE.head``, ``QE.head_bn``,
``QE.down{i}``, ``QE.down{i}_bn``, ``QE.resB{i}.{conv1,bn1,conv2,bn2}``,
``QE.up{i}``, ``QE.up{i}_bn``, ``QE.tail``; the discriminator's
``conv{1..5}``, ``bn{2,3,4}``): no reference DCNGAN state dict is in the
repository. Plain PyTorch throughout; no TPU kernel is on this path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.resize import resize_bilinear
from ..init import torch_default_all_
from .stdf import _STDF

__all__ = ["DCNGANNet", "DCNGANDiscriminator", "BatchStatsNorm"]


def _reflect_conv(x: torch.Tensor, conv: nn.Conv2d, p: int) -> torch.Tensor:
    """``conv`` unpadded on ``x`` reflect-padded by ``p``; NHWC in and out."""
    y = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    return F.conv2d(y, conv.weight, conv.bias).permute(0, 2, 3, 1)


class BatchStatsNorm(nn.Module):
    """``(x - mean) / sqrt(var + 1e-5) * scale + bias`` with the mean and the
    biased variance of the batch over (b, h, w), per channel."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def reset_parameters(self):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(0, 1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias


def _reset_all(module: nn.Module, generator: torch.Generator):
    """PyTorch's default init for the convs and Linears; unit scale, zero
    bias for the norms."""
    torch_default_all_(module, generator)
    for m in module.modules():
        if isinstance(m, BatchStatsNorm):
            m.reset_parameters()


class _QPResBlock(nn.Module):
    """conv -> x QP embedding -> norm -> ReLU -> conv -> norm -> + x."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3)
        self.bn1 = BatchStatsNorm(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3)
        self.bn2 = BatchStatsNorm(dim)

    def forward(self, x, qp_embed):
        y = _reflect_conv(x, self.conv1, 1) * qp_embed[:, None, None, :]
        y = F.relu(self.bn1(y))
        return x + self.bn2(_reflect_conv(y, self.conv2, 1))


class _QEModule(nn.Module):
    def __init__(self, input_nc: int = 64, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9):
        super().__init__()
        self.n_downsampling, self.n_blocks = n_downsampling, n_blocks
        self.fc = nn.Linear(4, 512)
        self.head = nn.Conv2d(input_nc, ngf, 7)
        self.head_bn = BatchStatsNorm(ngf)
        ch = ngf
        for i in range(n_downsampling):
            setattr(self, f"down{i}", nn.Conv2d(ch, ngf * 2 ** (i + 1), 3, 2))
            ch = ngf * 2 ** (i + 1)
            setattr(self, f"down{i}_bn", BatchStatsNorm(ch))
        for i in range(n_blocks):
            setattr(self, f"resB{i}", _QPResBlock(ngf * 8))
        for i, out in enumerate((ngf * 4, ngf * 2, ngf)):
            setattr(self, f"up{i}", nn.Conv2d(ch, out, 3, 1, 1))
            setattr(self, f"up{i}_bn", BatchStatsNorm(out))
            ch = out
        self.tail = nn.Conv2d(ch, output_nc, 7)

    def forward(self, x, base_qp):
        qp = F.one_hot(base_qp.to(torch.int32).clamp(0, 3).long(), 4).to(x.dtype)
        qp_embed = F.softplus(self.fc(qp))
        y = F.relu(self.head_bn(_reflect_conv(x, self.head, 3)))
        for i in range(self.n_downsampling):
            y = F.relu(getattr(self, f"down{i}_bn")(conv_same(y, getattr(self, f"down{i}"), 2)))
        for i in range(self.n_blocks):
            y = getattr(self, f"resB{i}")(y, qp_embed)
        for i in range(3):
            y = resize_bilinear(y, (2 * y.shape[1], 2 * y.shape[2]))
            y = F.relu(getattr(self, f"up{i}_bn")(conv_same(y, getattr(self, f"up{i}"))))
        return torch.tanh(_reflect_conv(y, self.tail, 3))


class DCNGANNet(nn.Module):
    """The generator: a 3-frame window -> the enhanced centre frame."""

    def __init__(self, in_channels: int = 3, radius: int = 1, nf_fa: int = 32, nb_fa: int = 3):
        super().__init__()
        self.FA = _STDF((2 * radius + 1) * in_channels, 64, nf_fa, nb_fa)
        self.QE = _QEModule()

    def reset_parameters(self, generator: torch.Generator):
        _reset_all(self, generator)

    def forward(self, lrs: torch.Tensor, base_qps=None, **_ignored) -> torch.Tensor:
        """``lrs (b, t, h, w, c)``, ``base_qps (b, t)`` or None -> ``(b, h, w, c)``."""
        b, t, h, w, c = lrs.shape
        x = lrs.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        base_qp = (base_qps[:, 0] if base_qps is not None
                   else torch.zeros(b, dtype=torch.float32, device=lrs.device))
        return self.QE(self.FA(x), base_qp)


class DCNGANDiscriminator(nn.Module):
    """k4 s2 'SAME' convs (the last three normalised), LeakyReLU 0.2, and a
    VALID 4x4 conv to one channel: ``{"prediction", "feature_maps"}``."""

    def __init__(self, d: int = 128, in_channels: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, d, 4, 2)
        ch = d
        for i, mult in enumerate((2, 4, 8)):
            setattr(self, f"conv{i + 2}", nn.Conv2d(ch, d * mult, 4, 2))
            setattr(self, f"bn{i + 2}", BatchStatsNorm(d * mult))
            ch = d * mult
        self.conv5 = nn.Conv2d(ch, 1, 4)

    def reset_parameters(self, generator: torch.Generator):
        _reset_all(self, generator)

    def forward(self, x: torch.Tensor) -> dict:
        y = F.leaky_relu(conv_same(x, self.conv1, 2), 0.2)
        feats = [y]
        for i in range(2, 5):
            y = conv_same(y, getattr(self, f"conv{i}"), 2)
            y = F.leaky_relu(getattr(self, f"bn{i}")(y), 0.2)
            feats.append(y)
        pred = F.conv2d(y.permute(0, 3, 1, 2), self.conv5.weight, self.conv5.bias)
        return {"prediction": pred.permute(0, 2, 3, 1), "feature_maps": feats}
