"""The single-image SR models (counterpart of pnp_vcve_tpu/models/baselines/
sisr.py): ``(b, h, w, 3)`` in [0, 1] -> ``(b, s h, s w, 3)``.

- EDSR (reference edsr.py:41-120): RGB mean/std normalisation, residual
  blocks scaled by ``res_scale``, a pixel-shuffle chain (x3 once, else x2
  stages);
- RRDBNet, ESRGAN's generator (rrdb_net.py:13-175): residual-in-residual
  dense blocks at 0.2 scaling, two nearest x2 upsamplings with convs; for
  ``upscale_factor`` 1 or 2 the input is first pixel-unshuffled to x4 in
  JAX's channel order (``(i * s + j) * c + channel``, not
  ``F.pixel_unshuffle``'s ``channel * s * s + i * s + j``);
- MSRResNet (sr_resnet.py:12-110): residual blocks, a pixel-shuffle chain
  and the input upsampled bilinearly (``ops/resize.py``) as a skip;
- SRCNN (srcnn.py:10-65): the input upsampled with ``jax.image.resize``'s
  bicubic (``ops/resize.py: resize_bicubic``, Keys' cubic at half-pixel
  centres), then three convs;
- RDN (rdn.py:71-180): residual dense blocks, global fusion over every
  block's output, pixel-shuffle upsampling (x2 and x3 in one stage, else
  ``upscale_factor // 2`` x2 stages, as JAX builds them).

Plain PyTorch (cuDNN convolutions), as JAX computes them in XLA; no TPU
kernel is on these paths. Parameter names follow the JAX module tree in
PyTorch's forms (``conv_first``, ``block{i}_conv{1,2}``,
``rrdb{i}.rdb{j}.conv{k}``, ``rdb{i}.dense{j}``, ...; ``core/convert.py:
sisr_state_dict``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.resize import resize_bicubic, resize_bilinear
from pnp_vcve_torch.ops.upsample import pixel_shuffle
from ..init import torch_default_all_

__all__ = ["EDSR", "RRDBNet", "MSRResNet", "SRCNN", "RDN", "pixel_unshuffle"]


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """``(b, h, w, c) -> (b, h / s, w / s, s * s * c)``, JAX's channel order:
    pixel ``(i, j)`` of each s x s cell to channels ``(i * s + j) * c``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // scale, scale, w // scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // scale, w // scale, scale * scale * c)


def _conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, 1, k // 2)


class _SISR(nn.Module):
    def reset_parameters(self, generator: torch.Generator):
        """PyTorch's default init on every conv."""
        torch_default_all_(self, generator)

    def _c(self, name, x):
        return conv_same(x, getattr(self, name))


class EDSR(_SISR):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 16, upscale_factor: int = 4, res_scale: float = 1.0,
                 rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0)):
        super().__init__()
        self.num_blocks, self.res_scale = num_blocks, res_scale
        self.rgb_mean, self.rgb_std = tuple(rgb_mean), tuple(rgb_std)
        c = mid_channels
        self.conv_first = _conv(in_channels, c)
        for i in range(num_blocks):
            setattr(self, f"block{i}_conv1", _conv(c, c))
            setattr(self, f"block{i}_conv2", _conv(c, c))
        self.conv_after_body = _conv(c, c)
        # 2^n pixel-shuffle chain (or a single x3 stage)
        self.stages, s = [], upscale_factor
        while s > 1:
            r = 3 if s % 3 == 0 else 2
            setattr(self, f"upsample{len(self.stages)}", _conv(c, c * r * r))
            self.stages.append(r)
            s //= r
        self.conv_last = _conv(c, out_channels)

    def forward(self, x):
        mean = torch.tensor(self.rgb_mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(self.rgb_std, dtype=x.dtype, device=x.device)
        feat = self._c("conv_first", (x - mean) / std)
        body = feat
        for i in range(self.num_blocks):
            y = self._c(f"block{i}_conv2", F.relu(self._c(f"block{i}_conv1", body)))
            body = body + y * self.res_scale
        feat = feat + self._c("conv_after_body", body)
        for i, r in enumerate(self.stages):
            feat = pixel_shuffle(self._c(f"upsample{i}", feat), r)
        return self._c("conv_last", feat) * std + mean


class _ResidualDenseBlock(_SISR):
    def __init__(self, mid_channels: int = 64, growth_channels: int = 32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", _conv(mid_channels + i * growth_channels,
                                               growth_channels))
        self.conv5 = _conv(mid_channels + 4 * growth_channels, mid_channels)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            feats.append(F.leaky_relu(self._c(f"conv{i + 1}", torch.cat(feats, -1)), 0.2))
        return x + 0.2 * self._c("conv5", torch.cat(feats, -1))


class _RRDB(nn.Module):
    def __init__(self, mid_channels: int = 64, growth_channels: int = 32):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"rdb{i}", _ResidualDenseBlock(mid_channels, growth_channels))

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


def _nearest_x2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class RRDBNet(_SISR):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 23, growth_channels: int = 32, upscale_factor: int = 4):
        super().__init__()
        c = mid_channels
        self.num_blocks, self.upscale_factor = num_blocks, upscale_factor
        unshuffle = 4 // upscale_factor if upscale_factor in (1, 2) else 1
        self.conv_first = _conv(in_channels * unshuffle * unshuffle, c)
        for i in range(num_blocks):
            setattr(self, f"rrdb{i}", _RRDB(c, growth_channels))
        for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
            setattr(self, name, _conv(c, c))
        self.conv_last = _conv(c, out_channels)

    def forward(self, x):
        if self.upscale_factor in (1, 2):
            x = pixel_unshuffle(x, 4 // self.upscale_factor)
        feat = self._c("conv_first", x)
        body = feat
        for i in range(self.num_blocks):
            body = getattr(self, f"rrdb{i}")(body)
        feat = feat + self._c("conv_body", body)
        feat = F.leaky_relu(self._c("conv_up1", _nearest_x2(feat)), 0.2)
        feat = F.leaky_relu(self._c("conv_up2", _nearest_x2(feat)), 0.2)
        feat = F.leaky_relu(self._c("conv_hr", feat), 0.2)
        return self._c("conv_last", feat)


class MSRResNet(_SISR):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 16, upscale_factor: int = 4):
        super().__init__()
        c = mid_channels
        self.num_blocks, self.upscale_factor = num_blocks, upscale_factor
        self.conv_first = _conv(in_channels, c)
        for i in range(num_blocks):
            setattr(self, f"block{i}_conv1", _conv(c, c))
            setattr(self, f"block{i}_conv2", _conv(c, c))
        self.stages = [upscale_factor] if upscale_factor in (2, 3) else [2, 2]
        for i, r in enumerate(self.stages):
            setattr(self, f"upsample{i + 1}", _conv(c, c * r * r))
        self.conv_hr = _conv(c, c)
        self.conv_last = _conv(c, out_channels)

    def forward(self, x):
        feat = F.leaky_relu(self._c("conv_first", x), 0.1)
        body = feat
        for i in range(self.num_blocks):
            body = body + self._c(f"block{i}_conv2", F.relu(self._c(f"block{i}_conv1", body)))
        for i, r in enumerate(self.stages):
            body = F.leaky_relu(pixel_shuffle(self._c(f"upsample{i + 1}", body), r), 0.1)
        body = F.leaky_relu(self._c("conv_hr", body), 0.1)
        s = self.upscale_factor
        return self._c("conv_last", body) + resize_bilinear(x, (x.shape[1] * s,
                                                                x.shape[2] * s))


class SRCNN(_SISR):
    def __init__(self, channels=(3, 64, 32, 3), kernel_sizes=(9, 1, 5), upscale_factor: int = 4):
        super().__init__()
        self.upscale_factor, self.depth = upscale_factor, len(kernel_sizes)
        for i, k in enumerate(kernel_sizes):
            setattr(self, f"conv{i + 1}", _conv(channels[i], channels[i + 1], k))

    def forward(self, x):
        s = self.upscale_factor
        x = resize_bicubic(x, (x.shape[1] * s, x.shape[2] * s))
        for i in range(self.depth):
            x = self._c(f"conv{i + 1}", x)
            if i < self.depth - 1:
                x = F.relu(x)
        return x


class _RDB(_SISR):
    """Residual dense block: dense layers, a 1x1 local fusion, the residual
    (rdn.py:36-68)."""

    def __init__(self, mid_channels: int = 64, growth: int = 64, num_layers: int = 8):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"dense{i}", _conv(mid_channels + i * growth, growth))
        self.lff = _conv(mid_channels + num_layers * growth, mid_channels, 1)

    def forward(self, x):
        feats = [x]
        for i in range(self.num_layers):
            feats.append(F.relu(self._c(f"dense{i}", torch.cat(feats, -1))))
        return x + self._c("lff", torch.cat(feats, -1))


class RDN(_SISR):
    def __init__(self, in_channels: int = 3, out_channels: int = 3, mid_channels: int = 64,
                 num_blocks: int = 16, num_layers: int = 8, channel_growth: int = 64,
                 upscale_factor: int = 4):
        super().__init__()
        c = mid_channels
        self.num_blocks = num_blocks
        self.sfe1 = _conv(in_channels, c)
        self.sfe2 = _conv(c, c)
        for i in range(num_blocks):
            setattr(self, f"rdb{i}", _RDB(c, channel_growth, num_layers))
        self.gff1 = _conv(num_blocks * c, c, 1)
        self.gff2 = _conv(c, c)
        s = upscale_factor
        self.stages = [s] if s in (2, 3) else [2] * (s // 2)
        for i, r in enumerate(self.stages):
            setattr(self, f"up{i}", _conv(c, c * r * r))
        self.output = _conv(c, out_channels)

    def forward(self, x):
        sfe1 = self._c("sfe1", x)
        y = self._c("sfe2", sfe1)
        local = []
        for i in range(self.num_blocks):
            y = getattr(self, f"rdb{i}")(y)
            local.append(y)
        y = self._c("gff2", self._c("gff1", torch.cat(local, -1))) + sfe1
        for i, r in enumerate(self.stages):
            y = pixel_shuffle(self._c(f"up{i}", y), r)
        return self._c("output", y)
