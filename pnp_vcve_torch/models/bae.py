"""BAE (bitstream-aware enhancement) blocks (counterpart of
pnp_vcve_tpu/models/bae.py:74-464), for the flagship block form:
channel_first, one_layer, dynamic conv2 with the with_se gain.

Parameters live under the original reference's names and layouts
(``input_conv.0``, ``main.{i}.conv2`` expert bank ``(K, out, in, 3, 3)``,
``main.{i}.conv1``, ``main.{i}.conv{16x16,16x8,8x8}``); the compute goes
through an ops namespace (``pnp_vcve_torch.kernels.KERNELS`` or ``PLAIN``)
in the JAX package's layouts.
"""

from __future__ import annotations

import torch
from torch import nn

from pnp_vcve_torch.kernels.drt_stack import part_kernels, premix_block_params
from .init import kaiming_uniform_expert_, scaled_kaiming_normal_, torch_default_

__all__ = ["ExpertBank", "DRTBlock", "ResidualBlocksWithInputConvDynamicDRT", "hwio"]


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> HWIO."""
    return w.permute(2, 3, 1, 0)


class ExpertBank(nn.Module):
    """Expert kernel bank of one mixed 3x3 conv (reference ``Dynamic_conv2d``):
    ``weight (K, out, in, 3, 3)``, ``bias (K, out)``."""

    def __init__(self, channels, num_experts):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, channels, channels, 3, 3))
        self.bias = nn.Parameter(torch.empty(num_experts, channels))

    def reset_parameters(self, generator):
        kaiming_uniform_expert_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()


class DRTBlock(nn.Module):
    """Partition-guided dynamic residual block (reference
    ``ResidualBlockNoBNDynamic_drt``, channel_first / one_layer):
    ``x + conv1(relu(gamma * dyn_conv(x) + sum_r par_r * conv1x1_r(x)))``."""

    def __init__(self, mid_channels=64, num_experts=6):
        super().__init__()
        c = mid_channels
        self.conv2 = ExpertBank(c, num_experts)
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1)
        self.conv16x16 = nn.Conv2d(c, c, 1, bias=False)
        self.conv16x8 = nn.Conv2d(c, c, 1, bias=False)
        self.conv8x8 = nn.Conv2d(c, c, 1, bias=False)

    def reset_parameters(self, generator):
        self.conv2.reset_parameters(generator)
        scaled_kaiming_normal_(self.conv1.weight, 0.1, generator)
        with torch.no_grad():
            self.conv1.bias.zero_()
        for conv in (self.conv16x16, self.conv16x8, self.conv8x8):
            scaled_kaiming_normal_(conv.weight, 0.1, generator)

    def par_kernel(self) -> torch.Tensor:
        """The three 1x1 partition convs as one ``(in, 3, out)`` kernel."""
        return torch.stack(
            [c.weight[:, :, 0, 0].t() for c in (self.conv16x16, self.conv16x8, self.conv8x8)],
            dim=1,
        )

    def forward(self, x, par, mixed: dict, ops, key_select=None):
        """``mixed``: this frame's premixed ``w2 (b,3,3,c,c)``, ``b2 (b,c)``,
        ``g (b,c)``. With ``key_select=(last_key, is_key)`` the block also
        returns the keyframe carry ``where(is_key, out, last_key)`` (K3s)."""
        args = (x, par, mixed["w2"], mixed["b2"], mixed["g"],
                self.par_kernel(), hwio(self.conv1.weight), self.conv1.bias)
        if key_select is not None:
            return ops.drt_block_select(*args, *key_select)
        return ops.drt_block(*args)


class ResidualBlocksWithInputConvDynamicDRT(nn.Module):
    """3x3 input conv + LeakyReLU(0.1) + N DRT blocks (reference
    basicvsr_net.py:478-519)."""

    def __init__(self, in_channels, out_channels=64, num_blocks=8, num_experts=6):
        super().__init__()
        self.input_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1),
            nn.LeakyReLU(0.1),
        )
        self.main = nn.ModuleList(
            DRTBlock(out_channels, num_experts) for _ in range(num_blocks)
        )

    def reset_parameters(self, generator):
        torch_default_(self.input_conv[0], generator)
        for blk in self.main:
            blk.reset_parameters(generator)

    def premix(self, weights_t, gammas_t):
        """Every block's expert mixing for all frames at once (hoisted out of
        the sweep): ``weights_t (t, b, K)``, ``gammas_t (t, b, c)`` -> one dict
        of ``(t, b, ...)`` tensors per block."""
        return [
            premix_block_params(weights_t, gammas_t, blk.conv2.weight, blk.conv2.bias)
            for blk in self.main
        ]

    def forward(self, parts, par, mixed, ops, gate=None, key_select=None):
        """``parts``: (lr, key_warp[, neighbour][, cur]) NHWC. conv(concat(parts))
        runs as a sum of per-part convs and the concat is never built.
        ``gate (b,)``: the align_key select, neighbour := where(gate, key_warp,
        neighbour), folded into the per-part kernels. ``mixed``: per block,
        this frame's premixed dynamic conv. ``key_select=(last_key, is_key)``
        folds the sweep's keyframe-carry select into the last block (JAX
        ``key_select``, bae.py:362-375) and returns ``(out, new_last_key)``."""
        conv = self.input_conv[0]
        ks = part_kernels(
            hwio(conv.weight), [p.shape[-1] for p in parts], parts[0].shape[0], gate
        )
        feat = ops.input_conv(parts, ks, conv.bias)
        last = len(self.main) - 1
        for i, (blk, m) in enumerate(zip(self.main, mixed)):
            feat = blk(feat, par, m, ops, key_select if i == last else None)
        return feat
