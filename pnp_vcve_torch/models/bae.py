"""BAE (bitstream-aware enhancement) blocks (counterpart of
pnp_vcve_tpu/models/bae.py:74-464), in every block form of the JAX module.

- The fused form (channel_first, one_layer, res_scale 1), with a dynamic
  conv2 and its SE gain or (``use_dynamic=False``, blocktype 'drt_woqp') a
  plain conv2 broadcast over the batch with gain 1, runs one K3 per block
  (``ops.drt_block``): the port of the JAX block's kernel guard
  (bae.py:177-191), which reaches ``drt_block_packed``.
- Every other form (``one_layer=False``: conv1 is a second expert bank with
  the same gain; ``channel_first=False``: conv1 first, then the dynamic conv
  and the partition path; ``res_scale != 1``) runs its 3x3 convs through K5
  (``ops.conv3x3``) and its partition path, ReLU and residual as torch ops,
  in the order and at the roundings of bae.py:193-228.

Parameters live under the original reference's names and layouts
(``input_conv.0``, ``main.{i}.conv2`` an expert bank ``(K, out, in, 3, 3)``
or, under 'drt_woqp', an ``nn.Conv2d``; ``main.{i}.conv1`` an ``nn.Conv2d``
or, with ``one_layer=False``, an expert bank; ``main.{i}.conv{16x16,16x8,8x8}``);
the compute goes through an ops namespace (``pnp_vcve_torch.kernels.KERNELS``
or ``PLAIN``) in the JAX package's layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.kernels import KERNELS
from pnp_vcve_torch.kernels.drt_stack import part_kernels, premix_block_params
from .init import kaiming_uniform_expert_, scaled_kaiming_normal_, torch_default_

__all__ = [
    "ExpertBank", "DRTBlock", "ResidualBlocksWithInputConvDynamicDRT", "hwio", "partition_path",
]


def hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> HWIO."""
    return w.permute(2, 3, 1, 0)


def _per_sample(conv: nn.Conv2d, b: int):
    """A shared conv's HWIO kernel and bias broadcast over ``b`` samples."""
    k = hwio(conv.weight)
    return k.expand(b, *k.shape), conv.bias.expand(b, -1)


def partition_path(feat, par, pk):
    """``sum_r (feat * par_r) @ pk[:, r]`` with float32 sums, in feat's type
    (JAX bae.py:193-208): ``par (b, h, w, 3)``, ``pk (c, 3, c)``."""
    out = None
    for r in range(3):
        gated = feat * par[..., r : r + 1].to(feat.dtype)
        term = torch.einsum("bhwi,io->bhwo", gated, pk[:, r].to(feat.dtype)).float()
        out = term if out is None else out + term
    return out.to(feat.dtype)


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
    ``ResidualBlockNoBNDynamic_drt``; JAX ``DRTBlock``). channel_first:
    ``x + res_scale * conv1(relu(dyn_conv(x) + dyres(x)))``; otherwise
    ``x + res_scale * (dyn_conv(h) + dyres(h))``, ``h = relu(conv1(x))``;
    ``dyres(f) = sum_r par_r * conv1x1_r(f)``. The gain ``gamma`` scales each
    dynamic conv (conv2, and conv1 when it is an expert bank) after its bias,
    and only with ``with_se`` and ``use_dynamic``."""

    def __init__(self, mid_channels=64, num_experts=6, with_se=True, one_layer=True,
                 channel_first=True, res_scale=1.0, use_dynamic=True):
        super().__init__()
        c = mid_channels
        self.mid_channels = c
        self.with_se = with_se
        self.one_layer = one_layer
        self.channel_first = channel_first
        self.res_scale = res_scale
        self.use_dynamic = use_dynamic
        # the form K3 computes whole; the others run their convs through K5
        self.fused = one_layer and channel_first and res_scale == 1.0
        self.conv2 = ExpertBank(c, num_experts) if use_dynamic else nn.Conv2d(c, c, 3, 1, 1)
        self.conv1 = nn.Conv2d(c, c, 3, 1, 1) if one_layer else ExpertBank(c, num_experts)
        self.conv16x16 = nn.Conv2d(c, c, 1, bias=False)
        self.conv16x8 = nn.Conv2d(c, c, 1, bias=False)
        self.conv8x8 = nn.Conv2d(c, c, 1, bias=False)

    def reset_parameters(self, generator):
        """The JAX schemes (bae.py:95-117): expert banks kaiming-uniform per
        expert with zero bias banks; plain 3x3 convs and the partition 1x1s
        kaiming-normal x 0.1 with zero biases."""
        for conv in (self.conv2, self.conv1):
            if isinstance(conv, ExpertBank):
                conv.reset_parameters(generator)
            else:
                scaled_kaiming_normal_(conv.weight, 0.1, generator)
                with torch.no_grad():
                    conv.bias.zero_()
        for conv in (self.conv16x16, self.conv16x8, self.conv8x8):
            scaled_kaiming_normal_(conv.weight, 0.1, generator)

    def par_kernel(self) -> torch.Tensor:
        """The three 1x1 partition convs as one ``(in, 3, out)`` kernel."""
        return torch.stack(
            [c.weight[:, :, 0, 0].t() for c in (self.conv16x16, self.conv16x8, self.conv8x8)],
            dim=1,
        )

    def premix(self, weights, gammas=None):
        """This block's per-sample convs from ``weights (..., K)`` routing and
        ``gammas (..., c)`` (or None): ``{w2 (..., 3, 3, c, c), b2 (..., c),
        g (..., c)}`` float32, plus ``w1``/``b1`` when conv1 is an expert bank.
        Under 'drt_woqp' w2 and b2 are the plain conv2 broadcast, and g is 1
        (JAX bae.py:119-126, :135-136)."""
        lead, c = weights.shape[:-1], self.mid_channels
        if self.with_se and self.use_dynamic and gammas is not None:
            g = gammas.float()
        else:
            g = torch.ones((*lead, c), device=weights.device)
        if self.use_dynamic:
            m = premix_block_params(weights, g, self.conv2.weight, self.conv2.bias)
        else:
            k = hwio(self.conv2.weight).float()
            m = dict(w2=k.expand(*lead, *k.shape), b2=self.conv2.bias.float().expand(*lead, c),
                     g=g)
        if not self.one_layer:
            k1 = premix_block_params(weights, g, self.conv1.weight, self.conv1.bias)
            m.update(w1=k1["w2"], b1=k1["b2"])
        return m

    def forward(self, x, par, weights=None, gamma=None, *, mixed=None, ops=KERNELS,
                key_select=None):
        """JAX's call form ``block(x, par, weights (b, K), gamma (b, c) or
        None)`` mixes this block's experts; the sweeps pass this frame's
        ``mixed=premix(...)`` instead. ``x (b, h, w, c)``, ``par (b, h, w, 3)``.
        With ``key_select=(last_key, is_key)`` (fused form only) the block also
        returns the keyframe carry ``where(is_key, out, last_key)`` (K3s)."""
        m = self.premix(weights, gamma) if mixed is None else mixed
        if self.fused:
            args = (x, par, m["w2"], m["b2"], m["g"],
                    self.par_kernel(), hwio(self.conv1.weight), self.conv1.bias)
            if key_select is not None:
                return ops.drt_block_select(*args, *key_select)
            return ops.drt_block(*args)
        if key_select is not None:
            raise ValueError("key_select needs the fused block form "
                             "(one_layer, channel_first, res_scale 1)")
        pk = self.par_kernel()

        def dyn(f):
            return ops.conv3x3(f, m["w2"], m["b2"], m["g"])

        def conv1(f):
            if self.one_layer:
                return ops.conv3x3(f, *_per_sample(self.conv1, f.shape[0]))
            return ops.conv3x3(f, m["w1"], m["b1"], m["g"])

        if self.channel_first:
            out = conv1(torch.relu(dyn(x) + partition_path(x, par, pk)))
        else:
            out = torch.relu(conv1(x))
            out = dyn(out) + partition_path(out, par, pk)
        return x + out * self.res_scale


class ResidualBlocksWithInputConvDynamicDRT(nn.Module):
    """3x3 input conv + LeakyReLU(0.1) + N DRT blocks (reference
    basicvsr_net.py:478-519)."""

    def __init__(self, in_channels, out_channels=64, num_blocks=8, num_experts=6, with_se=True,
                 one_layer=True, channel_first=True, use_dynamic=True):
        super().__init__()
        self.input_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1),
            nn.LeakyReLU(0.1),
        )
        self.main = nn.ModuleList(
            DRTBlock(out_channels, num_experts, with_se=with_se, one_layer=one_layer,
                     channel_first=channel_first, use_dynamic=use_dynamic)
            for _ in range(num_blocks)
        )

    def reset_parameters(self, generator):
        torch_default_(self.input_conv[0], generator)
        for blk in self.main:
            blk.reset_parameters(generator)

    def premix(self, weights_t, gammas_t):
        """Every block's expert mixing for all frames at once (hoisted out of
        the sweep): ``weights_t (t, b, K)``, ``gammas_t (t, b, c)`` -> one dict
        of ``(t, b, ...)`` tensors per block (``(b, K)``/``(b, c)`` give one
        frame's)."""
        return [blk.premix(weights_t, gammas_t) for blk in self.main]

    def forward(self, x, par, mixed, ops, gate=None, key_select=None):
        """``x``: (lr, key_warp[, neighbour][, cur]) NHWC parts, or one
        ``(b, h, w, in_channels)`` tensor (JAX bae.py:422-423; its conv runs
        through K5). conv(concat(parts)) runs as a sum of per-part convs (K2)
        and the concat is never built. ``gate (b,)``: the align_key select,
        neighbour := where(gate, key_warp, neighbour), folded into the
        per-part kernels. ``mixed``: per block, this frame's premix.
        ``key_select=(last_key, is_key)`` folds the sweep's keyframe-carry
        select into the last block (JAX ``key_select``, bae.py:362-375) and
        returns ``(out, new_last_key)``."""
        conv = self.input_conv[0]
        if isinstance(x, torch.Tensor):
            if gate is not None:
                raise ValueError("align_gate requires the parts form of x")
            feat = F.leaky_relu(ops.conv3x3(x, *_per_sample(conv, x.shape[0])), 0.1)
        else:
            ks = part_kernels(hwio(conv.weight), [p.shape[-1] for p in x], x[0].shape[0], gate)
            feat = ops.input_conv(x, ks, conv.bias)
        last = len(self.main) - 1
        for i, (blk, m) in enumerate(zip(self.main, mixed)):
            feat = blk(feat, par, mixed=m, ops=ops, key_select=key_select if i == last else None)
        return feat
