"""BasicVSR++ and its PQF-guided family (counterpart of
pnp_vcve_tpu/models/baselines/basicvsr_pp.py; reference basicvsr_pp.py:17-383
and basicvsr_pp_v2.py:17-852).

SPyNet flows between neighbouring frames, four propagation branches
(backward_1, forward_1, backward_2, forward_2), each step aligning the
first-order neighbour's feature and a second-order feature with a
flow-guided second-order deformable conv, then residual blocks over
[current feature, earlier branches, aligned]; a reconstruction head over all
branches, two x2 pixel-shuffle upsamplings, conv_hr and conv_last, plus the
frame (upsampled x4 under ``is_low_res_input``).

The JAX package runs each branch as an ``nn.scan`` whose carries hold the
second-order state; here a plain time loop carries the same state under the
same recurrences (``_sweep``):

- ``second_order='plain'`` (vanilla BasicVSR++, and branches 2 of
  ``'v2_withB_skip'``): the feature at lag 2 and the one-step composed flow
  ``flow_n1 + warp(flow_{n-1}, flow_n1)``;
- ``second_order='pqf'``: the most recent key frame (I/P slice, or B for
  branches 2 of ``'v2_onlyB_skip'``) at lag >= 2; the lag-2 slot promotes
  into it when it is a key. Its flow chain ``D`` folds one step at a time:
  ``'resample'`` (variant ``'base'``) warps ``D`` by each new flow and adds
  the newest flow at the end, the reference's quirk of resampling rather
  than composing (basicvsr_pp_v2.py:225-237); ``'compose'`` (the v2 family)
  is ``flow_n1 + warp(D, flow_n1)``.

Keys are routed per batch item, as in JAX; the reference reads batch item
0's slice types for every item (basicvsr_pp_v2.py:213; ROADMAP Queue C).
Backward branches run the same loop over time-reversed inputs. Step 0 of a
branch has no neighbour: JAX computes its alignment and discards it; the
loop skips it.

The 64-channel (any width that is a multiple of 8 on the card) feature
warps go through ``self.ops.flow_warp`` (K1 on the card, the plain version
on the CPU). The 2-channel flow warps of the chains and SPyNet's border
warp are the plain ``ops/warp.py: flow_warp``; the convolutions
(``ops/conv.py``, XLA's 'SAME' padding), the DCN
(``ops/deform_conv.py``), the resizes and the pixel shuffle are plain
PyTorch, as JAX computes them in XLA.

Parameters carry the reference's names (``feat_extract.main.*`` or, with
full-size input, ``feat_extract.{0,2}`` and ``feat_extract.4.main.*``;
``deform_align.<branch>.{weight,bias,conv_offset.{0,2,4,6}.*}``;
``backbone.<branch>.main.{0,2.<i>.conv1,2.<i>.conv2}.*``;
``reconstruction.main.*``; ``upsample{1,2}.upsample_conv.*``; ``conv_hr``;
``conv_last``; ``spynet.*``), so a reference state dict loads directly.

Layout NHWC: ``lrs (b, t, h, w, 3)``; ``slices (b, t)`` codes (73 'I',
80 'P', 66 'B').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pnp_vcve_torch.kernels import KERNELS
from pnp_vcve_torch.ops.conv import conv_same
from pnp_vcve_torch.ops.deform_conv import modulated_deform_conv2d
from pnp_vcve_torch.ops.resize import resize_bicubic
from pnp_vcve_torch.ops.upsample import bilinear_resize
from pnp_vcve_torch.ops.warp import flow_warp
from ..bae import hwio
from ..init import scaled_kaiming_normal_, torch_default_
from ..pnp_vcve import PixelShufflePack
from ..spynet import SPyNet

__all__ = [
    "BasicVSRPlusPlus", "BasicVSRPlusPlusPQF", "ResidualBlocksWithInputConv",
    "SecondOrderDeformableAlignment", "VARIANTS",
]

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
# variant -> {iteration: (second_order, flow_compose, keys: 'pqf' | 'b')}
# (basicvsr_pp_v2.py:17, 395, 504, 630)
VARIANTS = {
    "base": {1: ("pqf", "resample", "pqf"), 2: ("pqf", "resample", "pqf")},
    "v2": {1: ("pqf", "compose", "pqf"), 2: ("pqf", "compose", "pqf")},
    "v2_withB_skip": {1: ("pqf", "compose", "pqf"), 2: ("plain", "compose", "pqf")},
    "v2_onlyB_skip": {1: ("pqf", "compose", "pqf"), 2: ("pqf", "compose", "b")},
}


class ResidualBlockNoBN(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, 1, 1)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1)


class ResidualBlocksWithInputConv(nn.Module):
    """conv + leaky ReLU 0.1, then ``num_blocks`` residual blocks conv ->
    ReLU -> conv (reference basicvsr_net.py:393-429)."""

    def __init__(self, in_channels: int, out_channels: int = 64, num_blocks: int = 30):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(out_channels) for _ in range(num_blocks)]))

    def reset_parameters(self, generator: torch.Generator):
        """The reference's init: PyTorch's default on the input conv, the
        residual convs kaiming-normal x 0.1 with zero biases."""
        torch_default_(self.main[0], generator)
        for blk in self.main[2]:
            for conv in (blk.conv1, blk.conv2):
                scaled_kaiming_normal_(conv.weight, 0.1, generator)
                with torch.no_grad():
                    conv.bias.zero_()

    def forward(self, x):
        feat = F.leaky_relu(conv_same(x, self.main[0]), 0.1)
        for blk in self.main[2]:
            feat = feat + conv_same(F.relu(conv_same(feat, blk.conv1)), blk.conv2)
        return feat


class SecondOrderDeformableAlignment(nn.Module):
    """Flow-guided second-order DCN (reference basicvsr_pp_v2.py:790-852).

    ``x2c = cat(feat_prop, feat_n2)``, ``cond = cat(cond_n1, feat_cur,
    cond_n2)``: the offset head (three conv + leaky ReLU, then a conv to
    ``27 * groups``) on ``cat(cond, flow1, flow2)``; offsets
    ``max_residue_magnitude * tanh`` of its first two thirds, the first half
    of the groups (the feat_prop channels) plus flow1 and the second half
    plus flow2, each read as ``(groups / 2, 9, (dy, dx))``; the mask the
    sigmoid of the last third. The head's last conv starts at zero."""

    def __init__(self, channels: int = 64, deform_groups: int = 16,
                 max_residue_magnitude: float = 10.0):
        super().__init__()
        c = channels
        self.deform_groups = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.weight = nn.Parameter(torch.empty(c, 2 * c, 3, 3))
        self.bias = nn.Parameter(torch.empty(c))
        self.conv_offset = nn.Sequential(
            nn.Conv2d(3 * c + 4, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Conv2d(c, 27 * deform_groups, 3, 1, 1))

    def reset_parameters(self, generator: torch.Generator):
        torch_default_(self, generator)
        for i in (0, 2, 4):
            torch_default_(self.conv_offset[i], generator)
        with torch.no_grad():
            self.conv_offset[6].weight.zero_()
            self.conv_offset[6].bias.zero_()

    def forward(self, x2c, cond, flow1, flow2):
        b, h, w, _ = x2c.shape
        g = self.deform_groups
        y = torch.cat([cond, flow1, flow2], dim=-1)
        for i in (0, 2, 4):
            y = F.leaky_relu(conv_same(y, self.conv_offset[i]), 0.1)
        o1, o2, mask = conv_same(y, self.conv_offset[6]).chunk(3, dim=-1)
        off1, off2 = (self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], -1))).chunk(2, -1)
        off1 = off1.reshape(b, h, w, g // 2, 9, 2) + flow1.flip(-1)[:, :, :, None, None, :]
        off2 = off2.reshape(b, h, w, g // 2, 9, 2) + flow2.flip(-1)[:, :, :, None, None, :]
        offsets = torch.cat([off1, off2], dim=3)
        mask = torch.sigmoid(mask).reshape(b, h, w, g, 9)
        return modulated_deform_conv2d(x2c, offsets, mask, hwio(self.weight), self.bias)


class _BasicVSRPlusPlusBase(nn.Module):
    """The parameters, the features, the flows, the branches and the
    reconstruction shared by vanilla BasicVSR++ and the PQF family."""

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10.0, is_low_res_input: bool = True,
                 deform_groups: int = 16):
        super().__init__()
        c = mid_channels
        self.mid_channels = c
        self.is_low_res_input = is_low_res_input
        self.spynet = SPyNet()
        if is_low_res_input:
            self.feat_extract = ResidualBlocksWithInputConv(3, c, 5)
        else:
            self.feat_extract = nn.Sequential(
                nn.Conv2d(3, c, 3, 2, 1), nn.LeakyReLU(0.1), nn.Conv2d(c, c, 3, 2, 1),
                nn.LeakyReLU(0.1), ResidualBlocksWithInputConv(c, c, 5))
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(BRANCHES):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                c, deform_groups, max_residue_magnitude)
            self.backbone[name] = ResidualBlocksWithInputConv((2 + i) * c, c, num_blocks)
        self.reconstruction = ResidualBlocksWithInputConv(5 * c, c, 5)
        self.upsample1 = PixelShufflePack(c, 2)
        self.upsample2 = PixelShufflePack(c, 2, out_channels=64)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 3, 3, 1, 1)
        # the 64-channel feature warps (kernels.KERNELS or PLAIN)
        self.ops = KERNELS

    def reset_parameters(self, generator: torch.Generator):
        """Random init from ``generator``: PyTorch's default for the convs,
        the residual blocks' and the zero offset heads' as in the reference."""
        self.spynet.reset_parameters(generator)
        if self.is_low_res_input:
            self.feat_extract.reset_parameters(generator)
        else:
            torch_default_(self.feat_extract[0], generator)
            torch_default_(self.feat_extract[2], generator)
            self.feat_extract[4].reset_parameters(generator)
        for name in BRANCHES:
            self.deform_align[name].reset_parameters(generator)
            self.backbone[name].reset_parameters(generator)
        self.reconstruction.reset_parameters(generator)
        for conv in (self.upsample1.upsample_conv, self.upsample2.upsample_conv, self.conv_hr,
                     self.conv_last):
            torch_default_(conv, generator)

    def _warp(self, feat, flow):
        """A feature warp: K1 on the card."""
        return self.ops.flow_warp(feat.contiguous(), flow.contiguous())

    def _features(self, lrs):
        """``(feats (b, t, fh, fw, c), frames at the feature size)``."""
        b, t, h, w, c_in = lrs.shape
        flat = lrs.reshape(b * t, h, w, c_in)
        if self.is_low_res_input:
            return self.feat_extract(flat).reshape(b, t, h, w, -1), lrs
        fh, fw = h // 4, w // 4
        down = resize_bicubic(flat, (fh, fw)).reshape(b, t, fh, fw, c_in)
        fe = self.feat_extract
        y = F.leaky_relu(conv_same(flat, fe[0], 2), 0.1)
        y = F.leaky_relu(conv_same(y, fe[2], 2), 0.1)
        return fe[4](y).reshape(b, t, fh, fw, -1), down

    def _flows(self, down, mirror: bool = False):
        """SPyNet's ``(backward, forward)`` flows ``(b, t - 1, h, w, 2)``:
        backward[i] from frame i to i + 1, forward[i] from i + 1 to i (with
        ``mirror``, the backward flows reversed in time)."""
        b, t, h, w, c = down.shape
        prev = down[:, :-1].reshape(b * (t - 1), h, w, c)
        nxt = down[:, 1:].reshape(b * (t - 1), h, w, c)
        backward = self.spynet(prev, nxt).reshape(b, t - 1, h, w, 2)
        forward = backward.flip(1) if mirror else self.spynet(nxt, prev).reshape(b, t - 1, h, w, 2)
        return backward, forward

    def _sweep(self, name, feats, prev, flows, keys, flow_compose, second_order):
        """One branch over ``feats`` (t tensors ``(b, h, w, c)`` in sweep
        order) with ``prev`` (t stacks of the earlier branches, or None),
        ``flows`` (t - 1, step i takes ``flows[i - 1]``) and ``keys`` ((t, b)
        bool); returns the t outputs in sweep order."""
        align, backbone = self.deform_align[name], self.backbone[name]
        b, h, w, c = feats[0].shape
        zf = feats[0].new_zeros((b, h, w, c))
        zflow = feats[0].new_zeros((b, h, w, 2))
        no = torch.zeros(b, dtype=torch.bool, device=zf.device)
        # lag 1 (feat_prop, p_key), lag 2 (q_feat, q_key), the last flow, the
        # eligible second-order key (n2_feat, its flow chain, valid)
        feat_prop, p_key, q_feat, q_key, prev_flow = zf, no, zf, no, zflow
        n2_feat, n2_chain, n2_valid = zf, zflow, no
        outs = []
        for i in range(len(feats)):
            flow_n1 = flows[i - 1] if i else zflow
            if second_order == "plain":
                has_n2 = torch.full((b,), i >= 2, dtype=torch.bool, device=zf.device)
                full = flow_n1 + flow_warp(prev_flow, flow_n1)
                n2_feat = q_feat
            else:
                promote = q_key[:, None, None, None]
                n2_feat = torch.where(promote, q_feat, n2_feat)
                n2_valid = q_key | n2_valid
                chain_prev = torch.where(promote, prev_flow, n2_chain)
                if flow_compose == "compose":
                    n2_chain = flow_n1 + flow_warp(chain_prev, flow_n1)
                    full = n2_chain
                else:
                    n2_chain = flow_warp(chain_prev, flow_n1)
                    full = flow_n1 + n2_chain
                has_n2 = n2_valid & (i >= 2)
            m = has_n2[:, None, None, None]
            flow_n2 = torch.where(m, full, 0.0)
            feat_n2 = torch.where(m, n2_feat, 0.0)
            if i == 0:  # no neighbour: the zero carry passes
                new_prop = feat_prop
            else:
                cond_n1 = self._warp(feat_prop, flow_n1)
                cond_n2 = torch.where(m, self._warp(feat_n2, flow_n2), 0.0) if i >= 2 else zf
                new_prop = align(torch.cat([feat_prop, feat_n2], -1),
                                 torch.cat([cond_n1, feats[i], cond_n2], -1), flow_n1, flow_n2)
            parts = [feats[i]] + ([prev[i]] if prev is not None else []) + [new_prop]
            new_prop = new_prop + backbone(torch.cat(parts, -1))
            # the current frame becomes lag 1, lag 1 becomes lag 2
            q_feat, q_key, p_key, prev_flow = feat_prop, p_key, keys[i], flow_n1
            feat_prop = new_prop
            outs.append(new_prop)
        return outs

    def _propagate(self, feats, flows_backward, flows_forward, branch_cfg):
        """The four branches in order; ``branch_cfg[it] = (second_order,
        flow_compose, keys (b, t))``. Returns each branch's outputs as
        ``(b, t, h, w, c)``."""
        f_list = list(feats.unbind(1))
        bwd = list(flows_backward.unbind(1))
        fwd = list(flows_forward.unbind(1))
        outs = []
        for it in (1, 2):
            second_order, flow_compose, keys = branch_cfg[it]
            keys_t = keys.transpose(0, 1)
            for direction in ("backward", "forward"):
                prev = ([torch.cat(p, -1) for p in zip(*outs)] if outs else None)
                if direction == "backward":
                    out = self._sweep(f"backward_{it}", f_list[::-1],
                                      prev[::-1] if prev else None, bwd[::-1],
                                      keys_t.flip(0), flow_compose, second_order)[::-1]
                else:
                    out = self._sweep(f"forward_{it}", f_list, prev, fwd, keys_t,
                                      flow_compose, second_order)
                outs.append(out)
        return outs

    def _reconstruct(self, lrs, feats, branches):
        """The head over [features, the four branches], a frame at a time
        (each frame's convs are its own), plus the frame."""
        b, t, h, w, _ = lrs.shape
        ys = []
        for i in range(t):
            hr = torch.cat([feats[:, i]] + [br[i] for br in branches], -1)
            hr = self.reconstruction(hr)
            hr = F.leaky_relu(self.upsample1(hr), 0.1)
            hr = F.leaky_relu(self.upsample2(hr), 0.1)
            hr = F.leaky_relu(conv_same(hr, self.conv_hr), 0.1)
            hr = conv_same(hr, self.conv_last)
            if self.is_low_res_input:
                ys.append(hr + bilinear_resize(lrs[:, i], 4))
            else:  # full-size input: crop back to it
                ys.append(hr[:, :h, :w] + lrs[:, i])
        return torch.stack(ys, dim=1)


class BasicVSRPlusPlus(_BasicVSRPlusPlusBase):
    """Vanilla BasicVSR++ (reference basicvsr_pp.py:17-383): every branch
    ``second_order='plain'``. The downstream VSR of the ``--cascade``
    plug-and-play mode. ``is_mirror_extended=True`` (decided on the host by
    ``train/eval.py: is_mirror_extended``) reuses the backward flows
    reversed for the forward branches (:356-359)."""

    def forward(self, lrs, qps=None, slices=None, is_mirror_extended: bool = False, **_ignored):
        feats, down = self._features(lrs)
        bwd, fwd = self._flows(down, mirror=is_mirror_extended)
        keys = torch.ones(lrs.shape[:2], dtype=torch.bool, device=lrs.device)  # unused
        cfg = {it: ("plain", "compose", keys) for it in (1, 2)}
        return self._reconstruct(lrs, feats, self._propagate(feats, bwd, fwd, cfg))


class BasicVSRPlusPlusPQF(_BasicVSRPlusPlusBase):
    """The PQF-guided family (``variant``: ``'base'``, ``'v2'``,
    ``'v2_withB_skip'``, ``'v2_onlyB_skip'``; see ``VARIANTS``)."""

    def __init__(self, variant: str = "base", **kwargs):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        super().__init__(**kwargs)
        self.variant = variant

    def forward(self, lrs, qps=None, slices=None, **_ignored):
        b, t = lrs.shape[:2]
        feats, down = self._features(lrs)
        bwd, fwd = self._flows(down)
        if slices is None:
            keys = {"pqf": torch.ones((b, t), dtype=torch.bool, device=lrs.device),
                    "b": torch.zeros((b, t), dtype=torch.bool, device=lrs.device)}
        else:
            keys = {"pqf": (slices == 73.0) | (slices == 80.0), "b": slices == 66.0}
        cfg = {it: (so, fc, keys[k]) for it, (so, fc, k) in VARIANTS[self.variant].items()}
        return self._reconstruct(lrs, feats, self._propagate(feats, bwd, fwd, cfg))
