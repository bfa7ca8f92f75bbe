"""PnP-VCVE flagship generator: CAA predictors + bidirectional BAE
(counterpart of pnp_vcve_tpu/models/pnp_vcve.py).

Reference model ``IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par``
in every form the JAX builder accepts. As in the JAX package:

- keyframes come from the slice codes (73 'I' and 80 'P', first and last
  frame forced), through cumulative scans (:func:`keyframe_indices`), or
  from an explicit ``keyframe_mask`` (a chunk boundary is not a clip
  boundary);
- each sweep carries only ``(prev_out, last_key, prev_was_key)``: in sweep
  order the nearest keyframe is the last one processed, so no feature store
  is carried; the backward sweep's outputs feed the forward sweep as ``cur``;
- the expert mixing of every block is hoisted out of both sweeps (premix);
- the align_key select rides the input conv as per-sample kernel gains;
- inputs whose size is not a multiple of 4 are reflect-padded (MVs and
  partitions zero-padded) and the output cropped back (to 4x the input
  under ``vsr``).

The sweeps are Python loops over t. Each step runs the kernels of
``self.ops`` (``pnp_vcve_torch.kernels.KERNELS`` by default): the warp, the
input conv, ``num_blocks`` DRT blocks and, in the forward sweep, the head.
The blocks take the form ``blocktype``, ``one_layer`` and ``channel_first``
give them (models/bae.py): one K3 each in the fused forms (the flagship,
and 'drt_woqp' with its plain conv2), K5 for each 3x3 conv in the others.

The keyframe aligner (``_align``, JAX pnp_vcve.py:140-169):

- ``warp_impl='pf'`` (the serving config): K1b on each 8x8 block's flow
  clamped to +-16 px; the last DRT block of every step is K3s, which also
  writes the keyframe carry (JAX ``_kernel_select``). Needs
  ``use_pallas_kernels``, deform='vos', vsr=False, the fused block form,
  64 channels and h, w multiples of 16 (JAX's guards, :530-546, and
  bae.py:391-395);
- ``deform='basic'`` / ``'fvc'`` (models/alignment.py): the DCN aligners,
  plain PyTorch around K1 (basic's pre-warp, when bilinear); each sweep owns
  its aligner, as in JAX (the reference shares one; core/convert.py writes
  it into both);
- ``flow_interpolation='nearest'``: the plain nearest warp, as in JAX;
- ``warp_impl='block8'``: K1b on each block's flow, unclamped (K1 where h
  or w is not a multiple of 8);
- anything else (``'padgather'``, training): K1 on the per-pixel flow.

Outside ``'pf'`` the carry update is K3 plus a ``torch.where``, as on the
JAX default path. Both routes give the same bits; JAX's
``PNP_PF_FOLD_SELECT`` only chose between them for the TPU's DMA balance.
With ``remat`` (the default, as in the JAX package's ``nn.remat`` of each
scan step, pnp_vcve.py:520-521) a step that records a graph keeps only its
inputs and runs again in the backward, kernels included.

``vsr=True`` (JAX :360-369): the step output goes through ``upsample1`` and
``upsample2`` (conv c -> 4c, pixel shuffle x2, leaky ReLU), then conv_hr ->
leaky ReLU -> conv_last at 4h x 4w, which is K4's function (``ops.head``),
plus the bilinear x4 of the frame.

``sweep``, ``carry``, ``bwd_feats`` and ``keyframe_mask`` drive the exact
chunked two-sweep pipeline (JAX :430-444, 549-601), see :meth:`forward`.

Inputs are NHWC: ``lrs (b,t,h,w,3)``, ``mvs (b,t,h,w,4)`` (fwd x,y, bwd x,y),
``par_map (b,t,h,w,3)``, scalars ``qps/slices/base_qps (b,t)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pnp_vcve_torch.kernels import KERNELS
from pnp_vcve_torch.ops.dynamic_conv import conv2d_nhwc
from pnp_vcve_torch.ops.upsample import bilinear_resize, pixel_shuffle
from pnp_vcve_torch.ops.warp import PF_MAX_MV, flow_warp
from .alignment import BasicDeformableAlignment, FVCDeformableAlignment
from .bae import ResidualBlocksWithInputConvDynamicDRT, hwio
from .caa import BasePredictor, BiasPredictor, SEModule
from .init import torch_default_

__all__ = ["PnPVCVE", "keyframe_indices"]

I_SLICE = 73.0  # ord('I')
P_SLICE = 80.0  # ord('P')


def keyframe_indices(slices: torch.Tensor):
    """``slices (b, t)`` codes -> ``(keyframe (b,t) bool, key_fwd, key_bwd)``
    where ``key_fwd[b, i]`` is the nearest keyframe strictly before i (valid
    for i >= 1) and ``key_bwd[b, i]`` the nearest strictly after (valid for
    i <= t-2)."""
    b, t = slices.shape
    keyframe = (slices == I_SLICE) | (slices == P_SLICE)
    keyframe[:, 0] = True
    keyframe[:, -1] = True
    iota = torch.arange(t, device=slices.device).expand(b, t)
    before = torch.cummax(torch.where(keyframe, iota, -1), dim=1).values
    key_fwd = torch.cat([torch.zeros_like(before[:, :1]), before[:, :-1]], dim=1)
    after = torch.cummin(torch.where(keyframe, iota, t).flip(1), dim=1).values.flip(1)
    key_bwd = torch.cat([after[:, 1:], torch.full_like(after[:, :1], t - 1)], dim=1)
    return keyframe, key_fwd, key_bwd


def _pad_hw(x: torch.Tensor, pad_h: int, pad_w: int, mode: str) -> torch.Tensor:
    """Pad (b, t, h, w, c) at the bottom and right."""
    b, t, h, w, c = x.shape
    y = F.pad(x.reshape(b * t, h, w, c).permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode=mode)
    return y.permute(0, 2, 3, 1).reshape(b, t, h + pad_h, w + pad_w, c)


def _time_major(x: torch.Tensor, dtype) -> torch.Tensor:
    """(b, t, ...) -> contiguous (t, b, ...) in ``dtype``, one frame per index."""
    return x.to(dtype).transpose(0, 1).contiguous()


class PixelShufflePack(nn.Module):
    """Conv c -> out * r * r (out = c unless given), then pixel shuffle x r
    (the reference's ``PixelShufflePack``, parameters ``upsample_conv.*``)."""

    def __init__(self, channels: int, scale: int = 2, out_channels: int | None = None):
        super().__init__()
        self.scale = scale
        out = channels if out_channels is None else out_channels
        self.upsample_conv = nn.Conv2d(channels, out * scale * scale, 3, 1, 1)

    def forward(self, x):
        conv = self.upsample_conv
        return pixel_shuffle(conv2d_nhwc(x, hwio(conv.weight), conv.bias), self.scale)


class PnPVCVE(nn.Module):
    """Flagship generator (config configs/HR_davis_LR_128x128.py)."""

    def __init__(
        self,
        mid_channels: int = 64,
        num_blocks: int = 8,
        num_experts: int = 6,
        expert_softmax: bool = True,
        use_base_qp: bool = True,
        with_bias: bool = True,
        with_se: bool = True,
        with_cat: bool = True,
        one_layer: bool = True,
        channel_first: bool = True,
        blocktype: str = "drt",
        align_key: bool = True,
        vsr: bool = False,
        flow_interpolation: str = "bilinear",
        deform: str = "vos",
        deform_groups: int = 16,
        feature_dtype: torch.dtype = torch.float32,
        remat: bool = True,
        warp_impl: str = "padgather",
        use_pallas_kernels: bool = False,
    ):
        super().__init__()
        c = mid_channels
        self.mid_channels = c
        self.use_base_qp = use_base_qp
        self.with_bias = with_bias
        self.with_se = with_se
        self.with_cat = with_cat
        # the block form (JAX pnp_vcve.py:497-512): 'drt' mixes experts in
        # conv2; any other blocktype is 'drt_woqp', a plain conv2, as in JAX
        self.use_dynamic = blocktype == "drt"
        self.fused_blocks = one_layer and channel_first
        self.align_key = align_key
        self.vsr = vsr
        self.flow_interpolation = flow_interpolation
        self.deform = deform
        self.feature_dtype = feature_dtype
        self.remat = remat
        self.warp_impl = warp_impl
        # the JAX serving flag: 'pf' refuses to run without it; on the port
        # every CUDA tensor takes the kernels whatever it says
        self.use_pallas_kernels = use_pallas_kernels
        # the kernels every sweep step runs (kernels.KERNELS or PLAIN)
        self.ops = KERNELS

        self.BasePredictor = BasePredictor(c, num_experts, expert_softmax)
        if with_bias:
            self.BiasePredictor = (
                SEModule(c) if with_se
                else BiasPredictor(c)
            )
        n_feat = 2 if with_cat else 1  # key warp (+ neighbour)
        blocks = dict(with_se=with_se, one_layer=one_layer, channel_first=channel_first,
                      use_dynamic=self.use_dynamic)
        self.backward_resblocks = ResidualBlocksWithInputConvDynamicDRT(
            3 + c * n_feat, c, num_blocks, num_experts, **blocks
        )
        self.forward_resblocks = ResidualBlocksWithInputConvDynamicDRT(
            3 + c * (n_feat + 1), c, num_blocks, num_experts, **blocks
        )
        # each sweep's keyframe aligner (None: the flow warp)
        aligners = {
            "basic": lambda: BasicDeformableAlignment(c, deform_groups, flow_interpolation),
            "fvc": lambda: FVCDeformableAlignment(c, deform_groups),
        }
        if deform != "vos" and deform not in aligners:
            raise ValueError(f"No such DCN type: {deform!r}")
        make = aligners.get(deform)
        self.backward_deform_align = make() if make else None
        self.forward_deform_align = make() if make else None
        if vsr:
            # the reference hardcodes 64-channel heads (iconvsr.py:365-366);
            # identical at mid_channels=64, parameterized as in JAX
            self.upsample1 = PixelShufflePack(c)
            self.upsample2 = PixelShufflePack(c)
        self.conv_hr = nn.Conv2d(c, c, 3, 1, 1)
        self.conv_last = nn.Conv2d(c, 3, 3, 1, 1)

    def carry_feature_shape(self, h: int, w: int) -> tuple:
        """Per-clip shape of a carry's feature tensors and of one backward
        feature frame at (padded) size (h, w): NHWC under every warp_impl
        (JAX packs the 'pf' carry in its pixel-pair layout instead)."""
        return (h, w, self.mid_channels)

    def reset_parameters(self, generator: torch.Generator):
        """Random init from ``generator`` (the reference's init for the
        expert banks and DRT convs, PyTorch's default elsewhere)."""
        self.BasePredictor.reset_parameters(generator)
        if self.with_bias:
            self.BiasePredictor.reset_parameters(generator)
        self.backward_resblocks.reset_parameters(generator)
        self.forward_resblocks.reset_parameters(generator)
        for m in (self.backward_deform_align, self.forward_deform_align):
            if m is not None:
                m.reset_parameters(generator)
        if self.vsr:
            torch_default_(self.upsample1.upsample_conv, generator)
            torch_default_(self.upsample2.upsample_conv, generator)
        torch_default_(self.conv_hr, generator)
        torch_default_(self.conv_last, generator)

    def _align(self, aligner, last_key, flow):
        """The keyframe aligner (module docstring); ``aligner`` is the
        sweep's DCN aligner or None."""
        h, w = flow.shape[1:3]
        if self.warp_impl == "pf":
            return self.ops.flow_warp_block(last_key, flow, PF_MAX_MV)
        if aligner is not None:
            return aligner(last_key, flow, self.ops)
        if self.flow_interpolation != "bilinear":
            return flow_warp(last_key, flow, self.flow_interpolation)
        if self.warp_impl == "block8" and h % 8 == 0 and w % 8 == 0:
            return self.ops.flow_warp_block(last_key, flow, None)
        return self.ops.flow_warp(last_key, flow)

    def _head(self, out, lr):
        """The forward step's reconstruction: K4 on the step output (at 4x
        after the upsampling under ``vsr``) plus the frame."""
        ops = self.ops
        if self.vsr:
            out = F.leaky_relu(self.upsample1(out), 0.1)
            out = F.leaky_relu(self.upsample2(out), 0.1)
            lr = bilinear_resize(lr, 4)
        return ops.head(out, hwio(self.conv_hr.weight), self.conv_hr.bias,
                        hwio(self.conv_last.weight), self.conv_last.bias) + lr

    def _step(self, resblocks, aligner, lr, flow, par, is_key, mixed, prev_out, last_key,
              prev_was_key, cur):
        """One sweep step -> ``(out, new last_key, head output or None)``."""
        ops = self.ops
        # the zero carry warps to zero: no masking of the first step
        parts = [lr, self._align(aligner, last_key, flow)]
        if self.with_cat:
            parts.append(prev_out)
        if cur is not None:
            parts.append(cur)
        gate = prev_was_key.float() if (self.align_key and self.with_cat) else None
        if self.warp_impl == "pf" and len(resblocks.main):
            # the carry select folded into the last block (K3s)
            out, last_key = resblocks(parts, par, mixed, ops, gate,
                                      key_select=(last_key, is_key.float()))
        else:
            out = resblocks(parts, par, mixed, ops, gate)
            last_key = torch.where(is_key[:, None, None, None], out, last_key)
        y = None if cur is None else self._head(out, lr)
        return out, last_key, y

    def _sweep(self, resblocks, aligner, lrs, flows, par, keyframe, mixed, cur=None,
               carry=None):
        """One propagation sweep over the frames in list order from ``carry``
        (zeros if None); returns the per-step block-stack outputs without
        ``cur`` (the backward sweep's, which the forward sweep reads), the
        heads' outputs with it (the forward sweep keeps only its carry: at
        b=4, 8 frames of 720p in float32 its step outputs would hold 7.5 GB
        more), and the carry out."""
        if carry is None:
            zero = torch.zeros(lrs[0].shape[:3] + (self.mid_channels,),
                               dtype=lrs.dtype, device=lrs.device)
            carry = (zero, zero, torch.zeros(lrs.shape[1], dtype=torch.bool, device=lrs.device))
        prev_out, last_key, prev_was_key = carry
        remat = self.remat and torch.is_grad_enabled()
        outs, ys = [], []
        for i in range(lrs.shape[0]):
            args = (resblocks, aligner, lrs[i], flows[i], par[i], keyframe[i],
                    [{k: v[i] for k, v in m.items()} for m in mixed],
                    prev_out, last_key, prev_was_key, None if cur is None else cur[i])
            if remat:
                out, last_key, y = checkpoint(self._step, *args, use_reentrant=False)
            else:
                out, last_key, y = self._step(*args)
            prev_out, prev_was_key = out, keyframe[i]
            if y is None:
                outs.append(out)
            else:
                ys.append(y)
        return outs, ys, (prev_out, last_key, prev_was_key)

    def forward(self, lrs, qps, slices, mvs, base_qps, par_map,
                is_mirror_extended: bool = False, sweep: str = "full", carry=None,
                bwd_feats=None, keyframe_mask=None):
        """``(b, t, h, w, 3)`` float32 frames (``4h x 4w`` under ``vsr``).

        The chunk API (JAX :430-444): ``sweep='backward'`` runs only the
        backward propagation from ``carry`` and returns ``(bwd_feats (b, t,
        h, w, c) in the feature type, carry_out)``; ``sweep='forward'``
        consumes a chunk's ``bwd_feats`` and returns ``(ys, carry_out)``.
        ``carry`` is ``(prev_out, last_key, prev_was_key)``, ``(b, h, w, c)``
        twice (the padded size) and ``(b,)`` bool, or None for zeros.
        ``keyframe_mask (b, t)`` replaces the keyframes of the slice codes and
        their forced first and last frames. ``sweep='full'`` runs both sweeps
        from the same ``carry``."""
        if sweep not in ("full", "backward", "forward"):
            raise ValueError(f"sweep must be 'full', 'backward' or 'forward', got {sweep!r}")
        if sweep == "forward" and bwd_feats is None:
            raise ValueError("sweep='forward' requires bwd_feats")
        b, t, h_in, w_in, _ = lrs.shape
        # pad to x4 (reference spatial_padding: reflect lrs bottom/right); the
        # priors are zero-padded (zero motion, no partition), output cropped
        pad_h, pad_w = (4 - h_in % 4) % 4, (4 - w_in % 4) % 4
        if pad_h or pad_w:
            lrs = _pad_hw(lrs, pad_h, pad_w, "reflect")
            mvs = _pad_hw(mvs, pad_h, pad_w, "constant")
            par_map = _pad_hw(par_map, pad_h, pad_w, "constant")
        c = self.mid_channels
        h, w = lrs.shape[2:4]
        if self.warp_impl == "pf":
            # the JAX model's guards for its PF-resident serving pipeline
            if self.vsr or self.deform != "vos" or not self.use_pallas_kernels:
                raise ValueError(
                    "warp_impl='pf' requires use_pallas_kernels=True, deform='vos', vsr=False"
                )
            if not self.fused_blocks:  # JAX bae.py:391-395
                raise ValueError(
                    "PF-resident parts require the fused Pallas input-stack path "
                    "(use_pallas + one_layer + channel_first + aligned shapes)"
                )
            if c != 64 or h % 16 or w % 16:
                raise ValueError(
                    f"warp_impl='pf' needs mid_channels=64 and h,w % 16 == 0, got c={c}, {h}x{w}"
                )

        # the routing and the gains a frame at a time: each call then has the
        # same shapes, and gives the same bits, whatever the length of the
        # clip or chunk (on the CPU a matmul over 2 rows rounds otherwise than
        # over 8), so the exact pipeline equals the full sweep bit for bit
        q = base_qps if self.use_base_qp else qps
        weights = torch.cat([self.BasePredictor(q[:, i:i + 1]) for i in range(t)], 1)
        if self.with_bias and self.with_se and self.use_dynamic:
            gammas = torch.cat([self.BiasePredictor(qps[:, i:i + 1])[0] for i in range(t)], 1)
        else:  # the gain applies only to the with_se dynamic blocks (JAX bae.py:169)
            gammas = torch.ones((b, t, c), device=lrs.device)

        # forward step i warps with mvs[:, i, ..., 0:2], backward step i with
        # mvs[:, i, ..., 2:4]
        flows_fwd = mvs[..., 0:2]
        flows_bwd = mvs[..., 2:4]
        if is_mirror_extended:
            if t > 2:
                raise NotImplementedError(
                    "mirror-extended clips of more than 2 frames: the JAX package's "
                    "mirrored flow layout has t // 2 + 1 forward flows "
                    "(ROADMAP Queue C)"
                )
            # forward step i uses the backward flows of the mirrored frame
            th = t // 2
            fwd_tail = flows_fwd[:, th:].flip(1)
            flows_fwd = torch.cat([flows_bwd[:, :1] * 0, fwd_tail[:, : t - 1]], 1)

        keyframe = (keyframe_mask.bool() if keyframe_mask is not None
                    else keyframe_indices(slices)[0]).transpose(0, 1)  # (t, b)
        dtype = self.feature_dtype
        lrs_t = _time_major(lrs, dtype)
        par_t = _time_major(par_map, dtype)
        # flows in the feature type before the warp, as the JAX path casts them
        fwd_t = _time_major(flows_fwd, dtype)
        bwd_t = _time_major(flows_bwd, dtype)
        wt = weights.float().transpose(0, 1)
        gt = gammas.float().transpose(0, 1)

        if sweep == "forward":
            cur = _time_major(bwd_feats, dtype)
        else:
            mixed_b = self.backward_resblocks.premix(wt, gt)
            bwd_outs, _, carry_b = self._sweep(
                self.backward_resblocks, self.backward_deform_align, lrs_t.flip(0),
                bwd_t.flip(0), par_t.flip(0), keyframe.flip(0),
                [{k: v.flip(0) for k, v in m.items()} for m in mixed_b], carry=carry,
            )
            cur = bwd_outs[::-1]  # back to time order
            if sweep == "backward":
                return torch.stack(cur, dim=1), carry_b
        mixed_f = self.forward_resblocks.premix(wt, gt)
        _, ys, carry_f = self._sweep(
            self.forward_resblocks, self.forward_deform_align, lrs_t, fwd_t, par_t, keyframe,
            mixed_f, cur=cur, carry=carry,
        )
        s = 4 if self.vsr else 1
        out = torch.stack(ys, dim=1).float()[:, :, : s * h_in, : s * w_in]
        return (out, carry_f) if sweep == "forward" else out
