"""K2-K4: the BAE input conv, the DRT block and the reconstruction head
(csrc/input_conv.cu, csrc/drt_block.cu, csrc/head.cu), and the expert premix.

They replace, in ``pnp_vcve_tpu/kernels/drt_stack.py``:

- ``input_conv_pf`` (:649) -> :func:`input_conv` (K2);
- ``_drt_block_pf`` (:305), chained 8x per step -> :func:`drt_block` (K3);
- the same block's per-block kernels ``pnp_vcve_tpu/kernels/drt_packed.py:
  drt_block_packed`` (:149, which JAX's ``DRTBlock`` reaches through its
  kernel guard, models/bae.py:177-191) and ``conv_block.py:
  drt_block_pallas`` (:180) -> :func:`drt_block` too, their arguments
  ``(x, par, dyn_kernels, dyn_biases, par_kernel, conv1_kernel, conv1_bias,
  gamma)`` reordered to ``(x, par, dyn_kernels, dyn_biases, gamma,
  par_kernel, conv1_kernel, conv1_bias)``;
- its key-select variant ``_kernel_select`` (:278, launched at :351), the
  last block of a ``'pf'`` step -> :func:`drt_block_select` (K3s, a second
  entry of the same kernel);
- ``head_pf`` (:1058) -> :func:`head` (K4).

The TPU kernels' pixel-pair packed layout and band DMAs are not carried
over: the kernels take the NHWC tensors as they are, for any h and w and any
width c that is a multiple of 8, in float32 or bfloat16 with float32 sums.
K2, K3 and K4 run on the tensor cores: bfloat16 features with bfloat16
weights, float32 features in 3xTF32 (:func:`tf32_split`). At 64 channels,
the width of every model path, each runs a wgmma design
(``csrc/input_conv.cu: input_conv_wg``, ``drt_block.cu: drt_block_wg``,
``head.cu: head_wg``; ``launch.kernel_design`` says which width takes
which), whose weights the wrapper packs into the shared-memory images its
bulk copies move (:func:`wg_image`; K4's c -> 3 stage as
:func:`head_last_image`) and whose persistent blocks walk the output tiles
(:func:`wg_tile_walk`: 14 x 30 for K3 and K4, ``IC_TILE`` for K2); at any
other width an implicit GEMM on ``mma.sync`` (``csrc/tc_conv.cuh``). K4's
W_hr goes to the kernel as two terms in both types (:func:`bf16_split` in
bfloat16) and its hidden map stays float32. K3 and K4 keep their hidden map
on the chip up to ``launch.ONE_LAUNCH_WIDTH`` and run as two launches
through a scratch tensor above it (:func:`.launch.launch_form`). The source notes
in ``csrc/`` say how each tiles its work.
:func:`input_conv_args`, :func:`drt_block_args` and :func:`head_args` hold
the checks a launch makes of the shapes and the width, and the weight
repacking; they run on any device.

Each wrapper has a plain PyTorch version beside it (``*_plain``), the XLA
composition of the JAX package written in PyTorch (``_xla_input_stack_compose``
:861, ``_xla_block_compose`` :780, ``_xla_head`` :1116). Weights are given as
in the JAX package: HWIO 3x3 kernels, per-sample ones with a leading batch
axis, the partition kernel as ``(c, 3, c)``.

On CUDA tensors each launch runs inside a ``torch.autograd.Function``
(:class:`InputConvFunction`, :class:`DRTBlockFunction`,
:class:`DRTBlockSelectFunction`, :class:`HeadFunction`) that saves these
JAX-layout arguments and takes its gradients from the plain version
(``launch.plain_grads``), as the JAX package's trainable stacks do (:803,
:891, :1253). The wrappers' weight
repacking (the taps transposed, rounded to bfloat16 or split for 3xTF32)
runs inside the forward,
out of autograd's sight; the gradients reach the repacked weights' sources
(the premix, the conv weights) through the JAX-layout arguments.

Each launch is the CUDA implementation of a registered op
(``torch.ops.pnp_vcve.input_conv``, ``drt_block``, ``drt_block_select``,
``head``; :mod:`.ops_registry`), whose CPU implementation is the plain
version. The ops take the JAX-layout arguments, and the repacking stays
inside the launch. Where no gradient is recorded, a wrapper calls its op
directly, so that ``torch.export`` puts the op in the graph.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from pnp_vcve_torch.ops.dynamic_conv import (
    conv2d_f32,
    conv2d_nhwc,
    dynamic_conv2d,
    per_sample_conv,
)
from .launch import (
    check_cuda_args,
    check_width,
    kernel_design,
    launch,
    launch_form,
    on_cpu,
    plain_grads,
)
from .ops_registry import flop_per_pixel, register, tracks_grad

__all__ = [
    "tf32_split",
    "bf16_split",
    "tc_weights",
    "premix_block_params",
    "part_kernels",
    "input_conv",
    "input_conv_plain",
    "drt_block",
    "drt_block_plain",
    "drt_block_select",
    "drt_block_select_plain",
    "head",
    "head_plain",
    "InputConvFunction",
    "DRTBlockFunction",
    "DRTBlockSelectFunction",
    "HeadFunction",
    "input_conv_args",
    "drt_block_args",
    "drt_block_select_args",
    "head_args",
    "WG_TILE",
    "IC_TILE",
    "wg_image",
    "head_last_image",
    "wg_tile_walk",
]


def premix_block_params(weights_t, gammas_t, bank, bias_bank):
    """One block's expert-mixed dynamic conv for all frames at once, hoisted
    out of both sweeps (JAX ``premix_block_params`` :1345, without the PF
    packing): ``weights_t (..., E)`` routing (``(t, b, E)`` in the sweeps),
    ``gammas_t (..., c)`` gains, ``bank (E, c_out, c_in, 3, 3)`` and
    ``bias_bank (E, c_out)`` as stored under the reference names ->
    ``{w2 (..., 3, 3, c_in, c_out), b2 (..., c), g (..., c)}`` in float32.

    The sum over the experts runs one elementwise product and add at a time
    (JAX: one einsum), so each frame's mix gets the same bits whatever the
    count of frames mixed together: a matmul may pick its algorithm by the
    row count, and then a chunk of a clip would mix other bits than the
    whole clip."""
    w = weights_t.float()
    bank = bank.float().permute(0, 3, 4, 2, 1)  # (e, 3, 3, c_in, c_out)
    w2 = sum(w[..., e, None, None, None, None] * bank[e] for e in range(w.shape[-1]))
    b2 = sum(w[..., e, None] * bias_bank[e].float() for e in range(w.shape[-1]))
    return dict(w2=w2, b2=b2, g=gammas_t.float())


def part_kernels(kernel, part_channels: Sequence[int], b: int, gate=None):
    """Per-part, per-sample slices ``(b, 3, 3, c_p, c_out)`` float32 of the
    input conv's HWIO ``kernel (3, 3, sum(c_p), c_out)``.

    ``gate (b,)`` (0/1) is the align_key select of the BAE part layout
    (lr, key_warp, neighbour[, cur]): the neighbour slot is
    ``where(gate, key_warp, neighbour)``. A select commutes with the conv, so
    it becomes kernel gains (JAX ``_part_specs_for_gate`` :822):
    key_warp gets ``K_kw + g K_nb`` and the neighbour ``(1 - g) K_nb``."""
    kernel = kernel.float()
    offs = [0]
    for cp in part_channels:
        offs.append(offs[-1] + cp)
    if offs[-1] != kernel.shape[2]:
        raise ValueError(f"parts sum to {offs[-1]} channels, kernel has {kernel.shape[2]}")
    ks = [
        kernel[:, :, a:z].unsqueeze(0).expand(b, -1, -1, -1, -1)
        for a, z in zip(offs[:-1], offs[1:])
    ]
    if gate is not None:
        g = gate.float().reshape(b, 1, 1, 1, 1)
        ks[1] = ks[1] + g * ks[2]
        ks[2] = (1.0 - g) * ks[2]
    return [k.contiguous() for k in ks]


# ---- the tensor-core kernels' weights (K2-K5) --------------------------------

_TF32_HEAD = -8192  # 0xffffe000 as int32: sign, exponent and 10 mantissa bits
_TF32_HALF = 0x1000  # half of a TF32 ulp in float32 bits


def tf32_split(w):
    """float32 ``w`` -> ``(hi, lo)`` for 3xTF32: ``hi`` is ``w`` with its low
    13 mantissa bits cleared (a TF32 value), ``lo`` the rest ``w - hi``
    rounded to TF32 (nearest, ties away from zero: ``cvt.rna.tf32.f32``,
    which the kernels apply to their A operand). ``hi + lo`` is ``w`` to
    ~2^-22 relative, and ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` a float32
    product to ~2^-21."""
    w = w.float().contiguous()
    hi = (w.view(torch.int32) & _TF32_HEAD).view(torch.float32)
    rest = (w - hi).view(torch.int32)
    lo = ((rest + _TF32_HALF) & _TF32_HEAD).view(torch.float32)
    return hi, lo


def bf16_split(w):
    """float32 ``w`` -> ``(hi, lo)`` bfloat16: ``hi`` is ``w`` rounded to
    bfloat16, ``lo`` the rest ``w - hi`` rounded to bfloat16. ``hi + lo``
    is ``w`` to ~2^-17 relative, so two bf16 products of a bfloat16 input
    give its float32 product to about that."""
    w = w.float()
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


def tc_weights(taps, dtype, two_terms=False):
    """A tensor-core kernel's weight operand from ``taps (..., c_in, c_out)``:
    each tap transposed to ``(c_out, c_in)`` (the mma's "col" B operand) and
    stacked as ``(NW, ..., c_out, c_in)``: for bfloat16 features NW = 1, the
    weights rounded to bfloat16 (as the plain version rounds them), or with
    ``two_terms`` NW = 2, :func:`bf16_split`'s hi and lo; for float32 NW = 2,
    :func:`tf32_split`'s head and tail."""
    t = taps.float().transpose(-1, -2)
    if dtype == torch.bfloat16:
        if two_terms:
            return torch.stack(bf16_split(t)).contiguous()
        return t.to(torch.bfloat16).unsqueeze(0).contiguous()
    if dtype != torch.float32:
        raise TypeError(f"tensor-core weights for {dtype}: float32 or bfloat16 only")
    return torch.stack(tf32_split(t))


# ---- the wgmma designs at 64 channels (K2, K3, K4) -------------------------

# Their output tiles (launch.WG_WIDTH; csrc/drt_block.cu: drt_block_wg,
# head.cu: head_wg) and the stage-1 region around them; K2's tile by
# feature type (csrc/input_conv.cu: input_conv_wg, no second stage); the
# bytes of a weight tile's row (one 128-byte swizzle row: 64 bfloat16 or
# 32 float32 input channels, a "k-block")
WG_TILE = (14, 30)
WG_REGION = (16, 32)
IC_TILE = {torch.bfloat16: (16, 32), torch.float32: (8, 32)}
_WG_ROW = 128


def wg_image(stack, row_bytes=_WG_ROW):
    """A wgmma design's weights: :func:`tc_weights`' ``(NW, ..., n, c_in)``
    taps as the shared-memory image the kernel's bulk copies move and its
    wgmma descriptors read, ``(..., KB, NW, n, row_bytes bytes)``: each tap
    split into ``KB`` k-blocks of ``row_bytes`` bytes of input channels
    (128: 1 in bfloat16 and 2 in float32 at 64 channels; 32, one k-step, for
    K2's lr part padded to 16 bfloat16 or 8 float32 channels), each
    k-block's ``NW`` terms (the TF32 head and tail) one ring stage of ``NW``
    ``n``-row tiles, K-major (output n's row holds its input channels) and
    swizzled as wgmma's ``row_bytes``-byte mode: the 16-byte chunk j of row
    n sits at chunk ``j ^ (n * row_bytes // 128 % (row_bytes // 16))`` (128
    bytes: ``j ^ (n % 8)``; 32 bytes: ``j ^ (n // 4 % 2)``). One gather
    through a permutation cached per shape, type, row and device (the
    wrapper packs the weights at every launch)."""
    nw, *lead, n, k = stack.shape
    per_row = row_bytes // stack.element_size()
    perm = _wg_perm(tuple(stack.shape), stack.element_size(), row_bytes, stack.device)
    return stack.reshape(-1)[perm].reshape(*lead, k // per_row, nw, n, per_row)


_WG_PERMS: dict = {}


def _wg_perm(shape, elt, row_bytes, device):
    """The flat source index of each element of :func:`wg_image`'s output
    for a ``shape`` stack of ``elt``-byte values: the image's layout
    applied to ``arange``."""
    key = (shape, elt, row_bytes, str(device))
    if key not in _WG_PERMS:
        nw, *_, n, k = shape
        per_row, vec = row_bytes // elt, 16 // elt  # channels of a k-block, of a 16-byte chunk
        nchunk = row_bytes // 16
        t = torch.arange(math.prod(shape))
        t = t.reshape(nw, -1, n, k // per_row, nchunk, vec)
        rows = torch.arange(n).reshape(1, 1, n, 1, 1, 1)
        chunks = torch.arange(nchunk).reshape(1, 1, 1, 1, -1, 1)
        swz = rows * row_bytes // 128 % nchunk
        t = torch.gather(t, 4, (chunks ^ swz).expand(t.shape))
        _WG_PERMS[key] = t.permute(1, 3, 0, 2, 4, 5).reshape(-1).to(device)
    return _WG_PERMS[key]


def wg_tile_walk(b: int, h: int, w: int, sms: int, tile=WG_TILE):
    """A wgmma design's persistent walk over ``b`` samples of ``h x w``:
    ``(grid, [[(sample, y0, x0) of each tile block k runs] for k in
    range(grid)])``, grid = min(tiles, sms); block k takes tiles k, k +
    grid, ... in (sample, tile row, tile column) order, each the output
    pixels ``[y0, y0 + th) x [x0, x0 + tw)`` inside the image, ``(th, tw) =
    tile`` (``WG_TILE``: ``drt_block_wg``'s and ``head_wg``'s loop;
    ``IC_TILE[dtype]``: ``input_conv_wg``'s), in the same order."""
    th, tw = tile
    nty, ntx = -(-h // th), -(-w // tw)
    tiles = [(s, ty * th, tx * tw) for s in range(b) for ty in range(nty) for tx in range(ntx)]
    grid = min(len(tiles), sms)
    return grid, [tiles[k::grid] for k in range(grid)]


# ---- K2: input conv ---------------------------------------------------------


def input_conv_plain(parts, kernels, bias):
    """``lrelu_0.1(sum_p conv3x3(part_p; kernels[p][b]) + bias)``."""
    acc = None
    for part, k in zip(parts, kernels):
        term = per_sample_conv(part, k)
        acc = term if acc is None else acc + term
    return F.leaky_relu(acc + bias.float(), 0.1).to(parts[0].dtype)


def input_conv_args(parts, kernels, bias):
    """K2's shape and width checks and its weights as the kernel takes them:
    ``(per-part kernels, bias (c,) float32, c)``, each part's
    :func:`tc_weights` ``(NW, b, 9, c, c_p)`` in the features' type, the lr
    part zero-padded to one mma k-step of input channels (16 bfloat16, 8
    float32)."""
    lr, wide = parts[0], list(parts[1:])
    b, h, w, clr = lr.shape
    if clr != 3 or not 1 <= len(wide) <= 3 or len(kernels) != len(parts):
        raise ValueError("input_conv: need lr (b,h,w,3) + 1-3 features and one kernel each")
    c = wide[0].shape[-1]
    check_width("input_conv", c)
    for p in wide:
        if p.shape != (b, h, w, c):
            raise ValueError(f"input_conv: feature {tuple(p.shape)} != {(b, h, w, c)}")
    ks = [k.reshape(b, 9, k.shape[3], k.shape[4]) for k in kernels]
    if ks[0].shape != (b, 9, 3, c) or any(k.shape != (b, 9, c, c) for k in ks[1:]):
        raise ValueError(f"input_conv: kernels must be (b,3,3,c_p,{c})")
    if bias.shape != (c,):
        raise ValueError(f"input_conv: bias {tuple(bias.shape)} != ({c},)")
    kstep = 16 if lr.dtype == torch.bfloat16 else 8
    ks[0] = F.pad(ks[0].float(), (0, 0, 0, kstep - 3))
    return [tc_weights(k, lr.dtype) for k in ks], bias.float().contiguous(), c


def _input_conv_weights(ks, c, dtype):
    """K2's weights as the design at width ``c`` takes them: at
    ``launch.WG_WIDTH`` the wgmma design's images (:func:`wg_image`, the lr
    part's one k-step as a 32-byte row), else :func:`input_conv_args`'
    operands as they are."""
    if kernel_design("input_conv", c, dtype)[0] != "wgmma":
        return ks
    return [wg_image(ks[0], row_bytes=32)] + [wg_image(k) for k in ks[1:]]


def _input_conv_kernel(parts, kernels, bias):
    """The op's CUDA implementation: the weights repacked, K2's launch."""
    ks, bias, c = input_conv_args(parts, kernels, bias)
    ks = _input_conv_weights(ks, c, parts[0].dtype)
    lr, wide = parts[0], list(parts[1:])
    b, h, w, _ = lr.shape
    check_cuda_args("input_conv", parts, (*ks, bias))
    out = torch.empty((b, h, w, c), dtype=lr.dtype, device=lr.device)
    pad = [None] * (3 - len(wide))
    return launch(
        "input_conv", "pnp_input_conv", out, lr, *wide, *pad, ks[0], *ks[1:], *pad,
        bias, out, b, h, w, len(wide), c,
    )


_input_conv_op = register(
    "input_conv", "(Tensor[] parts, Tensor[] kernels, Tensor bias) -> Tensor",
    _input_conv_kernel, input_conv_plain,
    lambda parts, kernels, bias: parts[0].new_empty((*parts[0].shape[:3], parts[1].shape[-1])),
    lambda parts, kernels, bias: flop_per_pixel("input_conv", parts[1][-1],
                                                parts=[p[-1] for p in parts]),
)


def _input_conv_launch(parts, kernels, bias):
    """The op, ``torch.ops.pnp_vcve.input_conv``: K2 on CUDA tensors."""
    return _input_conv_op(list(parts), list(kernels), bias)


class InputConvFunction(torch.autograd.Function):
    """``run(parts, kernels, bias)`` forward with ``n`` parts and ``n``
    kernels passed flat; :func:`input_conv_plain`'s gradients."""

    @staticmethod
    def forward(ctx, run, n, *tensors):
        ctx.n = n
        ctx.save_for_backward(*tensors)
        return run(list(tensors[:n]), list(tensors[n : 2 * n]), tensors[2 * n])

    @staticmethod
    def backward(ctx, grad):
        n = ctx.n
        grads = plain_grads(
            lambda *t: input_conv_plain(t[:n], t[n : 2 * n], t[2 * n]),
            ctx.saved_tensors, ctx.needs_input_grad[2:], grad,
        )
        return None, None, *grads


def input_conv(parts, kernels, bias):
    """K2. ``parts``: the lr frame ``(b, h, w, 3)`` then 1-3 features
    ``(b, h, w, c)``; ``kernels``: per-part ``(b, 3, 3, c_p, c)`` float32
    (from :func:`part_kernels`); ``bias (c,)``. Returns ``(b, h, w, c)``."""
    cpu = on_cpu(parts[0])
    if not tracks_grad(*parts, *kernels, bias):
        return _input_conv_launch(parts, kernels, bias)
    if cpu:
        return input_conv_plain(parts, kernels, bias)
    return InputConvFunction.apply(_input_conv_launch, len(parts), *parts, *kernels, bias)


# ---- K3: DRT block ------------------------------------------------------------


def drt_block_plain(x, par, w2, b2, g, pk, w1, b1):
    """One DRT block (JAX ``_xla_block_compose``; channel_first, one_layer):
    ``h = relu(g * (conv3x3(x; w2[b]) + b2[b]) + sum_r (x * par_r) @ pk[:, r])``,
    ``out = x + conv3x3(h; w1) + b1``."""
    dtype = x.dtype
    dyres = None
    for r in range(3):
        gated = x * par[..., r : r + 1].to(dtype)
        term = torch.einsum("bhwi,io->bhwo", gated, pk[:, r].to(dtype)).float()
        dyres = term if dyres is None else dyres + term
    dyn = dynamic_conv2d(x, w2, b2, gamma=g).float()
    hmid = torch.relu(dyn + dyres).to(dtype)
    return x + conv2d_nhwc(hmid, w1, b1)


def drt_block_args(x, par, w2, b2, g, pk, w1, b1, name="drt_block"):
    """Check K3's arguments and repack its weights as the kernel takes them:
    ``(w2 (NW, b, 9, c, c), b2 (b, c), g (b, c), pk (NW, 3, c, c), w1 (NW, 9,
    c, c), b1 (c,))``, the conv and partition taps as :func:`tc_weights` in
    x's type, the biases and the gain float32 (the gain applies after the
    conv, in the kernel's float32 epilogue, as the JAX kernel applies it)."""
    b, h, w, c = x.shape
    if par.shape != (b, h, w, 3):
        raise ValueError(f"{name}: need x (b,h,w,c), par (b,h,w,3); got "
                         f"{tuple(x.shape)}, {tuple(par.shape)}")
    check_width(name, c)
    if (w2.shape != (b, 3, 3, c, c) or b2.shape != (b, c) or g.shape != (b, c)
            or pk.shape != (c, 3, c) or w1.shape != (3, 3, c, c) or b1.shape != (c,)):
        raise ValueError(f"{name}: weight shapes do not match {c} channels")
    dtype = x.dtype
    return (tc_weights(w2.reshape(b, 9, c, c), dtype), b2.float().contiguous(),
            g.float().contiguous(), tc_weights(pk.permute(1, 0, 2), dtype),
            tc_weights(w1.reshape(9, c, c), dtype), b1.float().contiguous())


def _kernel_weights(x, weights):
    """The weights as the design at x's width takes them: the wgmma
    design's images (:func:`wg_image`) at ``launch.WG_WIDTH``, else
    :func:`drt_block_args`' operands as they are."""
    if kernel_design("drt_block", x.shape[-1], x.dtype)[0] != "wgmma":
        return weights
    w2, b2, g, pk, w1, b1 = weights
    return wg_image(w2), b2, g, wg_image(pk), wg_image(w1), b1


def _drt_block_kernel(x, par, w2, b2, g, pk, w1, b1):
    """The op's CUDA implementation: the weights repacked, K3's launch (or
    its two launches, counted as one, above the one-launch width)."""
    weights = _kernel_weights(x, drt_block_args(x, par, w2, b2, g, pk, w1, b1))
    check_cuda_args("drt_block", (x, par), weights)
    out = torch.empty_like(x)
    # above the one-launch width h goes through a scratch of x's type
    hbuf = torch.empty_like(x) if launch_form("drt_block", x.shape[-1], x.dtype) == 2 else None
    return launch("drt_block", "pnp_drt_block", out, x, par, *weights, hbuf, out, *x.shape)


_DRT_ARGS = ("Tensor x, Tensor par, Tensor w2, Tensor b2, Tensor g, Tensor pk, Tensor w1, "
             "Tensor b1")

_drt_block_op = register(
    "drt_block", f"({_DRT_ARGS}) -> Tensor", _drt_block_kernel, drt_block_plain,
    lambda x, *weights: x.new_empty(x.shape),
    lambda x, *weights: flop_per_pixel("drt_block", x[-1]),
)


def _drt_block_launch(x, par, w2, b2, g, pk, w1, b1):
    """The op, ``torch.ops.pnp_vcve.drt_block``: K3 on CUDA tensors."""
    return _drt_block_op(x, par, w2, b2, g, pk, w1, b1)


class DRTBlockFunction(torch.autograd.Function):
    """``run(x, par, w2, b2, g, pk, w1, b1)`` forward;
    :func:`drt_block_plain`'s gradients."""

    @staticmethod
    def forward(ctx, run, *args):
        ctx.save_for_backward(*args)
        return run(*args)

    @staticmethod
    def backward(ctx, grad):
        return None, *plain_grads(drt_block_plain, ctx.saved_tensors,
                                  ctx.needs_input_grad[1:], grad)


def drt_block(x, par, w2, b2, g, pk, w1, b1):
    """K3. ``x (b, h, w, c)``, ``par (b, h, w, 3)`` of x's type; per-sample
    ``w2 (b, 3, 3, c, c)``, ``b2 (b, c)``, ``g (b, c)``; static
    ``pk (c, 3, c)``, ``w1 (3, 3, c, c)``, ``b1 (c,)``. Out of place."""
    cpu = on_cpu(x)
    if not tracks_grad(x, par, w2, b2, g, pk, w1, b1):
        return _drt_block_launch(x, par, w2, b2, g, pk, w1, b1)
    if cpu:
        return drt_block_plain(x, par, w2, b2, g, pk, w1, b1)
    return DRTBlockFunction.apply(_drt_block_launch, x, par, w2, b2, g, pk, w1, b1)


# ---- K3s: DRT block with the keyframe-carry select -----------------------------


def drt_block_select_plain(x, par, w2, b2, g, pk, w1, b1, last_key, is_key):
    """:func:`drt_block_plain` and the sweep's keyframe-carry update:
    ``(out, where(is_key[b], out, last_key))``."""
    out = drt_block_plain(x, par, w2, b2, g, pk, w1, b1)
    return out, torch.where(is_key.reshape(-1, 1, 1, 1) > 0.5, out, last_key)


def drt_block_select_args(x, par, w2, b2, g, pk, w1, b1, last_key, is_key):
    """K3s's checks: K3's (:func:`drt_block_args`, whose repacked weights it
    returns) and the select's operands."""
    weights = drt_block_args(x, par, w2, b2, g, pk, w1, b1, name="drt_block_select")
    if last_key.shape != x.shape or is_key.shape != (x.shape[0],):
        raise ValueError(f"drt_block_select: need last_key {tuple(x.shape)} and is_key "
                         f"({x.shape[0]},); got {tuple(last_key.shape)}, {tuple(is_key.shape)}")
    return weights


def _drt_block_select_kernel(x, par, w2, b2, g, pk, w1, b1, last_key, is_key):
    """The op's CUDA implementation: the weights repacked, K3s's launch."""
    weights = _kernel_weights(
        x, drt_block_select_args(x, par, w2, b2, g, pk, w1, b1, last_key, is_key))
    key = is_key.to(torch.float32, copy=True)  # a fresh, aligned (b,) float32
    check_cuda_args("drt_block_select", (x, par, last_key), (*weights, key))
    out, new_last_key = torch.empty_like(x), torch.empty_like(x)
    launch("drt_block_select", "pnp_drt_block_select", out, x, par, *weights, last_key, key,
           out, new_last_key, *x.shape)
    return out, new_last_key


_drt_block_select_op = register(
    "drt_block_select", f"({_DRT_ARGS}, Tensor last_key, Tensor is_key) -> (Tensor, Tensor)",
    _drt_block_select_kernel, drt_block_select_plain,
    lambda x, *rest: (x.new_empty(x.shape), x.new_empty(x.shape)),
    lambda x, *rest: flop_per_pixel("drt_block_select", x[-1]),
)


def _drt_block_select_launch(x, par, w2, b2, g, pk, w1, b1, last_key, is_key):
    """The op, ``torch.ops.pnp_vcve.drt_block_select``: K3s on CUDA tensors."""
    return _drt_block_select_op(x, par, w2, b2, g, pk, w1, b1, last_key, is_key)


class DRTBlockSelectFunction(torch.autograd.Function):
    """``run(x, par, w2, b2, g, pk, w1, b1, last_key, is_key)`` forward,
    two outputs; :func:`drt_block_select_plain`'s gradients (none for the
    flag), as the custom VJP of JAX ``make_fused_pipeline_select`` (:1135)."""

    @staticmethod
    def forward(ctx, run, *args):
        ctx.save_for_backward(*args)
        return run(*args)

    @staticmethod
    def backward(ctx, grad_out, grad_last_key):
        needs = (*ctx.needs_input_grad[1:-1], False)
        return None, *plain_grads(drt_block_select_plain, ctx.saved_tensors, needs,
                                  (grad_out, grad_last_key))


def drt_block_select(x, par, w2, b2, g, pk, w1, b1, last_key, is_key):
    """K3s. :func:`drt_block`'s arguments plus ``last_key`` (x's shape and
    type) and ``is_key (b,)`` (0/1) -> ``(out, new_last_key)``, two fresh
    tensors with ``new_last_key = where(is_key[b], out, last_key)``."""
    cpu = on_cpu(x)
    args = (x, par, w2, b2, g, pk, w1, b1, last_key, is_key)
    if not tracks_grad(*args):
        return _drt_block_select_launch(*args)
    if cpu:
        return drt_block_select_plain(*args)
    return DRTBlockSelectFunction.apply(_drt_block_select_launch, x, par, w2, b2, g, pk, w1, b1,
                                        last_key, is_key)


# ---- K4: head -------------------------------------------------------------------


def head_plain(x, hr_k, hr_b, last_k, last_b):
    """``conv3x3(lrelu_0.1(conv3x3(x; hr_k) + hr_b); last_k) + last_b``
    (JAX ``_xla_head``); the caller adds lr."""
    y = conv2d_f32(x, hr_k) + hr_b.float()
    y = F.leaky_relu(y, 0.1).to(x.dtype)
    return (conv2d_f32(y, last_k) + last_b.float()).to(x.dtype)


def head_args(x, hr_k, hr_b, last_k, last_b):
    """K4's shape and width checks and its weights as the kernel takes them:
    ``(whr (2, 9, c, c), bhr (c,), wl (9, c, 3), bl (3,))``: W_hr as
    :func:`tc_weights` in x's type with two terms (the 3xTF32 split, or
    bfloat16's hi + lo, which keeps the head within its parity bound), the
    rest float32."""
    b, h, w, c = x.shape
    check_width("head", c)
    if (hr_k.shape != (3, 3, c, c) or hr_b.shape != (c,) or last_k.shape != (3, 3, c, 3)
            or last_b.shape != (3,)):
        raise ValueError(f"head: need x (b,h,w,c) and c->c->3 weights; got x {tuple(x.shape)}, "
                         f"{tuple(hr_k.shape)}, {tuple(last_k.shape)}")
    whr = tc_weights(hr_k.reshape(9, c, c), x.dtype, two_terms=True)
    wl = last_k.float().reshape(9, c, 3).contiguous()
    return whr, hr_b.float().contiguous(), wl, last_b.float().contiguous()


# the channel order of a k-step of 8 in which head_wg's stage 2 takes its A
# fragment straight from its sum registers: lane t holds channels 2 t and
# 2 t + 1, the fragment's k-slots t and t + 4
_HEAD_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def head_last_image(last_k):
    """The wgmma head's c -> 3 stage as one GEMM's B operand: ``W'`` with a
    column ``n = 3 tap + o`` for each tap and output channel (27, zero
    columns to 32) and a row for each hidden channel, ``W'[c, n] =
    last_k[tap // 3, tap % 3, c, o]``, its channels taken in
    ``_HEAD_K_ORDER`` within each group of 8, split for 3xTF32
    (:func:`tf32_split`) and laid out by :func:`wg_image`: ``(2 k-blocks, 2
    terms, 32, 32)`` float32. One gather from the split weights through a
    permutation cached per shape and device."""
    src = F.pad(torch.stack(tf32_split(last_k)).reshape(2, -1), (0, 1))  # a zero at the end
    perm = _head_last_perm(tuple(last_k.shape), last_k.device)
    return src.reshape(-1)[perm]


_HEAD_PERMS: dict = {}


def _head_last_perm(shape, device):
    """The flat index into the two split terms of a ``shape`` W_last, each
    followed by one zero, of each element of :func:`head_last_image`'s
    output: ``W'``'s layout built on indices, then :func:`wg_image`'s."""
    key = (shape, str(device))
    if key not in _HEAD_PERMS:
        kh, kw, c, co = shape
        size = kh * kw * c * co + 1  # a term and its zero
        n = torch.arange(32)
        tap, o = n // co, n % co
        chan = (torch.arange(c // 8)[:, None] * 8 + torch.tensor(_HEAD_K_ORDER)).reshape(-1)
        idx = (tap[:, None] * c + chan[None, :]) * co + o[:, None]  # (32, c)
        idx = torch.where(n[:, None] < kh * kw * co, idx, size - 1)
        logical = torch.stack([idx, idx + size])  # (2 terms, 32, c)
        _HEAD_PERMS[key] = wg_image(logical.to(torch.int32)).long().to(device)
    return _HEAD_PERMS[key]


def _head_weights(weights, last_k, c, dtype):
    """K4's weights as the design at width ``c`` takes them: at
    ``launch.WG_WIDTH`` the wgmma design's images (:func:`wg_image` of W_hr's
    two terms, :func:`head_last_image`), else :func:`head_args`' operands as
    they are."""
    if kernel_design("head", c, dtype)[0] != "wgmma":
        return weights
    whr, bhr, _, bl = weights
    return wg_image(whr), bhr, head_last_image(last_k), bl


def _head_kernel(x, hr_k, hr_b, last_k, last_b):
    """The op's CUDA implementation: the weights repacked, K4's launch (or
    its two launches, counted as one, above the one-launch width)."""
    weights = _head_weights(head_args(x, hr_k, hr_b, last_k, last_b), last_k, x.shape[-1],
                            x.dtype)
    check_cuda_args("head", (x,), weights)
    b, h, w, c = x.shape
    out = torch.empty((b, h, w, 3), dtype=x.dtype, device=x.device)
    # above the one-launch width the hidden map goes through a float32 scratch
    hbuf = (torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
            if launch_form("head", c, x.dtype) == 2 else None)
    return launch("head", "pnp_head", out, x, *weights, hbuf, out, b, h, w, c)


_head_op = register(
    "head", "(Tensor x, Tensor hr_k, Tensor hr_b, Tensor last_k, Tensor last_b) -> Tensor",
    _head_kernel, head_plain,
    lambda x, *weights: x.new_empty((*x.shape[:3], 3)),
    lambda x, *weights: flop_per_pixel("head", x[-1]),
)


def _head_launch(x, hr_k, hr_b, last_k, last_b):
    """The op, ``torch.ops.pnp_vcve.head``: K4 on CUDA tensors."""
    return _head_op(x, hr_k, hr_b, last_k, last_b)


class HeadFunction(torch.autograd.Function):
    """``run(x, hr_k, hr_b, last_k, last_b)`` forward; :func:`head_plain`'s
    gradients."""

    @staticmethod
    def forward(ctx, run, *args):
        ctx.save_for_backward(*args)
        return run(*args)

    @staticmethod
    def backward(ctx, grad):
        return None, *plain_grads(head_plain, ctx.saved_tensors,
                                  ctx.needs_input_grad[1:], grad)


def head(x, hr_k, hr_b, last_k, last_b):
    """K4. ``x (b, h, w, c)``; ``hr_k (3, 3, c, c)``, ``hr_b (c,)``,
    ``last_k (3, 3, c, 3)``, ``last_b (3,)``. Returns ``(b, h, w, 3)``."""
    cpu = on_cpu(x)
    if not tracks_grad(x, hr_k, hr_b, last_k, last_b):
        return _head_launch(x, hr_k, hr_b, last_k, last_b)
    if cpu:
        return head_plain(x, hr_k, hr_b, last_k, last_b)
    return HeadFunction.apply(_head_launch, x, hr_k, hr_b, last_k, last_b)
