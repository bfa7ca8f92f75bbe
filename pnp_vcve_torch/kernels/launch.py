"""What the kernel wrappers share: argument checks, the launch counters, the
call into the built library and the kernels' backward.

A wrapper given CPU tensors runs its kernel's plain PyTorch version; given
CUDA tensors it launches the kernel or raises. ``LAUNCHES[name]`` counts the
kernel's launches (and nothing else), so a run can show that it went through
the kernels: zero the counts with :func:`reset_launches`, run, read them.

On CUDA tensors each kernel but one runs inside a ``torch.autograd.Function`` whose
backward is :func:`plain_grads`: the plain version replayed under autograd
on the saved inputs. It is the JAX package's ``custom_vjp`` contract
(``make_trainable_stack`` and its siblings, pnp_vcve_tpu/kernels/
drt_stack.py:803, :891, :1253): a fused forward, the gradient of the op
composition, and no backward kernel. The block-flow warp (K1b) is the
exception: JAX's ``warp_pf`` has no VJP, so its wrapper refuses an input
that requires a gradient.
"""

from __future__ import annotations

import torch

from .build import library

__all__ = [
    "LAUNCHES", "reset_launches", "on_cpu", "check_cuda_args", "launch", "call", "plain_grads",
    "SMEM_MAX", "MAX_WIDTH", "ONE_LAUNCH_WIDTH", "check_width", "launch_form", "WG_WIDTH",
    "WG_KERNELS", "kernel_design",
]

LAUNCHES = {"warp": 0, "warp_block": 0, "input_conv": 0, "drt_block": 0,
            "drt_block_select": 0, "head": 0, "conv3x3": 0}

SMEM_MAX = 227 * 1024  # dynamic shared memory a block may use on an H100
# The widest c each model kernel takes (None: any multiple of 8). K1b stops
# at the widest block that fits in SMEM_MAX (its source static_asserts the
# same number, WB_MAX_WIDTH, against its shared-memory formula and refuses
# a wider launch); K3s runs at 64 only, the pf path's width.
MAX_WIDTH = {"warp": None, "warp_block": 712, "input_conv": None, "drt_block": None,
             "drt_block_select": 64, "head": None, "conv3x3": None}
# K3 and K4 keep their hidden map on the chip (one launch) up to the widest
# block whose h region fits in SMEM_MAX, per feature type (K3 holds h in the
# feature type, K4 in float32 beside two weight terms in both types, so its
# two widths agree); above it each runs as two launches through a scratch
# tensor the wrapper allocates. Each source static_asserts the same numbers
# (DB_ONE_LAUNCH_F32 / _BF16, HD_ONE_LAUNCH_F32 / _BF16) against its
# formula, and chip_smoke.py's build phase reads the formula at the limit.
ONE_LAUNCH_WIDTH = {("drt_block", torch.float32): 168, ("drt_block", torch.bfloat16): 384,
                    ("head", torch.float32): 144, ("head", torch.bfloat16): 144}


def check_width(name: str, c: int):
    """Raise ``ValueError`` unless kernel ``name`` takes ``c`` channels: a
    multiple of 8 (K1b up to ``MAX_WIDTH``, K3s 64 only)."""
    if c < 8 or c % 8:
        raise ValueError(f"{name}: width {c} is not a multiple of 8; the kernels take "
                         f"widths 8, 16, 24, ... (8-channel vectors)")
    if name == "drt_block_select" and c != 64:
        raise ValueError(f"{name}: width {c}; K3s takes 64 channels only, the pf path's width")
    top = MAX_WIDTH[name]
    if top is not None and c > top:
        raise ValueError(f"{name}: width {c} is above {top}, the widest block that fits in "
                         f"an H100 block's {SMEM_MAX} bytes of shared memory")


def launch_form(name: str, c: int, dtype: torch.dtype) -> int:
    """How many launches kernel ``name`` takes at width ``c`` in ``dtype``:
    1, or 2 for K3 and K4 above ``ONE_LAUNCH_WIDTH`` (h through a scratch
    tensor). K3s is K3's one-launch form."""
    check_width(name, c)
    top = ONE_LAUNCH_WIDTH.get(("drt_block" if name == "drt_block_select" else name, dtype))
    return 2 if top is not None and c > top else 1


# K2, K3 (and K3s), K4 and K5 run their wgmma designs (csrc/input_conv.cu:
# input_conv_wg, drt_block.cu: drt_block_wg, head.cu: head_wg, conv3x3.cu:
# conv3x3_wg) at this width (K5: 64 -> 64), the width of every model path,
# and their mma.sync designs at any other; each C entry picks by the same
# rule and refuses what neither takes
WG_WIDTH = 64
WG_KERNELS = ("input_conv", "drt_block", "drt_block_select", "head", "conv3x3")


def kernel_design(name: str, c: int, dtype: torch.dtype, c_in: int | None = None
                  ) -> tuple[str, int]:
    """Which code K2, K3, K3s, K4 or K5 (``name``) runs at width ``c`` in
    ``dtype``, and its launches: ``("wgmma", 1)`` at ``WG_WIDTH``, else
    ``("mma.sync",`` :func:`launch_form` ``)``. K5 takes its output width
    ``c`` and its input width ``c_in``: the wgmma design at ``WG_WIDTH`` ->
    ``WG_WIDTH`` only. A dispatch by shape, the same in both types."""
    if name not in WG_KERNELS:
        raise ValueError(f"{name}: not a kernel with a wgmma design ({WG_KERNELS})")
    form = launch_form(name, c, dtype)
    wide = c == WG_WIDTH and (name != "conv3x3" or c_in == WG_WIDTH)
    return ("wgmma", 1) if wide else ("mma.sync", form)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cpu(x: torch.Tensor) -> bool:
    """True routes a wrapper to its plain version. Devices other than the
    CPU and CUDA are refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return False


def check_cuda_args(name: str, features, weights=()):
    """Device, dtype, contiguity and alignment checks for a launch. Feature
    tensors share one device and one dtype (float32 or bfloat16); weight
    tensors are float32 or of the features' type (the tensor-core kernels'
    operands). All are contiguous and 16-byte aligned (the kernels read
    16-byte vectors)."""
    dev = features[0].device
    dtype = features[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: features must be float32 or bfloat16, got {dtype}")
    for t in features:
        if t.device != dev or t.dtype != dtype:
            raise TypeError(
                f"{name}: features on {t.device}/{t.dtype}, expected {dev}/{dtype}"
            )
    for t in weights:
        if t.device != dev or t.dtype not in (torch.float32, dtype):
            raise TypeError(f"{name}: weights must be float32 or {dtype} on {dev}")
    for t in (*features, *weights):
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def launch(name: str, entry: str, out: torch.Tensor, *args):
    """Call C entry point ``entry`` with the dtype code of ``out`` first and
    the current stream of its device last; count the launch."""
    call(name, entry, out.device, _DTYPE_CODE[out.dtype], *args)
    return out


def call(name: str, entry: str, device: torch.device, *args, counts=LAUNCHES):
    """Call C entry point ``entry`` with ``args`` (tensors as their data
    pointers, None as a null pointer) and the current stream of ``device``
    last; raise on an error, count the launch in ``counts[name]``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(lib.lib, entry)(*ptrs, stream)
    lib.check(rc, name)
    counts[name] += 1


def plain_grads(plain, args, needs, grad_out):
    """Gradients of ``plain(*args)`` against ``grad_out`` for each argument
    whose ``needs`` flag is set (``None`` for the others), by running
    ``plain`` again under autograd on detached copies of ``args``. A
    ``plain`` with several outputs takes a tuple ``grad_out``, one each."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_(bool(n)) for a, n in zip(args, needs)]
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(plain(*xs), wrt, grad_out) if wrt else ())
    return [next(grads) if n else None for n in needs]
