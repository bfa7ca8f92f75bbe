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
]

LAUNCHES = {"warp": 0, "warp_block": 0, "input_conv": 0, "drt_block": 0,
            "drt_block_select": 0, "head": 0, "conv3x3": 0}

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
    tensors are float32. All are contiguous and 16-byte aligned (the kernels
    read 16-byte vectors)."""
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
        if t.device != dev or t.dtype != torch.float32:
            raise TypeError(f"{name}: weights must be float32 on {dev}")
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
