#!/usr/bin/env python
"""Export the eval forward of the PyTorch/CUDA port as a ``torch.export``
program (the port's counterpart of tools/export_model.py, which serialises
the JAX forward with ``jax.export``).

    python tools/torch_export_model.py CONFIG CKPT out.pt2 [--shape T H W]
        [--verify] [--device cuda|cpu]

CKPT is what tools/torch_test.py takes: a ``.pth`` / ``.npz`` state dict
under the reference's names, a training checkpoint of tools/torch_train.py,
or ``-`` for a seeded random init (a graph-only export). The weights are
frozen (``requires_grad`` off: the JAX export closes over its params as
constants) and the generator's forward over ``(lrs, qps, slices, mvs,
base_qps, par_map)`` is exported at a fixed ``(1, T, H, W)`` (default 3 x
128 x 128, JAX's) from JAX's example inputs: zeros, every slice an I
slice. The graph holds the model kernels as the registered ops
``torch.ops.pnp_vcve.*`` (pnp_vcve_torch/kernels/ops_registry.py); on the
card the loaded program launches the hand-written kernels through them,
on the CPU their plain versions. ``torch.export.load`` needs the ops
registered first: import ``pnp_vcve_torch.kernels``.

The artifact holds the program and the weights, not the example inputs
(as JAX's). The tool prints its size, the export's and the save's seconds
and the ``pnp_vcve::*`` ops the graph holds with their counts. ``--verify`` reloads the artifact, runs it on
seeded random frames and checks max|diff| against the eager forward
(JAX's bound, 1e-4). ``main`` returns the path, the seconds, the size and the op
counts (with ``--verify`` also the error and the reloaded program).
``--device cuda`` (the default) fails without a GPU; it never falls back.
"""

import argparse
import sys
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VERIFY_TOL = 1e-4  # tools/export_model.py:80


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a PnP-VCVE generator with torch.export")
    p.add_argument("config")
    p.add_argument("checkpoint", help="state dict (.pth/.npz), training checkpoint or '-'")
    p.add_argument("out", help="output file of the exported program (.pt2)")
    p.add_argument("--shape", type=int, nargs=3, default=[3, 128, 128], metavar=("T", "H", "W"))
    p.add_argument("--verify", action="store_true",
                   help="reload the artifact and compare it with the eager forward")
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    return p.parse_args(argv)


def example_inputs(t: int, h: int, w: int, device):
    """JAX's example inputs (tools/export_model.py:54-61): zeros, slices 73
    (I), one clip."""
    import torch

    z = lambda *s: torch.zeros((1, t, *s), device=device)  # noqa: E731
    return (z(h, w, 3), z(), torch.full((1, t), 73.0, device=device), z(h, w, 4), z(),
            z(h, w, 3))


def verify_inputs(t: int, h: int, w: int, device):
    """The example inputs with seeded random frames (numpy, seed 0)."""
    import numpy as np
    import torch

    lrs = np.random.default_rng(0).random((1, t, h, w, 3), np.float32)
    return (torch.from_numpy(lrs).to(device),) + example_inputs(t, h, w, device)[1:]


def op_counts(program) -> Counter:
    """``{op name: count}`` of the ``pnp_vcve::*`` ops in an exported
    program's graph."""
    from pnp_vcve_torch.kernels.ops_registry import NAMESPACE

    return Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith(f"{NAMESPACE}.")
    )


def input_shape(program):
    """``(t, h, w)`` of an exported program's ``lrs`` input."""
    user = set(program.graph_signature.user_inputs)
    lrs = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name in user)
    return tuple(lrs.meta["val"].shape[1:4])


def load_model(config: str, checkpoint: str, device):
    """The config's generator on ``device`` with the checkpoint's weights,
    in eval mode, every parameter frozen."""
    from pnp_vcve_torch.core.builder import build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config

    cfg = Config.fromfile(config)
    model = build_restorer(cfg.model, cfg.get("test_cfg"), device=device).generator
    load_generator_weights(model, checkpoint)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def export(model, t: int, h: int, w: int, device):
    """The exported program of ``model``'s forward at ``(1, t, h, w)``."""
    import torch

    with torch.no_grad():
        return torch.export.export(model, example_inputs(t, h, w, device), strict=False)


def main(argv=None):
    args = parse_args(argv)

    import torch

    import pnp_vcve_torch.kernels  # noqa: F401  (registers the ops)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    t, h, w = args.shape
    model = load_model(args.config, args.checkpoint, device)

    t0 = time.perf_counter()
    program = export(model, t, h, w, device)
    t1 = time.perf_counter()
    program.example_inputs = None  # the artifact carries the weights, not the inputs
    torch.export.save(program, args.out)
    seconds, save_seconds = t1 - t0, time.perf_counter() - t1
    size = Path(args.out).stat().st_size
    ops = op_counts(program)
    print(f"exported {size / 1e6:.2f} MB torch.export program -> {args.out} "
          f"(input (1, {t}, {h}, {w}, 3); export {seconds:.1f} s, save {save_seconds:.1f} s)")
    print("ops: " + ", ".join(f"pnp_vcve::{k} x{v}" for k, v in sorted(ops.items())))
    result = {"path": args.out, "seconds": seconds, "save_seconds": save_seconds, "bytes": size,
              "ops": dict(ops)}

    if args.verify:
        loaded = torch.export.load(args.out)
        inputs = verify_inputs(t, h, w, device)
        with torch.no_grad():
            got = loaded.module()(*inputs)
            want = model(*inputs)
        err = float((got - want).abs().max())
        print(f"verify: max abs diff vs eager = {err:.2e}")
        if not err < VERIFY_TOL:
            raise AssertionError(f"export verification failed: {err:.2e} >= {VERIFY_TOL}")
        result.update(max_abs_err=err, loaded=loaded)
    return result


if __name__ == "__main__":
    main()
