#!/usr/bin/env python
"""Parameter and FLOP count of a PyTorch/CUDA port generator (the port's
counterpart of tools/get_flops.py; reference tools/get_flops.py:23-60).

    python tools/torch_get_flops.py CONFIG [--shape T H W] [--device cuda|cpu]

Parameters: every tensor of the generator's parameters, as the JAX tool
counts the leaves of the model's variables. FLOPs: ``torch.utils.
flop_counter.FlopCounterMode`` over one forward of JAX's inputs (zeros,
I slices) at ``(1, T, H, W)``, default 3 x 256 x 256 as in JAX. It counts
the products of convolutions and matrix products, 2 a multiply-add; the
model kernels count through their registered ops' formulas
(pnp_vcve_torch/kernels/ops_registry.py: ``flop_per_pixel``), which equal
the plain versions' convolutions and products. Elementwise work (biases,
activations, the expert premix, the warps' blends) is not counted, where
XLA's ``cost_analysis()`` in the JAX tool counts it too.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def count(model, t: int, h: int, w: int, device):
    """``(parameters, FLOPs of one forward at (1, t, h, w))``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tools.torch_export_model import example_inputs

    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*example_inputs(t, h, w, device))
    return n_params, counter.get_total_flops()


def main(argv=None):
    p = argparse.ArgumentParser(description="Count a PnP-VCVE generator's parameters and FLOPs")
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=3, default=[3, 256, 256], metavar=("T", "H", "W"))
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu' (plain versions)")
    args = p.parse_args(argv)

    import torch

    from tools.torch_export_model import load_model

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    t, h, w = args.shape
    model = load_model(args.config, "-", device)
    n_params, flops = count(model, t, h, w, device)
    print(f"Input shape: (1, {t}, {h}, {w}, 3)")
    print(f"Params: {n_params / 1e6:.3f} M")
    print(f"FLOPs (FlopCounterMode: products, 2 a multiply-add; whole clip): {flops / 1e9:.2f} G")
    print(f"FLOPs per frame: {flops / t / 1e9:.2f} G")
    return n_params, flops


if __name__ == "__main__":
    main()
