"""Random initialisation from an explicit generator (counterpart of
pnp_vcve_tpu/models/init.py, as far as a random ``checkpoint '-'`` needs it).

The expert banks and the DRT blocks' convs follow the reference's init
(kaiming-uniform per expert; kaiming-normal x 0.1 for the residual branch);
every other layer gets PyTorch's default init. Values are drawn on the CPU
from ``generator`` and copied to each parameter's device, so a seed gives
the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = [
    "kaiming_uniform_expert_",
    "scaled_kaiming_normal_",
    "torch_default_",
    "torch_default_all_",
]


def _fill(param: torch.Tensor, values: torch.Tensor):
    with torch.no_grad():
        param.copy_(values.to(param.dtype))


def kaiming_uniform_expert_(bank: torch.Tensor, generator: torch.Generator):
    """U(-b, b), b = sqrt(6 / fan_in), fan_in = cin * kh * kw of one expert
    ``(K, cout, cin, kh, kw)`` (reference Dynamic_conv2d._initialize_weights)."""
    _, _, cin, kh, kw = bank.shape
    bound = math.sqrt(6.0 / (cin * kh * kw))
    v = torch.empty(bank.shape).uniform_(-bound, bound, generator=generator)
    _fill(bank, v)


def scaled_kaiming_normal_(w: torch.Tensor, scale: float, generator: torch.Generator):
    """N(0, 2 / fan_in) x scale (mmcv kaiming_init + the x0.1 residual scaling)."""
    fan_in = w[0].numel()
    std = math.sqrt(2.0 / fan_in) * scale
    _fill(w, torch.empty(w.shape).normal_(0.0, std, generator=generator))


def torch_default_(module: nn.Module, generator: torch.Generator):
    """PyTorch's default init of ``nn.Linear`` / ``nn.Conv2d``: kaiming
    uniform with a = sqrt(5) on the weight, U(+-1/sqrt(fan_in)) on the bias."""
    w = torch.empty(module.weight.shape)
    nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
    _fill(module.weight, w)
    if module.bias is not None:
        bound = 1.0 / math.sqrt(module.weight[0].numel())
        _fill(module.bias, torch.empty(module.bias.shape).uniform_(-bound, bound,
                                                                   generator=generator))


def torch_default_all_(module: nn.Module, generator: torch.Generator):
    """:func:`torch_default_` on every submodule of ``module`` (itself
    included, in module order) that holds a ``weight`` of two or more dims:
    convs, transposed convs, Linears and the baselines' DCN and PAC weight
    holders."""
    for m in module.modules():
        w = m._parameters.get("weight")
        if w is not None and w.dim() >= 2:
            torch_default_(m, generator)
