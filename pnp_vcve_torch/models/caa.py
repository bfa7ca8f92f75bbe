"""CAA (compression-aware adaptation) predictors (counterpart of
pnp_vcve_tpu/models/caa.py:27-84).

Tiny MLPs from per-frame codec metadata ``(b, t)`` to per-frame BAE
parameters, batched over all frames at once. Submodule names are the
reference's, so its state dict loads as it is
(``BasePredictor.BaseNet.{0,2}``, ``BiasePredictor.fc.{0,2}``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from .init import torch_default_

__all__ = ["BasePredictor", "SEModule", "BiasPredictor", "hsigmoid"]


def _scalars(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1).float()


class BasePredictor(nn.Module):
    """CRF -> expert routing: Linear(1, nf), ReLU, Linear(nf, K)[, softmax]."""

    def __init__(self, nf=64, num_experts=6, softmax=True):
        super().__init__()
        self.softmax = softmax
        self.BaseNet = nn.Sequential(
            nn.Linear(1, nf), nn.ReLU(),
            nn.Linear(nf, num_experts),
        )

    def reset_parameters(self, generator):
        torch_default_(self.BaseNet[0], generator)
        torch_default_(self.BaseNet[2], generator)

    def forward(self, crfs):
        b, t = crfs.shape
        x = self.BaseNet(_scalars(crfs))
        if self.softmax:
            x = torch.softmax(x, dim=-1)
        return x.reshape(b, t, -1)


def hsigmoid(x):
    """relu6(x + 3) / 3 (reference domain_aware.py:201-207)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 3.0


class SEModule(nn.Module):
    """QP -> per-channel gain: Linear(1, c/r), ReLU, Linear(c/r, c), hsigmoid;
    no biases. Returns ``(gamma (b, t, c), None)``."""

    def __init__(self, channels=64, reduction=16):
        super().__init__()
        hidden = max(1, channels // reduction)
        self.fc = nn.Sequential(
            nn.Linear(1, hidden, bias=False), nn.ReLU(),
            nn.Linear(hidden, channels, bias=False),
        )

    def reset_parameters(self, generator):
        torch_default_(self.fc[0], generator)
        torch_default_(self.fc[2], generator)

    def forward(self, qps):
        b, t = qps.shape
        return hsigmoid(self.fc(_scalars(qps))).reshape(b, t, -1), None


class BiasPredictor(nn.Module):
    """QP -> FiLM (gamma, beta): embed, sigmoid / tanh heads."""

    def __init__(self, nf=64):
        super().__init__()
        self.qf_embed = nn.Sequential(nn.Linear(1, nf), nn.ReLU())
        self.to_gamma = nn.Sequential(nn.Linear(nf, nf), nn.Sigmoid())
        self.to_beta = nn.Sequential(nn.Linear(nf, nf), nn.Tanh())

    def reset_parameters(self, generator):
        for seq in (self.qf_embed, self.to_gamma, self.to_beta):
            torch_default_(seq[0], generator)

    def forward(self, qps):
        b, t = qps.shape
        emb = self.qf_embed(_scalars(qps))
        return self.to_gamma(emb).reshape(b, t, -1), self.to_beta(emb).reshape(b, t, -1)
