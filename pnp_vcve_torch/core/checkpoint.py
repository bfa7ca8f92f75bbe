"""Generator weights from a file under the original reference's names
(counterpart of pnp_vcve_tpu/core/checkpoint.py's ``load_params``).

A ``.pth`` (a bare state dict or a checkpoint holding one under
``state_dict``, keys with or without a ``generator.`` prefix) or an ``.npz``
of arrays loads with ``load_state_dict(strict=True)``; ``'-'`` keeps a
random init drawn from a seeded generator.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["read_state_dict", "load_generator_weights"]

_IGNORED = ("spynet.", "edvr.", "step_counter")


def read_state_dict(path: str | Path) -> Dict[str, torch.Tensor]:
    """Float32 CPU tensors under the reference names (``generator.`` prefix
    stripped; the other entries of a full restorer checkpoint, such as a
    discriminator's, dropped)."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            raw = {k: torch.from_numpy(z[k].astype(np.float32)) for k in z.files}
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        raw = ckpt.get("state_dict", ckpt)
    if any(k.startswith("generator.") for k in raw):
        raw = {k: v for k, v in raw.items() if k.startswith("generator.")}
    sd = {re.sub(r"^generator\.", "", k): v.float() for k, v in raw.items()}
    # submodules of other reference generators, ignored as the JAX converter does
    return {k: v for k, v in sd.items() if not k.startswith(_IGNORED)}


def load_generator_weights(model: nn.Module, checkpoint: str, seed: int = 0):
    """``checkpoint``: a file path, or ``'-'`` for a random init drawn from a
    CPU ``torch.Generator`` seeded with ``seed``."""
    if checkpoint == "-":
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(read_state_dict(checkpoint), strict=True)
    return model
