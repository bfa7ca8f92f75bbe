"""Checkpoint I/O (counterpart of pnp_vcve_tpu/core/checkpoint.py).

- Generator weights under the original reference's names (``load_params``):
  a ``.pth`` (a bare state dict, a checkpoint holding one under
  ``state_dict``, or a training checkpoint of this package, keys with or
  without a ``generator.`` prefix) or an ``.npz`` of arrays loads with
  ``load_state_dict(strict=True)``; ``'-'`` keeps a random init drawn from a
  seeded generator.
- Training checkpoints (``CheckpointManager`` :24, ``restore_train_state``
  :92; reference CheckpointHook and resume_from, mmedit/apis/
  train.py:235-238): ``<work_dir>/ckpt/<step>.pth``, each a ``torch.save``
  of ``{step, model, optimizer, scheduler}``.
- Publishing (``publish_params`` :136; reference tools/publish_model.py:
  18-31): :func:`publish_state_dict` keeps a checkpoint's generator weights
  and tags the file with its content hash.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from .convert import shared_aligner_to_sweeps

__all__ = [
    "read_state_dict", "load_generator_weights", "CheckpointManager", "restore_train_state",
    "publish_state_dict",
]

_IGNORED = ("spynet.", "edvr.", "step_counter")
# buffers of the reference's SPyNet that the port holds as constants
_CONSTANTS = ("spynet.mean", "spynet.std")


def read_state_dict(path: str | Path, owned: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """Float32 CPU tensors under the port's names: the reference's
    (``generator.`` prefix stripped; the other entries of a full restorer
    checkpoint, such as a discriminator's, dropped), with the reference's
    one ``deform_align.*`` written into each sweep's aligner.

    ``owned``: the names of the model that will load it. Submodules of other
    reference generators (``spynet.``, ``edvr.``, ``step_counter``) are
    dropped unless the model owns names under them (the baselines carry a
    SPyNet), and ``deform_align.*`` stays as it is where the model owns it
    (BasicVSR++'s four aligners)."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            raw = {k: torch.from_numpy(z[k].astype(np.float32)) for k in z.files}
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        raw = ckpt.get("state_dict", ckpt.get("model", ckpt))
    if any(k.startswith("generator.") for k in raw):
        raw = {k: v for k, v in raw.items() if k.startswith("generator.")}
    sd = {re.sub(r"^generator\.", "", k): v.float() for k, v in raw.items()}
    owned = tuple(owned)
    # submodules of other reference generators, ignored as the JAX converter does
    ignored = tuple(p for p in _IGNORED if not any(k.startswith(p) for k in owned))
    sd = {k: v for k, v in sd.items() if not k.startswith(ignored) and not k.endswith(_CONSTANTS)}
    if any(k.startswith("deform_align.") for k in owned):
        return sd
    return shared_aligner_to_sweeps(sd)


def load_generator_weights(model: nn.Module, checkpoint: str, seed: int = 0):
    """``checkpoint``: a file path, or ``'-'`` for a random init drawn from a
    CPU ``torch.Generator`` seeded with ``seed``."""
    if checkpoint == "-":
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(read_state_dict(checkpoint, model.state_dict()), strict=True)
    return model


class CheckpointManager:
    """Step-indexed checkpoints ``<workdir>/ckpt/<step>.pth``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, workdir: str | Path, max_to_keep: int = 5):
        self.path = Path(workdir).absolute() / "ckpt"
        self.path.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(f.stem) for f in self.path.glob("*.pth") if f.stem.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: dict):
        # write under a temporary name, then rename: a cut run never leaves
        # a half-written checkpoint under a step's name
        tmp = self.path / f".{step}.pth.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path / f"{step}.pth")
        for old in self.steps()[: -self.max_to_keep]:
            (self.path / f"{old}.pth").unlink()

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path / f"{step}.pth", map_location="cpu", weights_only=True)


def restore_train_state(path: str | Path, state):
    """Restore a ``TrainState`` in place from ``path``: a work dir (holding
    ``ckpt/``) or a ``ckpt/`` dir (its newest step), or one checkpoint file.
    The weights and the step always; the optimizer and the schedule where
    the checkpoint holds them. Returns ``(state, start_iter)``."""
    path = Path(path).absolute()
    workdir = path.parent if path.name == "ckpt" else path
    if path.is_file():
        payload = torch.load(path, map_location="cpu", weights_only=True)
    elif (workdir / "ckpt").is_dir():
        payload = CheckpointManager(workdir).restore()
        if payload is None:
            return state, 0
    else:
        raise FileNotFoundError(f"no checkpoint file, work dir or ckpt/ dir at {path}")
    state.model.load_state_dict(payload["model"], strict=True)
    if "optimizer" in payload:
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
    state.step = int(payload["step"])
    return state, state.step


def publish_state_dict(src: str | Path, dst_prefix: str | Path) -> Path:
    """Publish the generator weights of ``src`` (a training checkpoint of
    tools/torch_train.py, a checkpoint holding a ``state_dict``, or a bare
    state dict; keys with or without a ``generator.`` prefix) as
    ``<dst_prefix>-<sha8>.pth``: ``{"state_dict": weights}`` under the
    generator's names, each tensor as it was, without the optimizer, the
    schedule or the step; ``sha8`` is the first 8 hex digits of the sha256
    of the file's bytes (the reference's form; the JAX package hashes a
    checkpoint directory). Returns the file's path."""
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    raw = ckpt.get("state_dict", ckpt.get("model", ckpt))
    if any(k.startswith("generator.") for k in raw):
        raw = {re.sub(r"^generator\.", "", k): v for k, v in raw.items()
               if k.startswith("generator.")}
    buf = io.BytesIO()  # a file name would enter the archive's record names
    torch.save({"state_dict": dict(raw)}, buf)
    blob = buf.getvalue()
    dst = Path(f"{dst_prefix}-{hashlib.sha256(blob).hexdigest()[:8]}.pth")
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_bytes(blob)
    return dst
