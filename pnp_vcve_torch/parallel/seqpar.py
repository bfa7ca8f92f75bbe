"""The exact chunked two-sweep pipeline over a list of devices (counterpart
of pnp_vcve_tpu/parallel/seqpar.py).

The bidirectional recurrence is sequential in time, so the exact
multi-device form of one clip is a two-phase pipeline over time chunks that
hands each sweep's carry from chunk to chunk:

- the clip's ``t`` frames split into ``D = len(devices)`` equal chunks;
  chunk ``d`` lives on ``devices[d]``, with a replica of the generator there
  (one for each distinct device);
- phase A sweeps backward: at step ``s`` chunk ``D-1-s`` runs its backward
  sweep from the carry ``(prev_out, last_key, prev_was_key)`` of the chunk
  to its right, moved to its device (``.to(device, non_blocking=True)``, a
  no-op on a repeated device). That carry is exactly the state a full sweep
  has at the chunk boundary;
- phase B mirrors it forward: at step ``s`` chunk ``s`` runs its forward
  sweep and heads on its stored backward features.

A chunk boundary is not a clip boundary: the first and last frames are
forced keyframes once, on the clip's global mask, which is then chunked and
passed as ``keyframe_mask``.

JAX runs this as one SPMD program (``shard_map``): every device computes
every step and the inactive results are dropped. Here one process launches
only the active steps. The arithmetic is that of the full sweep, so the
output equals it bit for bit. Launches are asynchronous, so on distinct
cards the chunks of one step overlap; on one card, or a repeated device,
they run one after another.

For one clip each step keeps one device busy; :func:`enhance_clips_exact_stream`
streams B clips through the same schedule, B + D - 1 steps a sweep.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from pnp_vcve_torch.models.pnp_vcve import keyframe_indices
from pnp_vcve_torch.train.train_step import _model_inputs

__all__ = [
    "enhance_clip_exact_pipeline", "enhance_clips_exact_stream",
    "largest_divisor_chunks",
]

def largest_divisor_chunks(t: int, max_chunks: int) -> int:
    """Largest D <= max_chunks with t % D == 0 (exactness needs equal
    chunks)."""
    for d in range(max_chunks, 0, -1):
        if t % d == 0:
            return d
    return 1


def _chunked_inputs(sample: dict, D: int) -> Dict[str, np.ndarray]:
    """Per-clip generator inputs chunked to ``(D, 1, ct, ...)`` numpy arrays,
    with ``keyframe`` the clip's global mask (first and last frames forced
    once, before chunking: a chunk boundary is not a clip boundary)."""
    t = sample["lq"].shape[0]
    ct = t // D

    def chunked(x):  # (t, ...) -> (D, 1, ct, ...): the batch axis b=1
        x = np.asarray(x)
        return x.reshape(D, ct, *x.shape[1:])[:, None]

    inputs = {k: chunked(np.asarray(v, np.float32)) for k, v in _model_inputs(sample).items()}
    slices = torch.as_tensor(np.asarray(sample["slices"], np.float32))[None]
    inputs["keyframe"] = chunked(keyframe_indices(slices)[0][0].numpy())
    return inputs


def _replicas(model: torch.nn.Module, devices: Sequence[torch.device]) -> dict:
    """The generator on each distinct device: ``model`` itself on its own,
    a copy elsewhere."""
    home = next(model.parameters()).device
    out = {}
    for dev in map(torch.device, devices):
        if dev not in out:
            out[dev] = model if dev == home else copy.deepcopy(model).to(dev)
    return out


@contextmanager
def _feature_type(models, dtype):
    """Run ``models`` with ``feature_dtype = dtype`` (None: as they are)."""
    saved = [m.feature_dtype for m in models]
    if dtype is not None:
        for m in models:
            m.feature_dtype = dtype
    try:
        yield
    finally:
        for m, d in zip(models, saved):
            m.feature_dtype = d


def _to(carry, device):
    return None if carry is None else tuple(v.to(device, non_blocking=True) for v in carry)


def _chunk_on(inputs: Dict[str, np.ndarray], d: int, device) -> dict:
    """Chunk ``d`` of ``_chunked_inputs`` as tensors on ``device``."""
    return {k: torch.as_tensor(v[d]).to(device, non_blocking=True) for k, v in inputs.items()}


def enhance_clips_exact_stream(model: torch.nn.Module, samples: Sequence[dict],
                               devices: Sequence[torch.device],
                               feature_dtype: Optional[torch.dtype] = None) -> List[np.ndarray]:
    """Stream B same-shape clips through the D-deep pipeline,
    ``D = len(devices)``.

    Each sweep takes B + D - 1 steps: at step ``s`` device ``d`` runs the
    backward chunk of clip ``k = s - (D-1-d)`` (phase B: the forward chunk of
    clip ``k = s - d``) for every ``0 <= k < B``. The carry a device hands on
    is the one its neighbour needs next step, for the same clip; a clip
    enters at the edge device from zero carries, as JAX's non-cyclic
    ``ppermute`` gives them. Each device holds the backward features of
    every clip in flight, ``(B, ct, h, w, c)``, so ``B`` bounds the memory.

    Args:
      model: a PnPVCVE (the chunk API: ``sweep``, ``carry``, ``bwd_feats``,
        ``keyframe_mask``).
      samples: B clip dicts with time-first arrays ``lq (t, h, w, 3)``,
        ``qps``, ``slices``, ``mvs``, ``base_qps``, ``partitions``, of one
        shape; t divisible by D (:func:`largest_divisor_chunks`).
      devices: chunk ``d``'s device; repeats allowed.
      feature_dtype: the type the sweeps carry and store features in (None:
        the generator's).

    Returns: B ``(t, h, w, 3)`` float32 numpy outputs, each equal bit for bit
    to the generator's full sweep of that clip.
    """
    devices = [torch.device(d) for d in devices]
    B, D = len(samples), len(devices)
    t = samples[0]["lq"].shape[0]
    if t % D:
        raise ValueError(f"t={t} not divisible by pipeline depth {D}")
    if any(s["lq"].shape != samples[0]["lq"].shape for s in samples):
        raise ValueError("the clips of a stream must have one shape")
    reps = _replicas(model, devices)
    chunks = [_chunked_inputs(s, D) for s in samples]
    feats = [[None] * D for _ in range(B)]
    ys = [[None] * D for _ in range(B)]
    with torch.inference_mode(), _feature_type(reps.values(), feature_dtype):
        inputs = [[_chunk_on(c, d, devices[d]) for d in range(D)] for c in chunks]

        def run(k, d, carry, **kw):
            x = dict(inputs[k][d])
            key = x.pop("keyframe")
            return reps[devices[d]](**x, carry=_to(carry, devices[d]), keyframe_mask=key, **kw)

        # phase A: the backward sweep, chunks right to left; carry[k] is what
        # clip k's last chunk handed on (None, zeros, before its first)
        carry: list = [None] * B
        for s in range(B + D - 1):
            for d in range(D):
                k = s - (D - 1 - d)
                if 0 <= k < B:
                    feats[k][d], carry[k] = run(k, d, carry[k], sweep="backward")
        # phase B: the forward sweep and heads, chunks left to right
        carry = [None] * B
        for s in range(B + D - 1):
            for d in range(D):
                k = s - d
                if 0 <= k < B:
                    ys[k][d], carry[k] = run(k, d, carry[k], sweep="forward",
                                             bwd_feats=feats[k][d])
                    feats[k][d] = None
        return [torch.cat([y.cpu() for y in ys_k], 1)[0].numpy() for ys_k in ys]


def enhance_clip_exact_pipeline(model: torch.nn.Module, sample: dict,
                                devices: Sequence[torch.device],
                                feature_dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """One clip through the exact pipeline over ``devices`` (chunk ``d`` on
    ``devices[d]``; t divisible by ``len(devices)``). Returns ``(t, h, w, 3)``
    float32 numpy, equal bit for bit to the generator's full sweep. The
    stream of one clip: phase A runs chunk ``D-1-s`` at step ``s``, phase B
    chunk ``s``."""
    return enhance_clips_exact_stream(model, [sample], devices, feature_dtype)[0]
