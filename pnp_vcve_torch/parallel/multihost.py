"""Multi-process runs: rank-strided clip shards, the exact cross-process
metric reduction (counterpart of pnp_vcve_tpu/parallel/multihost.py) and
the process group of data-parallel training (the ``dp`` axis of
pnp_vcve_tpu/parallel/sharding.py: ``make_mesh``).

The reference gathers whole per-clip outputs across ranks by pickling them
(mmedit/apis/test.py:129-234). Here only metric scalars cross processes:
one ``all_gather`` of a small float32 vector over the group's host backend,
as JAX's ``process_allgather`` moves host numbers. Images stay with the
rank that made them.

The backend is a rule (:func:`choose_backend`), not a fallback: NCCL for
device tensors when every rank of the node has a card of its own, gloo when
ranks share a card or run on the CPU. Host tensors always go over gloo.

Launch: ``torchrun`` (``tools/torch_dist_test.sh``,
``tools/torch_dist_train.sh``) sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`init_distributed` reads them.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["shard_clips", "allreduce_clip_metrics", "choose_backend", "num_cards",
           "init_distributed", "rank_and_world"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def shard_clips(n_clips: int, process_index: int, process_count: int) -> range:
    """Strided rank subsample of clip indices (the reference
    DistributedSampler's rank::num_replicas split, samplers/
    distributed_sampler.py:60-66, without padding: the reduction below is
    count-weighted, so uneven shards stay exact)."""
    return range(process_index, n_clips, process_count)


def allreduce_clip_metrics(per_clip: Sequence[Dict[str, float]],
                           keys: Sequence[str] | None = None) -> Dict[str, float]:
    """The dataset mean from each process's own per-clip metrics: gather
    ``[count, sum_metric0, ...]`` (float32, as JAX builds it) from every
    rank and combine, so the result equals the single-process mean however
    the clips were sharded. Without a process group, the local mean."""
    import torch.distributed as dist

    if keys is None:
        keys = sorted(per_clip[0]) if per_clip else []
    local = np.asarray([float(len(per_clip))] + [sum(m[k] for m in per_clip) for k in keys],
                       np.float32)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        mine = torch.from_numpy(local)
        gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, mine)
        local = torch.stack(gathered).numpy().sum(axis=0)
    total, *sums = local
    if total == 0:
        return {}
    return {k: float(s / total) for k, s in zip(keys, sums)}


def rank_and_world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def num_cards(available: int) -> int:
    """The cards this node's ranks may use: ``PNP_NUM_CHIPS`` (or ``CHIPS``)
    when set above 0, else every card, as ``make_mesh`` bounds its devices
    (sharding.py:33-46). Asking for more than ``available`` raises."""
    n = int(os.environ.get("PNP_NUM_CHIPS", os.environ.get("CHIPS", "0")) or 0)
    if n <= 0:
        return available
    if n > available:
        raise ValueError(f"CHIPS={n} requested but only {available} devices")
    return n


def choose_backend(device_type: str, local_world: int, cards: int) -> str:
    """The process group's backend: ``'cpu:gloo,cuda:nccl'`` (NCCL for the
    device tensors, gloo for the host ones) when the ranks run on cards and
    each of the node's ``local_world`` ranks has a card of its own
    (``local_world <= cards``); ``'gloo'`` when ranks share a card or run
    on the CPU."""
    if device_type == "cuda" and 0 < local_world <= cards:
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_distributed(launcher: str = "pytorch", device_type: str = "cuda") -> torch.device:
    """Join the ``torchrun`` world (``--launcher pytorch``): a process group
    at ``tcp://MASTER_ADDR:MASTER_PORT`` with the environment's rank and
    world size, on :func:`choose_backend`'s backend (printed by rank 0).
    Returns this rank's device: ``cuda:(LOCAL_RANK % cards)`` with
    :func:`num_cards`'s count, or the CPU when ``device_type`` is 'cpu'.
    Raises on a missing variable, for 'cuda' when there is no card, and when
    the chosen backend fails to start; it never falls back to one process
    or to another backend."""
    import torch.distributed as dist

    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: only 'pytorch' (torchrun) is supported")
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch: {', '.join(missing)} not set "
                           "(run under torchrun, e.g. tools/torch_dist_test.sh)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cards = 0
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--launcher pytorch with --device cuda: no CUDA device is available")
        cards = num_cards(torch.cuda.device_count())
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = choose_backend(device.type, local_world, cards)
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
        if rank == 0:
            print(f"[dist] backend {backend}: {world} ranks, {local_world} on this node, "
                  f"{cards or 'no'} card(s)", flush=True)
    return device
