"""Multi-process eval: rank-strided clip shards and the exact cross-process
metric reduction (counterpart of pnp_vcve_tpu/parallel/multihost.py).

The reference gathers whole per-clip outputs across ranks by pickling them
(mmedit/apis/test.py:129-234). Here only metric scalars cross processes:
one ``all_gather`` of a small float32 vector over a gloo process group, as
JAX's ``process_allgather`` moves host numbers. Images stay with the rank
that made them. Gloo carries host tensors, so no NCCL is needed and several
ranks may share one card.

Launch: ``torchrun`` (``tools/torch_dist_test.sh``) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`init_distributed` reads them.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = ["shard_clips", "allreduce_clip_metrics", "init_distributed"]

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


def init_distributed(launcher: str = "pytorch", device_type: str = "cuda") -> torch.device:
    """Join the ``torchrun`` world (``--launcher pytorch``): a gloo process
    group at ``tcp://MASTER_ADDR:MASTER_PORT`` with the environment's rank
    and world size. Returns this rank's device: ``cuda:(LOCAL_RANK %
    device_count)``, or the CPU when ``device_type`` is 'cpu'. Raises on a
    missing variable or, for 'cuda', when there is no card; it never falls
    back to one process."""
    import torch.distributed as dist

    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: only 'pytorch' (torchrun) is supported")
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch: {', '.join(missing)} not set "
                           "(run under torchrun, e.g. tools/torch_dist_test.sh)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--launcher pytorch with --device cuda: no CUDA device is available")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world)
    return device
