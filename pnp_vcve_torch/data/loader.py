"""Batched, prefetching training input (counterpart of
pnp_vcve_tpu/data/loader.py; the reference's torch DataLoader with its
DistributedWeightedSampler, mmedit/datasets/builder.py:52-199).

- :class:`WeightedMixture` draws each sample from one of several datasets
  with probability proportional to its weight (the reference's
  ``mix_data=True, weights=[1, 2, 1]``).
- :class:`PrefetchLoader` builds batches ahead of time in worker threads
  (PNG decode and the MV rasterizer release the interpreter lock for most of
  their time), as CPU tensors, pinned when the batches go to a CUDA device,
  and copies each to ``device`` without blocking the host.

Every sample comes from an ``np.random.Generator`` seeded by
``(seed, step, slot)``, so one seed and start step give the same batches
whatever the number of threads, as the JAX loader does. Under data
parallelism the global batch of ``world * batch_size`` slots is drawn as
one process would draw it, and rank ``r`` loads only its rows, slots
``r * batch_size .. (r + 1) * batch_size - 1`` (JAX shards the global
batch's rows over ``dp`` in the same order).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .pipeline import Sample

__all__ = ["WeightedMixture", "PrefetchLoader", "collate"]


class WeightedMixture:
    """Sample from N datasets with probabilities proportional to weights."""

    def __init__(self, datasets: Sequence, weights: Sequence[float]):
        if len(datasets) != len(weights):
            raise ValueError("datasets and weights length mismatch")
        self.datasets = list(datasets)
        p = np.asarray(weights, np.float64)
        self.p = p / p.sum()

    def sample(self, rng: np.random.Generator) -> Sample:
        return self.datasets[int(rng.choice(len(self.datasets), p=self.p))].sample(rng)


def collate(samples: Sequence[Sample]) -> dict:
    """Stack sample dicts into batched arrays ``(b, t, ...)``."""
    keys = [k for k in samples[0] if isinstance(samples[0][k], np.ndarray)]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class PrefetchLoader:
    """Endless batch iterator: worker threads build the batches of the next
    steps, at most ``num_threads + prefetch`` ahead of the consumer.
    ``batch_size`` is this rank's share; ``rank`` of ``world`` picks its rows
    of the global batch."""

    def __init__(self, source, batch_size: int, seed: int = 0, num_threads: int = 4,
                 prefetch: int = 2, device: Optional[torch.device] = None,
                 start_step: int = 0, rank: int = 0, world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.source = source
        self.batch_size = batch_size
        self.seed = seed
        self.first_slot = rank * batch_size
        # workers_per_gpu=0 (the reference's synchronous loading) is one
        # worker thread here
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.device = torch.device(device) if device is not None else None
        self._pin = self.device is not None and self.device.type == "cuda"
        self._next_to_emit = start_step
        self._claim = start_step
        self._pending: dict[int, dict] = {}
        self._lock = threading.Condition()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._error: Optional[BaseException] = None

    def _build_batch(self, step: int) -> dict:
        """The batch of ``step`` as CPU tensors."""
        samples = [
            self.source.sample(np.random.default_rng(np.random.SeedSequence([self.seed, step, slot])))
            for slot in range(self.first_slot, self.first_slot + self.batch_size)
        ]
        batch = {k: torch.from_numpy(v) for k, v in collate(samples).items()}
        if self._pin:
            batch = {k: v.pin_memory() for k, v in batch.items()}
        return batch

    def _worker(self):
        while True:
            with self._lock:
                while (not self._stop.is_set()
                       and self._claim >= self._next_to_emit + self.num_threads + self.prefetch):
                    self._lock.wait()
                if self._stop.is_set():
                    return
                step = self._claim
                self._claim += 1
            try:
                batch = self._build_batch(step)
            except BaseException as e:  # handed to the consumer, which raises it
                with self._lock:
                    self._error = e
                    self._stop.set()
                    self._lock.notify_all()
                return
            with self._lock:
                self._pending[step] = batch
                self._lock.notify_all()

    def start(self):
        for _ in range(self.num_threads):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        """Stop the workers and wait for them (each finishes its batch)."""
        with self._lock:
            self._stop.set()
            self._lock.notify_all()
        for t in self._threads:
            t.join(60.0)

    def __iter__(self):
        if not self._threads:
            self.start()
        return self

    def __next__(self) -> dict:
        with self._lock:
            while self._next_to_emit not in self._pending:
                if self._error is not None:
                    raise RuntimeError("data loader worker failed") from self._error
                if self._stop.is_set():
                    raise StopIteration
                self._lock.wait(timeout=60.0)
            batch = self._pending.pop(self._next_to_emit)
            self._next_to_emit += 1
            self._lock.notify_all()
        if self.device is not None:
            batch = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
        return batch
