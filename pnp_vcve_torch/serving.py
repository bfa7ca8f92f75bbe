"""Batch-of-streams serving scheduler (counterpart of pnp_vcve_tpu/serving.py).

Independent client *streams* submit clips; the scheduler groups same-shape
clips into one dispatch while keeping each stream's clips in submission
order, and reports per-clip latency, so the latency/throughput trade can be
measured.

- :class:`StreamScheduler` dispatches as soon as ``max_batch`` same-shape
  clips wait, or when the oldest queued clip of a shape has waited
  ``max_wait_s`` (the latency bound), never reordering a stream.
- :func:`batched_forward_executor` stacks B same-shape clips on the model's
  batch axis and runs one forward: one card, throughput first, each clip's
  latency growing with B.
- :func:`exact_stream_executor` runs one clip through the exact two-sweep
  pipeline over a list of devices, and B clips through its stream
  (parallel/seqpar.py): each output equal bit for bit to the clip's full
  sweep.

The dispatcher is a thread of its own, and PyTorch's grad mode is per
thread: the executor enters ``torch.inference_mode()`` itself (through
``make_eval_step``), so a forward never records a graph, whatever the
submitting thread does.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

__all__ = [
    "Ticket",
    "StreamScheduler",
    "batched_forward_executor",
    "exact_stream_executor",
]


@dataclass
class Ticket:
    """One submitted clip: ``wait()`` blocks until its result is ready."""

    stream_id: str
    seq: int
    submitted_at: float
    _event: threading.Event = field(default_factory=threading.Event, repr=False)
    _result: Any = field(default=None, repr=False)
    _error: Optional[BaseException] = field(default=None, repr=False)
    done_at: Optional[float] = None
    dispatched_batch: int = 0  # size of the batch this clip rode in

    def wait(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.stream_id}#{self.seq} not done")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        if self.done_at is None:
            return None
        return self.done_at - self.submitted_at


class StreamScheduler:
    """Groups same-shape clips from many streams into batched dispatches.

    Args:
      executor: ``list[sample] -> list[output]``, e.g.
        :func:`batched_forward_executor`. Called from the one dispatcher
        thread, so executors need no locking.
      max_batch: dispatch as soon as this many same-shape clips wait.
      max_wait_s: latency bound: dispatch whatever is queued for a shape
        once its oldest clip has waited this long.

    Clips of one stream are dispatched and completed in submission order;
    across streams, arrival order decides batch membership (batches are
    formed from the head of each shape's queue).
    """

    def __init__(
        self,
        executor: Callable[[Sequence[dict]], List[np.ndarray]],
        max_batch: int = 2,
        max_wait_s: float = 0.05,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._executor = executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._lock = threading.Condition()
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()  # shape -> (ticket, sample)
        self._seq: Dict[str, int] = {}
        self._closing = False
        self._dispatches: List[dict] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------------

    def submit(self, stream_id: str, sample: dict) -> Ticket:
        """Queue one clip ``sample`` (keys as in ``train.eval.enhance_clip``:
        lq/qps/slices/mvs/base_qps/partitions, time first)."""
        key = tuple(np.asarray(sample["lq"]).shape)
        with self._lock:
            if self._closing:
                raise RuntimeError("scheduler closed")
            seq = self._seq.get(stream_id, 0)
            self._seq[stream_id] = seq + 1
            t = Ticket(stream_id=stream_id, seq=seq, submitted_at=time.perf_counter())
            self._queues.setdefault(key, deque()).append((t, sample))
            self._lock.notify_all()
        return t

    def close(self, drain: bool = True):
        """Stop accepting work; with ``drain`` wait for the queued clips."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        if drain:
            self._thread.join()

    def stats(self) -> dict:
        """Dispatch log: per-dispatch batch size, wall and shape; per-clip
        latency mean and 95th percentile."""
        with self._lock:
            d = list(self._dispatches)
        lat = [t.latency_s for dd in d for t in dd["tickets"]]
        return dict(
            dispatches=[dict(batch=dd["batch"], wall_s=dd["wall_s"], shape=dd["shape"])
                        for dd in d],
            clips=len(lat),
            mean_latency_s=float(np.mean(lat)) if lat else 0.0,
            p95_latency_s=float(np.percentile(lat, 95)) if lat else 0.0,
        )

    # -- dispatcher -------------------------------------------------------------

    def _pick(self) -> Optional[tuple]:
        """A shape to dispatch: a full batch, or the one whose head clip has
        waited max_wait_s, or (when closing) anything queued."""
        now = time.perf_counter()
        for key, q in self._queues.items():
            if len(q) >= self.max_batch:
                return key
        for key, q in self._queues.items():
            if q and (self._closing or now - q[0][0].submitted_at >= self.max_wait_s):
                return key
        return None

    def _run(self):
        while True:
            with self._lock:
                key = self._pick()
                while key is None:
                    if self._closing and not any(self._queues.values()):
                        return
                    # wake at the earliest deadline among the queue heads
                    heads = [q[0][0].submitted_at for q in self._queues.values() if q]
                    wait = (max(0.0, min(heads) + self.max_wait_s - time.perf_counter())
                            if heads else None)
                    self._lock.wait(timeout=wait)
                    key = self._pick()
                q = self._queues[key]
                batch = [q.popleft() for _ in range(min(self.max_batch, len(q)))]
                if not q:
                    del self._queues[key]
            tickets = [t for t, _ in batch]
            t0 = time.perf_counter()
            try:
                outs, err = self._executor([s for _, s in batch]), None
            except Exception as e:  # surfaced on every ticket of the batch
                outs, err = [None] * len(tickets), e
            wall = time.perf_counter() - t0
            for t, o in zip(tickets, outs):
                t._result = o
                t._error = err
                t.done_at = time.perf_counter()
                t.dispatched_batch = len(tickets)
                t._event.set()
            with self._lock:
                self._dispatches.append(dict(batch=len(tickets), wall_s=wall, shape=key,
                                             tickets=tickets))


def batched_forward_executor(model) -> Callable[[Sequence[dict]], List[np.ndarray]]:
    """One-card executor: stack B same-shape clips on the batch axis, run one
    forward of ``model`` (on its own device, under inference mode), split the
    ``(B, t, h, w, 3)`` float32 output back into B clips."""
    eval_step = make_eval_step(model)

    def run(samples: Sequence[dict]) -> List[np.ndarray]:
        batch = {k: np.stack([np.asarray(s[k]) for s in samples]) for k in MODEL_INPUT_KEYS}
        out = eval_step(batch)
        return [out[i] for i in range(out.shape[0])]

    return run


def exact_stream_executor(model, devices: Sequence, feature_dtype=None
                          ) -> Callable[[Sequence[dict]], List[np.ndarray]]:
    """Multi-device executor (JAX serving.py:235-256): one clip through the
    exact pipeline over ``devices`` (chunk d on ``devices[d]``, repeats
    allowed; t divisible by their count), B clips through its stream, B + D
    - 1 steps a sweep. Each output equals the clip's full sweep bit for
    bit. ``feature_dtype``: the sweeps' feature type (None: the
    generator's)."""
    from pnp_vcve_torch.parallel.seqpar import (
        enhance_clip_exact_pipeline,
        enhance_clips_exact_stream,
    )

    def run(samples: Sequence[dict]) -> List[np.ndarray]:
        if len(samples) == 1:
            return [enhance_clip_exact_pipeline(model, samples[0], devices, feature_dtype)]
        return enhance_clips_exact_stream(model, list(samples), devices, feature_dtype)

    return run
