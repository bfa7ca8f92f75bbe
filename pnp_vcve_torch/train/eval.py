"""Evaluation harness: full-clip enhancement and the sequence metrics
(counterpart of pnp_vcve_tpu/train/eval.py: ``enhance_clip`` :57-74,
``evaluate_dataset`` :77-190, ``evaluate_dataset_mfqe_joint`` :193-242,
``enhance_clip_frame_parallel`` :245-309).

Per clip: run the generator over the whole sequence (or over independent
``chunk_t``-frame windows), compute per-frame PSNR/SSIM on uint8-quantised
frames, average per clip and then over the dataset, and optionally write
``<save_path>/<clip>/<i:08d>.png``.

Memory: the backward sweep keeps a ``(1, t, h, w, c)`` feature stack on the
device (100 frames of 720p at 64 channels in float32: 23.6 GB). ``chunk_t``
splits a clip into independent windows (each window's first and last frames
forced keyframes, like any clip boundary); ``frame_parallel='exact'``
splits it over devices without changing a bit (parallel/seqpar.py).

The cascade (``tools/test.py --cascade``): each enhanced clip, whichever
mode made it, goes through a downstream VSR model (vanilla BasicVSR++ in
the plug-and-play story) and the metrics are taken on its output, against
the x4 GT. The MFQE joint protocol runs a PQF model and a non-PQF model
over each clip (models/baselines/mfqev2.py: ``mfqe_joint_enhance``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from pnp_vcve_torch.metrics import tensor2img
from pnp_vcve_torch.models.restorer import Restorer, average_clip_metrics
from .train_step import MODEL_INPUT_KEYS, _model_inputs, make_eval_step

__all__ = ["evaluate_dataset", "evaluate_dataset_mfqe_joint", "enhance_clip",
           "enhance_clip_frame_parallel", "is_mirror_extended"]


def _save_frames(frames_u8: np.ndarray, clip_name: str, save_path: str):
    from PIL import Image

    out_dir = Path(save_path) / clip_name
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames_u8):
        Image.fromarray(f).save(out_dir / f"{i:08d}.png")


def is_mirror_extended(lq: np.ndarray) -> bool:
    """Host-side mirror-extension check (reference check_if_mirror_extended,
    basicvsr_net.py:69-83): frame i equals frame t-1-i."""
    t = lq.shape[0]
    if t % 2:
        return False
    half = np.asarray(lq[: t // 2])
    return bool(np.array_equal(half, np.asarray(lq[::-1][: t // 2])))


def enhance_clip(eval_step, sample: dict, chunk_t: Optional[int] = None) -> np.ndarray:
    """Run the generator over one clip sample; returns ``(t, h, w, 3)`` float.
    With ``chunk_t`` the clip runs as independent windows, each window's
    first and last frames forced keyframes like any clip boundary."""
    t = sample["lq"].shape[0]
    spans = (
        [(0, t)] if not chunk_t or chunk_t >= t
        else [(s, min(s + chunk_t, t)) for s in range(0, t, chunk_t)]
    )
    mirror = len(spans) == 1 and is_mirror_extended(sample["lq"])
    outs = []
    for s, e in spans:
        batch = {k: np.asarray(sample[k][s:e])[None] for k in MODEL_INPUT_KEYS}
        outs.append(eval_step(batch, is_mirror_extended=mirror)[0])
    return np.concatenate(outs, axis=0)


def _cascade_clip(model: torch.nn.Module, clip: np.ndarray) -> np.ndarray:
    """A downstream model over one enhanced clip ``(t, h, w, 3)`` on the
    model's device: its frames alone, as JAX's ``casc_step(params,
    out[None])`` (no priors; no mirror-extension check). Returns the
    model's ``(t, H, W, 3)`` float32 numpy output."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.as_tensor(np.asarray(clip, np.float32)[None], device=device))
    return out[0].float().cpu().numpy()


def _local_devices(model: torch.nn.Module, distributed: bool) -> list:
    """The exact pipeline's default devices: every local card when the
    generator is on a card and this is the only process, else the
    generator's own device."""
    home = next(model.parameters()).device
    if home.type == "cuda" and not distributed:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [home]


def evaluate_dataset(
    restorer: Restorer,
    dataset: Iterable[dict],
    save_path: Optional[str] = None,
    save_image: bool = False,
    chunk_t: Optional[int] = None,
    verbose: bool = True,
    cascade=None,
    distributed: bool = False,
    frame_parallel: Optional[str] = None,
    stream_clips: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Dict[str, float]:
    """Enhance every clip of ``dataset`` with ``restorer.generator`` and
    return the dataset mean of the clip metrics.

    ``frame_parallel='exact'``: each clip runs through the exact chunked
    two-sweep pipeline over ``D = largest_divisor_chunks(t, len(devices))``
    of ``devices`` (default: every local card, or the generator's device),
    equal bit for bit to the full sweep (parallel/seqpar.py).
    ``stream_clips=B > 1`` streams up to B consecutive same-shape clips
    through it together (B + D - 1 pipeline steps instead of B * D); the
    outputs, and so the metrics, do not change.

    ``distributed=True``: this process evaluates its rank-strided share of
    the clips (``dataset.load_clip``) and the dataset mean is the exact
    count-weighted reduction over the process group (parallel/multihost.py).
    Images are written by the rank that made them.

    ``cascade``: a ``(model, restorer)`` pair; each enhanced clip, from any
    of the modes above, goes through ``model`` (:func:`_cascade_clip`) and
    the metrics are taken on its output (reference tools/test.py:121-134)."""
    if frame_parallel not in (None, "exact"):
        raise ValueError(f"frame_parallel must be None or 'exact', got {frame_parallel!r}")
    gen = restorer.generator
    eval_step = make_eval_step(gen)
    if frame_parallel == "exact":
        from pnp_vcve_torch.parallel.seqpar import (
            enhance_clips_exact_stream,
            largest_divisor_chunks,
        )

        devices = list(devices) if devices else _local_devices(gen, distributed)
    if distributed:
        import torch.distributed as dist

        from pnp_vcve_torch.parallel.multihost import allreduce_clip_metrics, shard_clips

        rank, world = ((dist.get_rank(), dist.get_world_size()) if dist.is_initialized()
                       else (0, 1))
        idxs = shard_clips(len(dataset), rank, world)  # type: ignore[arg-type]
        samples = (dataset.load_clip(i) for i in idxs)  # type: ignore[attr-defined]
    else:
        samples = dataset

    def exact(buf):
        """Yield (sample, out, seconds per clip) for a same-shape buffer."""
        t0 = time.perf_counter()
        d = largest_divisor_chunks(buf[0]["lq"].shape[0], len(devices))
        outs = enhance_clips_exact_stream(gen, buf, devices[:d])
        dt = (time.perf_counter() - t0) / len(buf)
        for sample, out in zip(buf, outs):
            yield sample, out, dt

    def enhanced():
        """Yield (sample, out, seconds per clip) in dataset order."""
        if frame_parallel == "exact":
            buf = []
            for sample in samples:
                if buf and (len(buf) >= stream_clips
                            or sample["lq"].shape != buf[0]["lq"].shape):
                    yield from exact(buf)
                    buf = []
                buf.append(sample)
            if buf:
                yield from exact(buf)
            return
        for sample in samples:
            t0 = time.perf_counter()
            out = enhance_clip(eval_step, sample, chunk_t=chunk_t)
            yield sample, out, time.perf_counter() - t0

    per_clip = []
    for sample, out, dt in enhanced():
        if cascade is not None:
            out = _cascade_clip(cascade[0], out)
        clip_name = sample.get("clip_name", f"clip{len(per_clip):03d}")
        metrics = restorer.evaluate_clip(out, sample["gt"])
        per_clip.append(metrics)
        if verbose:
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[eval] {clip_name}: {msg} ({out.shape[0]} frames, {dt:.2f}s)")
        if save_image and save_path:
            _save_frames(np.stack([tensor2img(f) for f in out]), clip_name, save_path)
    agg = allreduce_clip_metrics(per_clip) if distributed else average_clip_metrics(per_clip)
    if verbose and agg:
        print("[eval] dataset mean: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return agg


def evaluate_dataset_mfqe_joint(
    pqf_model: torch.nn.Module,
    nonpqf_model: torch.nn.Module,
    dataset: Iterable[dict],
    restorer: Restorer,
    save_path: Optional[str] = None,
    save_image: bool = False,
    verbose: bool = True,
) -> Dict[str, float]:
    """The MFQE two-model joint protocol over a clip dataset (reference
    restorers/mfqev2_restorer.py:14- and the MFQE 2.0 cascade): per clip,
    the PQFs enhanced first by ``pqf_model``, then each non-PQF by
    ``nonpqf_model`` against the enhanced PQFs; metrics, ``[mfqe-joint]``
    lines and PNGs as in :func:`evaluate_dataset`. Each model runs on its
    own device, its BatchNorm on running statistics."""
    from pnp_vcve_torch.models.baselines.mfqev2 import mfqe_joint_enhance

    def apply(model):
        device = next(model.parameters()).device

        def run(lrs):
            with torch.inference_mode():
                return model(torch.as_tensor(lrs, device=device)).float().cpu().numpy()
        return run

    pqf_apply, nonpqf_apply = apply(pqf_model), apply(nonpqf_model)
    per_clip = []
    for sample in dataset:
        t0 = time.perf_counter()
        frames = np.asarray(sample["lq"], np.float32)
        letters = [chr(int(round(float(c)))) for c in np.asarray(sample["slices"])]
        out = mfqe_joint_enhance(pqf_apply, nonpqf_apply, frames, letters)
        dt = time.perf_counter() - t0
        clip_name = sample.get("clip_name", f"clip{len(per_clip):03d}")
        metrics = restorer.evaluate_clip(out, sample["gt"])
        per_clip.append(metrics)
        if verbose:
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[mfqe-joint] {clip_name}: {msg} ({out.shape[0]} frames, {dt:.2f}s)")
        if save_image and save_path:
            _save_frames(np.stack([tensor2img(f) for f in out]), clip_name, save_path)
    agg = average_clip_metrics(per_clip)
    if verbose and agg:
        print("[mfqe-joint] dataset mean: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return agg


def enhance_clip_frame_parallel(model: torch.nn.Module, sample: dict,
                                devices: Sequence[torch.device], chunk_t: int,
                                halo_t: int = 2) -> np.ndarray:
    """Overlapped-window clip enhancement spread over ``devices`` (JAX
    :245-309): an approximation, unlike the exact pipeline.

    The clip splits into windows of ``chunk_t`` frames plus ``halo_t``
    context frames on each side (each window's first and last frames forced
    keyframes, like any clip boundary). The window list is padded to a
    multiple of the device count (repeating the last window), every window
    to the longest (repeating its last frame), and device ``i`` runs the
    full two-sweep generator on the i-th group of windows as one batch; the
    halo frames are dropped on stitching. ``halo_t=0`` is ``enhance_clip(
    chunk_t=...)`` where ``chunk_t`` divides t; the error decays with
    ``halo_t``. Returns ``(t, h, w, 3)`` float32 numpy."""
    from pnp_vcve_torch.parallel.seqpar import _replicas

    devices = [torch.device(d) for d in devices]
    t = sample["lq"].shape[0]
    windows, spans = [], []
    for s in range(0, t, chunk_t):
        e = min(s + chunk_t, t)
        ws, we = max(0, s - halo_t), min(t, e + halo_t)
        windows.append((ws, we))
        spans.append((s - ws, e - ws))
    wlen = max(we - ws for ws, we in windows)
    while len(windows) % len(devices):
        windows.append(windows[-1])
        spans.append((0, 0))  # contributes nothing

    def window(k, ws, we):
        a = np.asarray(sample[k][ws:we], np.float32)
        if a.shape[0] < wlen:  # repeat the edge frame
            a = np.pad(a, [(0, wlen - a.shape[0])] + [(0, 0)] * (a.ndim - 1), mode="edge")
        return a

    batch = _model_inputs({k: np.stack([window(k, ws, we) for ws, we in windows])
                           for k in MODEL_INPUT_KEYS})
    per = len(windows) // len(devices)
    reps = _replicas(model, devices)
    with torch.inference_mode():  # every device's group launched before any is read
        outs = [reps[dev](**{k: torch.as_tensor(v[i * per:(i + 1) * per], device=dev)
                             for k, v in batch.items()})
                for i, dev in enumerate(devices)]
        out = torch.cat([o.cpu() for o in outs]).numpy()
    return np.concatenate([out[i, s0:e0] for i, (s0, e0) in enumerate(spans) if e0 > s0])
