"""Evaluation harness: full-clip enhancement and the sequence metrics
(counterpart of pnp_vcve_tpu/train/eval.py: ``enhance_clip`` :57-74,
``evaluate_dataset`` :77-190), on one device.

Per clip: run the generator over the whole sequence (or over independent
``chunk_t``-frame windows), compute per-frame PSNR/SSIM on uint8-quantised
frames, average per clip and then over the dataset, and optionally write
``<save_path>/<clip>/<i:08d>.png``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

from pnp_vcve_torch.metrics import tensor2img
from pnp_vcve_torch.models.restorer import Restorer, average_clip_metrics
from .train_step import MODEL_INPUT_KEYS, make_eval_step

__all__ = ["evaluate_dataset", "enhance_clip", "is_mirror_extended"]


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
) -> Dict[str, float]:
    """Enhance every clip of ``dataset`` with ``restorer.generator`` and
    return the dataset mean of the clip metrics. The cascade, multi-process
    and frame-parallel modes of the JAX harness are not ported yet."""
    if cascade is not None:
        raise NotImplementedError("cascade eval is not ported yet (ROADMAP Queue A item 3)")
    if distributed or frame_parallel:
        raise NotImplementedError(
            "distributed / frame-parallel eval is not ported yet (ROADMAP Queue A item 6)"
        )
    eval_step = make_eval_step(restorer.generator)
    per_clip = []
    for sample in dataset:
        t0 = time.perf_counter()
        out = enhance_clip(eval_step, sample, chunk_t=chunk_t)
        dt = time.perf_counter() - t0
        clip_name = sample.get("clip_name", f"clip{len(per_clip):03d}")
        metrics = restorer.evaluate_clip(out, sample["gt"])
        per_clip.append(metrics)
        if verbose:
            msg = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[eval] {clip_name}: {msg} ({out.shape[0]} frames, {dt:.2f}s)")
        if save_image and save_path:
            _save_frames(np.stack([tensor2img(f) for f in out]), clip_name, save_path)
    agg = average_clip_metrics(per_clip)
    if verbose and agg:
        print("[eval] dataset mean: " + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return agg
