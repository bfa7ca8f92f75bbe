"""Host-side sample transforms of the codec-prior pipeline (counterpart of
pnp_vcve_tpu/data/pipeline.py).

They act on a sample dict of numpy arrays with an explicit
``np.random.Generator`` (no global RNG), time-major NHWC: images
``(t, h, w, c)``, flows ``(t, h, w, 4)``, scalars ``(t,)``. The reference's
quirks are kept on purpose:

- ``RescaleToZeroOne`` applies to lq/gt/QPs/base_QPs and partitions (so the
  one-hot partition map feeds the network as {0, 1/255}), not to the MVs,
  which stay in pixels (reference HR_davis_LR_128x128.py:41);
- ``Flip`` mirrors the MV maps but does not negate the flipped component
  (reference augmentation.py:241-268);
- ``RandomTransposeHW`` always transposes, as the reference hardcodes
  ``transpose=True`` (augmentation.py:841-842), and does not swap the MV
  x/y channels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Sample = Dict[str, np.ndarray]

RESCALE_KEYS = ("lq", "gt", "base_qps", "qps", "partitions")
SPATIAL_KEYS = ("lq", "gt", "mvs", "partitions")

__all__ = [
    "rescale_to_zero_one",
    "paired_random_crop_mv",
    "flip",
    "random_transpose_hw",
    "generate_segment_indices",
]


def rescale_to_zero_one(sample: Sample, keys: Sequence[str] = RESCALE_KEYS) -> Sample:
    """x / 255 in float32 (reference normalization.py:68-103)."""
    for k in keys:
        if k in sample:
            sample[k] = sample[k].astype(np.float32) / 255.0
    return sample


def paired_random_crop_mv(sample: Sample, gt_patch_size: int, scale: int,
                          rng: np.random.Generator) -> Sample:
    """Random LQ crop and the aligned GT crop; mvs and partitions share the
    LQ window (reference crop.py:422-500)."""
    lq_patch = gt_patch_size // scale
    t, h_lq, w_lq = sample["lq"].shape[:3]
    h_gt, w_gt = sample["gt"].shape[1:3]
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(
            f"Scale mismatch: gt ({h_gt},{w_gt}) is not {scale}x lq ({h_lq},{w_lq})"
        )
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(f"lq ({h_lq},{w_lq}) smaller than patch {lq_patch}")
    top = int(rng.integers(0, h_lq - lq_patch + 1))
    left = int(rng.integers(0, w_lq - lq_patch + 1))
    for k in ("lq", "mvs", "partitions"):
        if k in sample:
            sample[k] = sample[k][:, top : top + lq_patch, left : left + lq_patch]
    tg, lg = top * scale, left * scale
    sample["gt"] = sample["gt"][:, tg : tg + gt_patch_size, lg : lg + gt_patch_size]
    return sample


def flip(sample: Sample, direction: str, rng: np.random.Generator, ratio: float = 0.5,
         keys: Sequence[str] = SPATIAL_KEYS) -> Sample:
    """Spatial mirror with probability ``ratio``; MV components not negated."""
    if rng.random() >= ratio:
        return sample
    axis = 2 if direction == "horizontal" else 1  # (t, h, w, c)
    for k in keys:
        if k in sample:
            sample[k] = np.flip(sample[k], axis=axis).copy()
    return sample


def random_transpose_hw(sample: Sample, rng: np.random.Generator, ratio: float = 0.5,
                        keys: Sequence[str] = SPATIAL_KEYS,
                        always_transpose: bool = True) -> Sample:
    """Transpose H and W; ``always_transpose`` keeps the reference's
    hardcoded ``transpose=True``."""
    if not always_transpose and rng.random() >= ratio:
        return sample
    for k in keys:
        if k in sample:
            sample[k] = sample[k].transpose(0, 2, 1, 3).copy()
    return sample


def generate_edvr_window_indices(sequence_length: int, num_input_frames: int,
                                 rng: np.random.Generator,
                                 interval_list: Sequence[int] = (1,),
                                 start_idx: int = 0) -> list[int]:
    """EDVR-style window around a random centre frame (reference
    GenerateFrameIndicesEDVR_mix, augmentation.py:960-1045): the centre is
    drawn again, uniformly, until the window fits inside the clip."""
    interval = int(rng.choice(list(interval_list)))
    half = num_input_frames // 2
    last = sequence_length - 1
    if 2 * half * interval > last:
        raise ValueError(
            f"sequence_length {sequence_length} too short for "
            f"{num_input_frames} frames at interval {interval}"
        )
    center = int(rng.integers(0, sequence_length))
    while center - half * interval < 0 or center + half * interval > last:
        center = int(rng.integers(0, last + 1))
    return [center + (i - half) * interval + start_idx for i in range(num_input_frames)]


def generate_segment_indices(sequence_length: int, num_input_frames: int,
                             rng: np.random.Generator, interval_list: Sequence[int] = (1,),
                             start_idx: int = 0) -> list[int]:
    """Random temporal window (reference augmentation.py:1472-1541)."""
    interval = int(rng.choice(list(interval_list)))
    span = sequence_length - num_input_frames * interval
    if span < 0:
        raise ValueError(
            f"sequence_length {sequence_length} too short for "
            f"{num_input_frames} frames at interval {interval}"
        )
    start = int(rng.integers(0, span + 1))
    return [start + i * interval + start_idx for i in range(num_input_frames)]
