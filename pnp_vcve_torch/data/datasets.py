"""Codec-prior clip sources for REDS / DAVIS folder layouts (counterpart of
pnp_vcve_tpu/data/datasets.py).

Layout (reference README.md:40-54):

    <root>/crf{15,25,35}/png/<clip>/<frame>.png   compressed frames
    <root>/crf{15,25,35}/mv/<clip>/<frame>.npy    MV record sidecars
    <root>/sharp/png/<clip>/<frame>.png           ground truth
    <root>/<name>.json                            per-frame QP/slice sidecar

Training (reference HR_davis_LR_128x128.py:50-106, loading_ipb.py:24-215):
random clip -> random window -> random CRF bucket by the ``data_ratio`` CDF
-> PNG decode, MV/partition rasters, QP/slice lookup -> the config's
sample stages. Test (loading_ipb.py:221-397): a fixed folder, ``base_qp``
from the path ('crf15' -> 15), the whole clip.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from .mv_raster import rasterize_clip
from .pipeline import (
    Sample,
    flip,
    generate_segment_indices,
    paired_random_crop_mv,
    random_transpose_hw,
    rescale_to_zero_one,
)
from .qp_slice import QpSliceLookup

__all__ = [
    "REDS4_CLIPS",
    "ClipIndex",
    "MixCompressTrainDataset",
    "CompressTestDataset",
    "reds_train_clips",
]

REDS4_CLIPS = ("000", "011", "015", "020")


def reds_train_clips(val_partition: Sequence[str] = REDS4_CLIPS) -> List[str]:
    """The 270 REDS clips minus the validation partition."""
    return [f"{i:03d}" for i in range(270) if f"{i:03d}" not in set(val_partition)]


def _load_png(path: str | Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _mv_path(png_path: str) -> str:
    """PNG path -> MV sidecar path (reference loading_ipb.py:144)."""
    return png_path.replace(".png", ".npy").replace("png", "mv")


@dataclass
class ClipIndex:
    name: str
    sequence_length: int


def _load_frames(lq_dir: str, gt_dir: str, clip: str, lq_idxs, gt_idxs, tmpl: str,
                 lut: QpSliceLookup, base_qp: int) -> Sample:
    lq_frames, gt_frames, qps, slice_types, records = [], [], [], [], []
    for i, j in zip(lq_idxs, gt_idxs):
        lq_png = os.path.join(lq_dir, clip, tmpl.format(i))
        lq_frames.append(_load_png(lq_png))
        gt_frames.append(_load_png(os.path.join(gt_dir, clip, tmpl.format(j))))
        qp, st = lut(base_qp, clip, i)
        qps.append(qp)
        slice_types.append(st)
        records.append(np.load(_mv_path(lq_png)))
    h, w = lq_frames[0].shape[:2]
    mvs, partitions = rasterize_clip(records, slice_types, h, w)
    return {
        "lq": np.stack(lq_frames).astype(np.float32),
        "gt": np.stack(gt_frames).astype(np.float32),
        "mvs": mvs,
        "partitions": partitions,
        "qps": np.asarray(qps, np.float32),
        "slices": np.asarray([ord(s) for s in slice_types], np.float32),
        "base_qps": np.full(len(lq_idxs), float(base_qp), np.float32),
    }


@dataclass
class MixCompressTrainDataset:
    """Random-CRF-mixture training source for one dataset root."""

    lq_folder: str
    gt_folder: str
    cprs15_folder: str
    cprs25_folder: str
    cprs35_folder: str
    qp_slice_file: Optional[str]
    clips: List[ClipIndex]
    num_input_frames: int = 15
    scale: int = 1
    gt_patch_size: int = 128
    filename_tmpl: str = "{:08d}.png"
    data_ratio: Sequence[float] = (0.2, 0.6, 0.85, 1.0)
    interval_list: Sequence[int] = (1,)
    replace_qp_with_ipb: bool = False
    # the config's pipeline (data.compose.Compose): index and sample stages
    # in config order; None runs rescale -> crop -> flips -> transpose
    transforms: Optional[object] = None
    _lut: QpSliceLookup = field(init=False, repr=False)

    def __post_init__(self):
        self._lut = QpSliceLookup(self.qp_slice_file, self.replace_qp_with_ipb)

    def _bucket(self, u: float):
        """CRF bucket by CDF (loading_ipb.py:27-40)."""
        r = self.data_ratio
        if u < r[0]:
            return 0, self.lq_folder
        if u < r[1]:
            return 15, self.cprs15_folder
        if u < r[2]:
            return 25, self.cprs25_folder
        return 35, self.cprs35_folder

    def sample(self, rng: np.random.Generator) -> Sample:
        clip = self.clips[int(rng.integers(0, len(self.clips)))]
        if self.transforms is not None:
            plan = self.transforms.apply_index(clip.sequence_length, self.num_input_frames, rng)
            lq_idxs, gt_idxs = plan["lq_idxs"], plan["gt_idxs"]
        else:
            lq_idxs = gt_idxs = generate_segment_indices(
                clip.sequence_length, self.num_input_frames, rng, self.interval_list
            )
        base_qp, folder = self._bucket(float(rng.random()))
        sample = _load_frames(folder, self.gt_folder, clip.name, lq_idxs, gt_idxs,
                              self.filename_tmpl, self._lut, base_qp)
        if self.transforms is not None:
            return self.transforms.apply_sample(sample, rng, scale=self.scale)
        rescale_to_zero_one(sample)
        paired_random_crop_mv(sample, self.gt_patch_size, self.scale, rng)
        flip(sample, "horizontal", rng)
        flip(sample, "vertical", rng)
        random_transpose_hw(sample, rng)
        return sample


@dataclass
class CompressTestDataset:
    """Fixed-folder test source yielding whole clips in order."""

    lq_folder: str
    gt_folder: str
    qp_slice_file: Optional[str]
    clips: List[ClipIndex]
    num_input_frames: int = 100
    scale: int = 1
    filename_tmpl: str = "{:08d}.png"
    replace_qp_with_ipb: bool = False
    # the config's pipeline; None rescales only
    transforms: Optional[object] = None
    _lut: QpSliceLookup = field(init=False, repr=False)

    def __post_init__(self):
        self._lut = QpSliceLookup(self.qp_slice_file, self.replace_qp_with_ipb)
        m = re.search(r"crf(\d+)", self.lq_folder)
        # base_qp from the path (loading_ipb.py:238-239)
        self.base_qp = int(m.group(1)) if m else 0

    def __len__(self):
        return len(self.clips)

    def load_clip(self, clip_idx: int) -> Sample:
        clip = self.clips[clip_idx]
        idxs = range(min(self.num_input_frames, clip.sequence_length))
        sample = _load_frames(self.lq_folder, self.gt_folder, clip.name, idxs, idxs,
                              self.filename_tmpl, self._lut, self.base_qp)
        sample["clip_name"] = clip.name  # type: ignore[assignment]
        if self.transforms is not None:
            return self.transforms.apply_sample(sample, rng=None, scale=self.scale)
        return rescale_to_zero_one(sample)

    def __iter__(self):
        for i in range(len(self.clips)):
            yield self.load_clip(i)
