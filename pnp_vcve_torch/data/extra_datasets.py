"""The KITTI and Vimeo-90k codec datasets (counterpart of the parts of
pnp_vcve_tpu/data/extra_datasets.py that the flagship's configs name:
``KittiPairDataset`` :46, ``VimeoMixDataset`` :105, ``VimeoTestDataset``
:191).

- :class:`KittiPairDataset`: the KITTI optical-flow protocol, the fixed
  frame pair (10.png, 11.png) of each sequence, whole frames (reference
  augmentation.py:1549-1604, sr_kitti_multiple_gt_compress_dataset.py:6-150);
  the enhanced pairs feed a flow model downstream.
- :class:`VimeoMixDataset` and :class:`VimeoTestDataset`: Vimeo-90k
  septuplets, frames ``im1..im7.png`` under ``<clip>/<subclip>/``, MV
  sidecars at ``.../mv/<clip>/<subclip>/0000000{i-1}.npy`` and the 4-level
  QP/slice sidecar ``dict[crf][clip][subclip][frame]`` (reference
  loading_ipb.py:104-112, 138-142).

A missing MV sidecar is an empty record list (zero motion), as in JAX.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .datasets import _load_png, _mv_path
from .mv_raster import rasterize_clip
from .pipeline import Sample, flip, paired_random_crop_mv, random_transpose_hw, rescale_to_zero_one
from .qp_slice import QpSliceLookup

__all__ = ["KittiPairDataset", "VimeoMixDataset", "VimeoTestDataset"]


def _records(path: str) -> np.ndarray:
    return np.load(path) if os.path.exists(path) else np.zeros((0, 10), np.float32)


def _base_qp(folder: str) -> int:
    """``base_qp`` from the path ('.../crf15/...' -> 15; loading_ipb.py:238-239)."""
    m = re.search(r"crf(\d+)", folder)
    return int(m.group(1)) if m else 0


def _sample(lq_frames, gt_frames, qps, slice_types, records, base_qp) -> Sample:
    h, w = lq_frames[0].shape[:2]
    mvs, partitions = rasterize_clip(records, slice_types, h, w)
    return {
        "lq": np.stack(lq_frames).astype(np.float32),
        "gt": np.stack(gt_frames).astype(np.float32),
        "mvs": mvs,
        "partitions": partitions,
        "qps": np.asarray(qps, np.float32),
        "slices": np.asarray([ord(s) for s in slice_types], np.float32),
        "base_qps": np.full(len(lq_frames), float(base_qp), np.float32),
    }


@dataclass
class KittiPairDataset:
    """Fixed (10, 11) frame pairs of each KITTI sequence, whole frames."""

    lq_folder: str
    gt_folder: str
    qp_slice_file: Optional[str]
    frame_ids: Sequence[int] = (10, 11)
    filename_tmpl: str = "{:02d}.png"

    def __post_init__(self):
        self._lut = QpSliceLookup(self.qp_slice_file)
        self.clips = sorted(d.name for d in Path(self.lq_folder).iterdir() if d.is_dir())
        self.base_qp = _base_qp(self.lq_folder)

    def __len__(self):
        return len(self.clips)

    def load_clip(self, idx: int) -> Sample:
        clip = self.clips[idx]
        lq, gt, qps, slices, records = [], [], [], [], []
        for i in self.frame_ids:
            fname = self.filename_tmpl.format(i)
            lq_png = os.path.join(self.lq_folder, clip, fname)
            lq.append(_load_png(lq_png))
            gt.append(_load_png(os.path.join(self.gt_folder, clip, fname)))
            qp, st = self._lut(self.base_qp, clip, i)
            qps.append(qp)
            slices.append(st)
            records.append(_records(_mv_path(lq_png)))
        sample = _sample(lq, gt, qps, slices, records, self.base_qp)
        sample["clip_name"] = clip  # type: ignore[assignment]
        return rescale_to_zero_one(sample)

    def __iter__(self):
        for i in range(len(self)):
            yield self.load_clip(i)


def _load_septuplet(folder: str, gt_folder: str, key: str, n: int, lut: QpSliceLookup,
                    base_qp: int) -> Sample:
    """Frames ``im1..im{n}`` of ``<clip>/<subclip>`` from ``folder``, the GT
    beside them, the QP/slice of frame ``i - 1`` and the MV sidecars under
    ``folder`` with 'png' -> 'mv'."""
    clip, subclip = key.split("/")
    mv_dir = os.path.join(folder.replace("png", "mv"), clip, subclip)
    lq, gt, qps, slices, records = [], [], [], [], []
    for i in range(1, n + 1):
        lq.append(_load_png(os.path.join(folder, clip, subclip, f"im{i}.png")))
        gt.append(_load_png(os.path.join(gt_folder, clip, subclip, f"im{i}.png")))
        qp, st = lut(base_qp, clip, i - 1, subclip=subclip)
        qps.append(qp)
        slices.append(st)
        records.append(_records(os.path.join(mv_dir, f"{i - 1:08d}.npy")))
    return _sample(lq, gt, qps, slices, records, base_qp)


@dataclass
class VimeoMixDataset:
    """Vimeo-90k septuplet training source with the random CRF mixture."""

    lq_folder: str
    gt_folder: str
    cprs15_folder: str
    cprs25_folder: str
    cprs35_folder: str
    qp_slice_file: Optional[str]
    clips: List[str]  # '<clip>/<subclip>', e.g. '00001/0266'
    num_input_frames: int = 7
    scale: int = 1
    gt_patch_size: int = 128
    data_ratio: Sequence[float] = (0.2, 0.6, 0.85, 1.0)
    replace_qp_with_ipb: bool = False
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
        key = self.clips[int(rng.integers(0, len(self.clips)))]
        base_qp, folder = self._bucket(float(rng.random()))
        sample = _load_septuplet(folder, self.gt_folder, key, self.num_input_frames,
                                 self._lut, base_qp)
        rescale_to_zero_one(sample)
        paired_random_crop_mv(sample, self.gt_patch_size, self.scale, rng)
        flip(sample, "horizontal", rng)
        flip(sample, "vertical", rng)
        random_transpose_hw(sample, rng)
        return sample


@dataclass
class VimeoTestDataset:
    """Vimeo-90k whole-septuplet test source (reference
    ``SRVimeo90KMultipleGTCompressDataset``,
    sr_vimeo90k_multiple_gt_compress_dataset.py:10-89): one compressed
    folder, ``base_qp`` from its path, the keys of the annotation list."""

    cprs_folder: str
    gt_folder: str
    qp_slice_file: Optional[str]
    clips: List[str]  # '<clip>/<subclip>'
    num_input_frames: int = 7
    scale: int = 1
    replace_qp_with_ipb: bool = False

    def __post_init__(self):
        self._lut = QpSliceLookup(self.qp_slice_file, self.replace_qp_with_ipb)
        self.base_qp = _base_qp(self.cprs_folder)

    def __len__(self):
        return len(self.clips)

    def load_clip(self, idx: int) -> Sample:
        key = self.clips[idx]
        sample = _load_septuplet(self.cprs_folder, self.gt_folder, key, self.num_input_frames,
                                 self._lut, self.base_qp)
        sample["clip_name"] = key.replace("/", "_")  # type: ignore[assignment]
        return rescale_to_zero_one(sample)

    def __iter__(self):
        for i in range(len(self)):
            yield self.load_clip(i)
