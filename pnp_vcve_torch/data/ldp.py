"""LDP datasets: the (left PQF, centre, right PQF) triples of the MFQE
protocol (counterpart of pnp_vcve_tpu/data/ldp.py; reference
ldp_dataset.py:10-661).

Peak-quality frames (PQFs) are the I and P slices. A sample is the triple
of the nearest PQF strictly left of a centre frame, the centre and the
nearest PQF strictly right, with the centre's ground truth; the PQF
dataset centres on PQFs (the PQF enhancer's data), the non-PQF dataset on
B frames. Uncompressed input takes the adjacent frames (ldp_dataset.py:
61-67). Samples: ``lq (3, h, w, 3)``, ``gt (1, h, w, 3)``, ``qps`` and
``base_qps (3,)``, in [0, 1]. The random draws are JAX's, in its order, so
one seed gives the same samples.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .datasets import ClipIndex, _base_qp, _load_png
from .pipeline import Sample, flip, rescale_to_zero_one
from .qp_slice import QpSliceLookup

__all__ = ["PQF_SLICES", "find_left_right_pqf", "LDPTripleDataset"]

PQF_SLICES = ("I", "P")


def find_left_right_pqf(slice_of, idx: int, n_frames: int, compressed: bool = True):
    """The nearest PQF strictly left and right of ``idx``, each falling back
    to ``idx`` itself; ``slice_of(i) -> 'I' | 'P' | 'B'``. Uncompressed
    input takes the adjacent frames."""
    if not compressed:
        left = idx - 1 if idx > 0 else idx
        right = idx + 1 if idx < n_frames - 1 else idx
        return left, right
    left = idx - 1
    while left >= 0 and slice_of(left) not in PQF_SLICES:
        left -= 1
    if left < 0:
        left = idx
    right = idx + 1
    while right <= n_frames - 1 and slice_of(right) not in PQF_SLICES:
        right += 1
    if right > n_frames - 1:
        right = idx
    return left, right


@dataclass
class LDPTripleDataset:
    """Random triples at a random CRF bucket (:meth:`sample`) and every
    centre of every clip at one CRF (:meth:`iter_test`)."""

    lq_folder: str
    gt_folder: str
    cprs15_folder: str
    cprs25_folder: str
    cprs35_folder: str
    qp_slice_file: Optional[str]
    clips: List[ClipIndex]
    centers: str = "pqf"  # 'pqf' | 'nonpqf'
    scale: int = 1
    gt_patch_size: int = 128
    filename_tmpl: str = "{:08d}.png"
    data_ratio: Sequence[float] = (0.2, 0.6, 0.85, 1.0)
    _lut: QpSliceLookup = field(init=False, repr=False)

    def __post_init__(self):
        self._lut = QpSliceLookup(self.qp_slice_file)

    def _bucket(self, u: float):
        r = self.data_ratio
        if u < r[0]:
            return 0, self.lq_folder
        if u < r[1]:
            return 15, self.cprs15_folder
        if u < r[2]:
            return 25, self.cprs25_folder
        return 35, self.cprs35_folder

    def _center_candidates(self, crf: int, clip: ClipIndex) -> list[int]:
        want_pqf = self.centers == "pqf"
        return [i for i in range(clip.sequence_length)
                if (self._lut(crf, clip.name, i)[1] in PQF_SLICES) == want_pqf]

    def _png(self, folder: str, clip: str, i: int) -> np.ndarray:
        return _load_png(os.path.join(folder, clip, self.filename_tmpl.format(i)))

    def sample(self, rng: np.random.Generator) -> Sample:
        clip = self.clips[int(rng.integers(0, len(self.clips)))]
        base_qp, folder = self._bucket(float(rng.random()))
        candidates = self._center_candidates(base_qp, clip) or list(range(clip.sequence_length))
        center = int(candidates[int(rng.integers(0, len(candidates)))])
        left, right = find_left_right_pqf(lambda i: self._lut(base_qp, clip.name, i)[1], center,
                                          clip.sequence_length, compressed=base_qp != 0)
        idxs = (left, center, right)
        sample: Sample = {
            "lq": np.stack([self._png(folder, clip.name, i) for i in idxs]).astype(np.float32),
            "gt": self._png(self.gt_folder, clip.name, center)[None].astype(np.float32),
            "qps": np.asarray([self._lut(base_qp, clip.name, i)[0] for i in idxs], np.float32),
            "base_qps": np.full(3, float(base_qp), np.float32),
        }
        rescale_to_zero_one(sample)
        # the triple and the centre's GT cropped with one window
        h, w = sample["lq"].shape[1:3]
        p = self.gt_patch_size // self.scale
        top = int(rng.integers(0, h - p + 1))
        lft = int(rng.integers(0, w - p + 1))
        sample["lq"] = sample["lq"][:, top:top + p, lft:lft + p]
        tg, lg, g = top * self.scale, lft * self.scale, self.gt_patch_size
        sample["gt"] = sample["gt"][:, tg:tg + g, lg:lg + g]
        flip(sample, "horizontal", rng, keys=("lq", "gt"))
        flip(sample, "vertical", rng, keys=("lq", "gt"))
        return sample

    def iter_test(self, crf: Optional[int] = None):
        """Every centre (PQF or non-PQF per ``centers``) of every clip at full
        size; ``crf`` defaults to the ``crf<N>`` in ``lq_folder`` (else 0)."""
        if crf is None:
            crf = _base_qp(self.lq_folder)
        folder = {0: self.lq_folder, 15: self.cprs15_folder, 25: self.cprs25_folder,
                  35: self.cprs35_folder}[crf]
        for clip in self.clips:
            for center in self._center_candidates(crf, clip):
                left, right = find_left_right_pqf(lambda i: self._lut(crf, clip.name, i)[1],
                                                  center, clip.sequence_length,
                                                  compressed=crf != 0)
                s: Sample = {
                    "lq": np.stack([self._png(folder, clip.name, i)
                                    for i in (left, center, right)]).astype(np.float32),
                    "gt": self._png(self.gt_folder, clip.name, center)[None].astype(np.float32),
                    "qps": np.zeros(3, np.float32),
                    "base_qps": np.full(3, float(crf), np.float32),
                    "clip_name": f"{clip.name}/{center:08d}",  # type: ignore
                }
                rescale_to_zero_one(s)
                yield s
