"""Config-driven pipelines: the PIPELINES registry (counterpart of
pnp_vcve_tpu/data/compose.py; reference mmedit/datasets/pipelines/
compose.py:10-54 via mmcv ``build_from_cfg``).

Every stage of a config's ``pipeline=[...]`` is built by its reference name;
an unknown ``type`` raises ``KeyError`` naming the known stages. Stages run
in three phases of the host-side data flow:

- ``index`` stages make or reorder the frame plan before any IO
  (GenerateSegmentIndices*, GenerateFrameIndicesEDVR_mix, TemporalReverse);
- ``load`` stages carry the knobs of what the dataset reads (CRF buckets,
  QP/slice sidecar, MV and partition rasters); the dataset does the IO;
- ``sample`` stages transform the loaded sample in config order
  (RescaleToZeroOne, PairedRandomCrop_mv, Flip, RandomTransposeHW,
  FramesToTensor, Collect).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pnp_vcve_torch.core.registry import Registry
from .pipeline import (
    RESCALE_KEYS,
    SPATIAL_KEYS,
    Sample,
    flip,
    generate_edvr_window_indices,
    generate_segment_indices,
    paired_random_crop_mv,
    random_transpose_hw,
    rescale_to_zero_one,
)

__all__ = ["PIPELINES", "Compose"]

PIPELINES = Registry("pipelines")

# reference configs use mmedit's key spelling; the sample dict is lowercase
_KEYMAP = {"QPs": "qps", "base_QPs": "base_qps"}


def _map_keys(keys) -> tuple:
    if isinstance(keys, str):
        keys = [keys]
    return tuple(_KEYMAP.get(k, k) for k in keys)


# ---- index phase -------------------------------------------------------------


@PIPELINES.register(name="GenerateSegmentIndices_Mix_Compress",
                    aliases=("GenerateSegmentIndices",))
class GenerateSegmentIndicesStage:
    """Random temporal window (reference augmentation.py:1450-1541)."""

    phase = "index"

    def __init__(self, interval_list=(1,), start_idx=0, filename_tmpl="{:08d}.png"):
        self.interval_list = tuple(interval_list)
        self.start_idx = start_idx
        self.filename_tmpl = filename_tmpl

    def __call__(self, plan: dict, rng: np.random.Generator) -> dict:
        idxs = generate_segment_indices(plan["sequence_length"], plan["num_input_frames"],
                                        rng, self.interval_list, self.start_idx)
        plan["lq_idxs"] = list(idxs)
        plan["gt_idxs"] = list(idxs)
        return plan


@PIPELINES.register(name="GenerateFrameIndicesEDVR_mix")
class GenerateEDVRWindowStage(GenerateSegmentIndicesStage):
    """Centre-frame window with the border redraw (reference
    augmentation.py:960-1045); the Big mixture's index stage."""

    def __call__(self, plan: dict, rng: np.random.Generator) -> dict:
        idxs = generate_edvr_window_indices(plan["sequence_length"], plan["num_input_frames"],
                                            rng, self.interval_list, self.start_idx)
        plan["lq_idxs"] = list(idxs)
        plan["gt_idxs"] = list(idxs)
        return plan


@PIPELINES.register(name="GenerateSegmentIndices_LR")
class GenerateTestIndicesStage:
    """Test-time whole-clip indices in order."""

    phase = "index"

    def __init__(self, interval_list=(1,), start_idx=0, filename_tmpl="{:08d}.png"):
        self.interval_list = tuple(interval_list)
        self.start_idx = start_idx
        self.filename_tmpl = filename_tmpl

    def __call__(self, plan: dict, rng) -> dict:
        n = min(plan["num_input_frames"], plan["sequence_length"])
        idxs = [self.start_idx + i for i in range(n)]
        plan["lq_idxs"] = list(idxs)
        plan["gt_idxs"] = list(idxs)
        return plan


@PIPELINES.register(name="TemporalReverse")
class TemporalReverseStage:
    """Reverse the frame lists with probability ``reverse_ratio``
    (reference augmentation.py:1408-1448), on the plan before loading. A
    bare-string ``keys`` (as the flagship configs pass) is one key."""

    phase = "index"

    def __init__(self, keys=("lq_path", "gt_path"), reverse_ratio=0.5):
        self.keys = (keys,) if isinstance(keys, str) else tuple(keys)
        self.reverse_ratio = reverse_ratio

    def __call__(self, plan: dict, rng: np.random.Generator) -> dict:
        # the draw is taken whatever its outcome, as in the reference
        reverse = bool(rng.random() < self.reverse_ratio)
        if reverse:
            if "lq_path" in self.keys:
                plan["lq_idxs"] = list(reversed(plan["lq_idxs"]))
            if "gt_path" in self.keys:
                plan["gt_idxs"] = list(reversed(plan["gt_idxs"]))
        plan["reverse"] = reverse
        return plan


# ---- load phase (the dataset does the IO) -----------------------------------------


@PIPELINES.register(
    name="LoadImageFromFileList_Mix_Compress_ipb",
    aliases=("LoadImageFromFileList_ipb", "LoadImageFromFileList",
             "LoadImageFromFileList_Mix_Compress_ipb_mixdataset"),
)
class LoadImageListStage:
    """Frame-list loader knobs (reference loading.py:723, loading_ipb.py:16-23):
    the CRF mixture, the QP/slice sidecar, which codec priors to load."""

    phase = "load"

    def __init__(self, io_backend="disk", key="gt", flag="color", channel_order="rgb",
                 convert_to=None, save_original_img=False, use_cache=False, backend=None,
                 random_compress=False, compress_ratio=0.5, load_qp_slice=False,
                 load_base_qp=False, load_mv=False, qp_slice_file=None, dataset="reds",
                 use_bi_infor=False, load_partition=False, replace_qp_withIPB=False,
                 drconv=False, data_ratio=(0.2, 0.6, 0.85, 1.0)):
        self.key = key
        self.qp_slice_file = qp_slice_file
        self.replace_qp_with_ipb = replace_qp_withIPB
        self.data_ratio = tuple(data_ratio)

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        return sample


# ---- sample phase ------------------------------------------------------------------


@PIPELINES.register(name="RescaleToZeroOne")
class RescaleToZeroOneStage:
    phase = "sample"

    def __init__(self, keys=RESCALE_KEYS):
        self.keys = _map_keys(keys)

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        return rescale_to_zero_one(sample, self.keys)


@PIPELINES.register(name="PairedRandomCrop_mv")
class PairedRandomCropMVStage:
    phase = "sample"

    def __init__(self, gt_patch_size=128):
        self.gt_patch_size = gt_patch_size

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        return paired_random_crop_mv(sample, self.gt_patch_size, (ctx or {}).get("scale", 1), rng)


@PIPELINES.register(name="Flip")
class FlipStage:
    phase = "sample"

    def __init__(self, keys=SPATIAL_KEYS, flip_ratio=0.5, direction="horizontal"):
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"Unknown flip direction {direction!r}")
        self.keys = _map_keys(keys)
        self.flip_ratio = flip_ratio
        self.direction = direction

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        return flip(sample, self.direction, rng, self.flip_ratio, self.keys)


@PIPELINES.register(name="RandomTransposeHW")
class RandomTransposeHWStage:
    """H/W transpose, unconditional unless ``always_transpose=False`` (the
    reference hardcodes ``transpose=True``, augmentation.py:841-842)."""

    phase = "sample"

    def __init__(self, keys=SPATIAL_KEYS, transpose_ratio=0.5, always_transpose=True):
        self.keys = _map_keys(keys)
        self.transpose_ratio = transpose_ratio
        self.always_transpose = always_transpose

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        return random_transpose_hw(sample, rng, self.transpose_ratio, self.keys,
                                   self.always_transpose)


@PIPELINES.register(name="FramesToTensor", aliases=("ImageToTensor", "ToTensor"))
class FramesToTensorStage:
    """Checks the keys exist; the loader makes the tensors, NHWC."""

    phase = "sample"

    def __init__(self, keys=()):
        self.keys = _map_keys(keys)

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        missing = [k for k in self.keys if k not in sample]
        if missing:
            raise KeyError(f"FramesToTensor: keys {missing} not in sample")
        return sample


@PIPELINES.register(name="Collect")
class CollectStage:
    """Keep only the named keys and the clip metadata (reference
    formating.py Collect)."""

    phase = "sample"

    _META = ("clip_name", "reverse")

    def __init__(self, keys, meta_keys=()):
        self.keys = _map_keys(keys)

    def __call__(self, sample: Sample, rng, ctx=None) -> Sample:
        keep = set(self.keys) | set(self._META)
        return {k: v for k, v in sample.items() if k in keep}


# ---- Compose -----------------------------------------------------------------------


class Compose:
    """A pipeline list built through :data:`PIPELINES`, run phase by phase."""

    def __init__(self, pipeline: Sequence):
        self.stages = []
        for cfg in pipeline or []:
            if not isinstance(cfg, dict):
                raise TypeError(f"pipeline stage must be a dict, got {type(cfg)}")
            self.stages.append(PIPELINES.build(dict(cfg)))

    def _phase(self, which: str):
        return [s for s in self.stages if s.phase == which]

    def apply_index(self, sequence_length: int, num_input_frames: int,
                    rng: np.random.Generator) -> dict:
        """The index stages in config order -> the frame plan
        (lq_idxs / gt_idxs / reverse)."""
        plan = {"sequence_length": sequence_length, "num_input_frames": num_input_frames}
        for s in self._phase("index"):
            plan = s(plan, rng)
        if "lq_idxs" not in plan:
            raise ValueError("pipeline has no index-generation stage (GenerateSegmentIndices*)")
        return plan

    def apply_sample(self, sample: Sample, rng: np.random.Generator, scale: int = 1) -> Sample:
        """The sample stages in config order on the loaded sample."""
        ctx = {"scale": scale}
        for s in self._phase("sample"):
            sample = s(sample, rng, ctx)
        return sample

    def loader_params(self) -> dict:
        """The dataset's knobs from the stages."""
        out = dict(data_ratio=(0.2, 0.6, 0.85, 1.0), replace_qp_with_ipb=False,
                   qp_slice_file=None, gt_patch_size=128, filename_tmpl="{:08d}.png",
                   interval_list=(1,))
        for s in self.stages:
            if isinstance(s, (GenerateSegmentIndicesStage, GenerateTestIndicesStage)):
                out["filename_tmpl"] = s.filename_tmpl
                out["interval_list"] = s.interval_list
            elif isinstance(s, LoadImageListStage) and (
                s.key == "lq" or s.qp_slice_file is not None
            ):
                # the lq loader carries the codec-prior knobs; a sidecar is
                # honoured wherever a config attaches it
                out["qp_slice_file"] = s.qp_slice_file or out["qp_slice_file"]
                out["data_ratio"] = s.data_ratio
                out["replace_qp_with_ipb"] = s.replace_qp_with_ipb
            elif isinstance(s, PairedRandomCropMVStage):
                out["gt_patch_size"] = s.gt_patch_size
        return out
