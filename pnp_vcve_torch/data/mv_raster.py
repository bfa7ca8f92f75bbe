"""H.264 motion-vector sidecar rasterizer, numpy (counterpart of
pnp_vcve_tpu/data/mv_raster.py; the JAX package's optional C rasterizer in
pnp_vcve_tpu/native has the same semantics and is not carried over).

Per-frame MV records (the ``mv/*.npy`` sidecars) become dense ``(h, w, 4)``
flow maps (forward x, forward y, backward x, backward y) and ``(h, w, 3)``
one-hot macroblock-partition maps (16x16 / 16x8+8x16 / 8x8 by block area
256 / 128 / 64).

Record layout, one row per block:
``(direction, w, h, x_w, y_w, x, y, motion_x, motion_y, scale)`` with (x, y)
the block centre in the current frame, (x_w, y_w) the matched centre in the
reference frame and motion in 1/scale pixels (reference
loading_ipb.py:156-158). The reference loader's rules (loading_ipb.py:137-185):

- ``direction < 0``: forward MV into the current frame's channels 0:2;
- ``direction > 0`` on a B frame: backward MV into channels 2:4;
- ``direction > 0`` on a P frame: the MV, negated, into the backward
  channels of the frame ``p_offset`` steps back, at the matched location;
  ``p_offset`` is 1 + the length of the preceding run of B frames;
- later records overwrite earlier ones; every record writes the partition;
- rectangles are ``[y - h//2, y + h//2) x [x - w//2, x + w//2)`` with numpy
  slice semantics, as the reference slices its arrays directly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["rasterize_frame_mvs", "rasterize_clip"]

# block area -> partition channel (loading_ipb.py:152)
_PARTITION_CH = {256: 0, 128: 1, 64: 2}


def _rect(x: int, y: int, w: int, h: int):
    return slice(y - h // 2, y + h // 2), slice(x - w // 2, x + w // 2)


def rasterize_frame_mvs(records: np.ndarray, height: int, width: int, is_b_frame: bool,
                        prev_mvs: list[np.ndarray], p_offset: int):
    """One frame's records -> ``(mv (h,w,4), partition (h,w,3))`` float32;
    P-frame records write into ``prev_mvs`` (earlier frames of the clip)."""
    mv = np.zeros((height, width, 4), np.float32)
    partition = np.zeros((height, width, 3), np.float32)
    for rec in np.asarray(records, np.float32).reshape(-1, 10):
        direction, w, h, x_w, y_w, x, y, motion_x, motion_y, scale = rec
        x, y, w, h, x_w, y_w = int(x), int(y), int(w), int(h), int(x_w), int(y_w)
        motion_x = float(motion_x) / float(scale)
        motion_y = float(motion_y) / float(scale)
        ys, xs = _rect(x, y, w, h)
        if direction < 0:
            mv[ys, xs, 0] = motion_x
            mv[ys, xs, 1] = motion_y
        elif direction > 0 and is_b_frame:
            mv[ys, xs, 2] = motion_x
            mv[ys, xs, 3] = motion_y
        elif direction > 0:
            target = prev_mvs[-p_offset]
            ys_w, xs_w = _rect(x_w, y_w, w, h)
            target[ys_w, xs_w, 2] = -motion_x
            target[ys_w, xs_w, 3] = -motion_y
        else:
            raise ValueError("MV record with direction == 0")
        partition[ys, xs, _PARTITION_CH[w * h]] = 1.0
    return mv, partition


def rasterize_clip(records_per_frame: Sequence[np.ndarray], slice_types: Sequence[str],
                   height: int, width: int):
    """A whole clip -> ``(mvs (t,h,w,4), partitions (t,h,w,3))`` float32.
    ``p_offset`` grows by one after a B frame and resets to 1 after any
    other (loading_ipb.py:185)."""
    mvs: list[np.ndarray] = []
    partitions: list[np.ndarray] = []
    p_offset = 0
    for records, st in zip(records_per_frame, slice_types):
        is_b = st == "B"
        mv, par = rasterize_frame_mvs(records, height, width, is_b, mvs, p_offset)
        mvs.append(mv)
        partitions.append(par)
        p_offset = p_offset + 1 if is_b else 1
    return np.stack(mvs, axis=0), np.stack(partitions, axis=0)
