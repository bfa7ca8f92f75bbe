"""Per-frame QP and slice type from the JSON sidecar (counterpart of
pnp_vcve_tpu/data/qp_slice.py).

Schema (reference loading_ipb.py:102-134):
``qp_slice_dict[crf][clip][frame] = {"QP": float, "slice": "I"|"P"|"B"}``
with ``frame`` the unpadded decimal index. Uncompressed inputs (CRF bucket
0) have no entry: QP 0, slice I for frame 0 and P after it. With
``replace_qp_with_ipb`` (the IPB config) the QP is the slice type's ordinal
(loading_ipb.py:120-123). Vimeo-90k's sidecar nests one level deeper,
``qp_slice_dict[crf][clip][subclip][frame]`` (loading_ipb.py:104-112): pass
``subclip``.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["QpSliceLookup"]


class QpSliceLookup:
    def __init__(self, json_path: str | Path | None, replace_qp_with_ipb: bool = False):
        self.replace_qp_with_ipb = replace_qp_with_ipb
        self._dict = None
        if json_path is not None:
            with open(json_path) as f:
                self._dict = json.load(f)

    def __call__(self, crf: int, clip: str, frame_idx: int, subclip: str | None = None):
        """``(qp, slice_type)`` of one frame; ``crf`` 0 for uncompressed,
        else the CRF bucket (15/25/35); ``subclip`` for the 4-level layout."""
        if crf == 0:
            slice_type = "I" if frame_idx == 0 else "P"
            qp = 0.0
        else:
            if self._dict is None:
                raise ValueError("qp_slice_file required for compressed inputs")
            entry = self._dict[f"crf{crf}"][clip]
            if subclip is not None:
                entry = entry[subclip]
            entry = entry[str(frame_idx)]
            slice_type = entry["slice"]
            qp = float(entry["QP"])
        if self.replace_qp_with_ipb:
            qp = float(ord(slice_type))
        return qp, slice_type
