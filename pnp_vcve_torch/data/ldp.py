"""Peak-quality frames of the MFQE protocol (the helpers of
pnp_vcve_tpu/data/ldp.py:28-60; reference ldp_dataset.py:60-92).

PQFs are the I and P slices. ``LDPTripleDataset``, the MFQEv2 configs'
training data, is not ported yet (ROADMAP Queue A item 8).
"""

from __future__ import annotations

__all__ = ["PQF_SLICES", "find_left_right_pqf"]

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
