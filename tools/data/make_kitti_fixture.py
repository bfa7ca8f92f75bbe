#!/usr/bin/env python
"""Synthesize a KITTI-layout fixture for the KITTI pair protocol
(tools/test_kitti.py, tools/torch_test_kitti.py).

    <root>/crf<N>/png/<seq>/{10,11}.png   decoded (degraded) frames
    <root>/crf<N>/mv/<seq>/{10,11}.npy    bitstream MV sidecars
    <root>/clean/<seq>/{10,11}.png        ground truth
    <root>/qp.json                        per-frame QP / slice type

Each sequence is make_protocol_fixture.py's periodic texture under a
global integer translation; frame 10 is an I frame (no MV records), frame
11 a P frame whose 16x16-block MVs are the true motion.

    python tools/data/make_kitti_fixture.py ROOT [--seqs 000000,000001]
        [--height 375 --width 1242] [--crf 15] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from make_protocol_fixture import block_mv_records, degrade, synth_texture  # noqa: E402

FRAMES = (10, 11)


def write_kitti_fixture(root: str | Path, seqs=("000000", "000001"), height: int = 375,
                        width: int = 1242, crf: int = 15, seed: int = 0) -> Path:
    from PIL import Image

    root = Path(root)
    motions = [(2, 1), (-1, 2), (3, -1)]
    sidecar = {f"crf{crf}": {}}
    for si, seq in enumerate(seqs):
        rng = np.random.default_rng(seed + 1000 * si)
        tex = synth_texture(rng, height, width)
        dx, dy = motions[si % len(motions)]
        png, mv, gt = (root / f"crf{crf}" / "png" / seq, root / f"crf{crf}" / "mv" / seq,
                       root / "clean" / seq)
        for d in (png, mv, gt):
            d.mkdir(parents=True, exist_ok=True)
        entries = {}
        for k, i in enumerate(FRAMES):
            frame = np.roll(tex, (k * dy, k * dx), axis=(0, 1))
            Image.fromarray(np.clip(np.round(frame * 255.0), 0, 255).astype(np.uint8)).save(
                gt / f"{i:02d}.png")
            lq = degrade(frame, rng)
            Image.fromarray(np.clip(np.round(lq * 255.0), 0, 255).astype(np.uint8)).save(
                png / f"{i:02d}.png")
            st = "I" if k == 0 else "P"
            recs = (np.zeros((0, 10), np.float32) if st == "I"
                    else block_mv_records(height, width, dx, dy))
            np.save(mv / f"{i:02d}.npy", recs)
            entries[str(i)] = {"QP": float(20 + crf // 3 + k), "slice": st}
        sidecar[f"crf{crf}"][seq] = entries
    (root / "qp.json").write_text(json.dumps(sidecar))
    return root


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", help="output root directory")
    p.add_argument("--seqs", default="000000,000001")
    p.add_argument("--height", type=int, default=375)
    p.add_argument("--width", type=int, default=1242)
    p.add_argument("--crf", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    write_kitti_fixture(args.root, tuple(args.seqs.split(",")), args.height, args.width,
                        args.crf, args.seed)


if __name__ == "__main__":
    main()
