#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (data-parallel training against one process)
run several ways, each in a process of its own, to show what its first
logged loss depends on:

- ``alone``: ``phase_device``, ``phase_build``, ``phase_ddp_train``;
- ``after7``: the same after phase 7 (training), in one process, with
  cuBLAS's workspace set as ``chip_smoke.main`` sets it;
- ``stale``: alone over a training fixture left at another size (the
  128x128 frames a CPU rehearsal of phase 7 writes), which phase 17
  rewrites because its stamp differs;
- ``stale_reused``: the same stale fixture carrying a stamp of the right
  parameters, so that phase 17 trains on it as it is: what phase 17 did
  with any fixture it found before the fixture carried a stamp.

    python3 tools/torch_phase17_repro.py [--kinds alone,after7,stale,stale_reused]
        [--device cuda]

Needs one card. Prints, per kind, phase 17's flags at entry, the fixture's
digest and the first logged losses of the one-process run and of the
ranks, and last one JSON line ``{kind: {"one": [...], "ranks": [...]}}``.
It writes under build/chip_smoke/ and deletes that tree before each kind.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "chip_smoke"
KINDS = ("alone", "after7", "stale", "stale_reused")
REHEARSAL_HW = (128, 128)  # TRAIN_HW of a CPU rehearsal of phase 7


def run_kind(kind: str):
    """One kind, in this process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if kind == "after7":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if kind.startswith("stale"):
        hw = cs.TRAIN_HW
        cs.TRAIN_HW = REHEARSAL_HW
        cs._train_fixture(WORK / "train")
        cs.TRAIN_HW = hw
        if kind == "stale_reused":  # the stamp of the right parameters over the stale data
            stamp = json.dumps({"clips": ["bear", "boat"], "frames": cs.TRAIN_FRAMES,
                                "hw": list(cs.TRAIN_HW), "crf": [15, 25, 35], "seed": cs.SEED})
            (WORK / "train" / "data" / "fixture.json").write_text(stamp)
    dev, smi = cs.phase_device()
    cs.phase_build()
    if kind == "after7":
        cs.phase_train(dev, smi)
    cs.phase_ddp_train(dev, smi)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kinds", default=",".join(KINDS))
    p.add_argument("--device", default="cuda", choices=["cuda"],
                   help="phase 17 runs on the card only")
    args = p.parse_args(argv)
    losses = {}
    for kind in args.kinds.split(","):
        if kind not in KINDS:
            raise SystemExit(f"unknown kind {kind!r}: {KINDS}")
        if WORK.exists():
            shutil.rmtree(WORK)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--run-kind", kind],
                              capture_output=True, text=True, timeout=900, cwd=ROOT)
        print(f"[phase17] {kind}: exit {proc.returncode} in {time.perf_counter() - t0:.0f} s")
        for line in proc.stdout.splitlines():
            if line.startswith(("[ddp17] entry", "[train] fixture")):
                print(f"[phase17]   {line}")
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-3000:])
            raise SystemExit(f"phase 17 ({kind}) exited {proc.returncode}")
        losses[kind] = {tag: [json.loads(ln)["loss"] for ln in
                              (WORK / "ddp" / tag / "scalars.json").read_text().splitlines()]
                        for tag in ("one", "ranks")}
    if WORK.exists():
        shutil.rmtree(WORK)
    print(json.dumps(losses))
    return losses


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--run-kind":
        run_kind(sys.argv[2])
    else:
        main()
