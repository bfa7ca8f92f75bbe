#!/usr/bin/env python
"""Phase 12 of chip_smoke.py (the probe kernels K6-K10 at their TPU
probes' shapes, and K10 and K5 at K5's 720p geometry beside cuDNN) and
phase 13's K11 cases (``chip_smoke.phase_gather2``: the warp probe's
gather at 720p, its edge tables, its first 12 bands warm in the L2) on two
trees in turns on one card, each run a process of its own: ``--other``, a
checkout of another commit (``git archive`` of it unpacked under the
git-ignored build/), and this checkout. Every run uses this checkout's
chip_smoke.py and tools/torch_kernel_bounds.py (copied over the other
tree's) with the tree's own package and other tools, so both are measured
by the same phase. Prints each K7, K8, K10 (both forms) and K11 stage's
readings (and K5's) run by run (cold, device, host-enqueue, warm device
where taken; ms) and writes each run's rows as JSON under ``--out``.

    python tools/torch_probe_turns.py --other build/parent                 # other, this, this, other
    python tools/torch_probe_turns.py --other build/parent --order other   # the other tree alone
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from pnp_vcve_torch.kernels import probes
if "tapconv_int8" not in probes.LAUNCHES:
    # a tree from before K10's int8 form was counted apart counts it under
    # tapconv: count its int8 launches under tapconv_int8 too, as phase 12 reads
    probes.LAUNCHES["tapconv_int8"] = 0
    tapconv = probes.tapconv

    def counted(band, w, rows, cols, scale=None):
        out = tapconv(band, w, rows, cols, scale)
        if scale is not None and band.is_cuda:
            probes.LAUNCHES["tapconv_int8"] += 1
        return out

    probes.tapconv = counted
dev, smi = cs.phase_device()
rows = cs.phase_probes(dev, smi)
rows.update(cs.phase_gather2(dev, smi))
with open(sys.argv[1], "w") as f:
    json.dump({"smi": smi, "rows": rows}, f)
"""
KERNELS = ("mmsel", "tapconv", "tapconv_int8", "matmul", "gather2")


def run(label, root, out_dir, k):
    """One process: this checkout's phase 12 on ``root``'s package; its
    JSON rows, its log under ``out_dir``."""
    root = Path(root).resolve()
    if root != ROOT:  # the measurement: this checkout's phase and bounds
        shutil.copy(ROOT / "chip_smoke.py", root / "chip_smoke.py")
        shutil.copy(ROOT / "tools" / "torch_kernel_bounds.py",
                    root / "tools" / "torch_kernel_bounds.py")
    out = out_dir / f"run{k}_{label}.json"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN, str(out)], cwd=root, capture_output=True,
                          text=True)
    (out_dir / f"run{k}_{label}.log").write_text(proc.stdout + proc.stderr)
    print(f"[turns] run {k} ({label}, {root}): exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode:
        print(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"torch_probe_turns: run {k} ({label}) failed")
    return json.loads(out.read_text())


def fmt(v):
    return "—" if v is None else f"{v:.4f}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, help="the other tree's root")
    p.add_argument("--order", default="other,this,this,other",
                   help="comma-separated runs (other / this), default other,this,this,other")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_turns"))
    args = p.parse_args(argv)
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = {"other": args.other, "this": ROOT}
    order = args.order.split(",")
    if any(o not in roots for o in order):
        raise SystemExit(f"torch_probe_turns: --order takes other and this, got {args.order}")
    runs = [(label, run(label, roots[label], out_dir, k)) for k, label in enumerate(order)]
    print(f"[turns] {runs[0][1]['smi']}")
    print("| stage | " + " | ".join(f"run {k} ({label})" for k, (label, _) in enumerate(runs))
          + " |")
    print("|---|" + "---|" * len(runs))
    for name in KERNELS:
        # each run's stages by label: a tree may time stages (yardsticks) the
        # other has no entry for
        by_run = [{r["tpu"]: r for r in res["rows"][name]["forms"]
                   + res["rows"][name].get("k5_geometry", [])} for _, res in runs]
        labels = list(dict.fromkeys(t for stages in by_run for t in stages))
        for label in labels:
            cells, st = [], None
            for stages in by_run:
                row = stages.get(label)
                if row is None:
                    cells.append("—")
                    continue
                st = row
                warm = (f", warm device {fmt(row['warm_device_ms'])}"
                        if "warm_device_ms" in row else "")
                cells.append(f"cold {fmt(row['cold_ms'])}, device {fmt(row['device_ms'])}, "
                             f"host {fmt(row['ms'])}{warm}; library cold "
                             f"{fmt(row['library_cold_ms'])}, device "
                             f"{fmt(row['library_device_ms'])}")
            print(f"| {name}: {label} (bound {st['bound_ms']:.4f}, {st['bound_by']}) | "
                  + " | ".join(cells) + " |")
    (out_dir / "summary.json").write_text(json.dumps(
        [{"run": k, "tree": label, **res} for k, (label, res) in enumerate(runs)]))
    return runs


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
