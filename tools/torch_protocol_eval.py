#!/usr/bin/env python
"""Protocol-scale eval of the PyTorch/CUDA port (counterpart of
tools/protocol_eval.py:209-290): the reference's regression protocol
(100-frame 720p clips, per-clip PSNR/SSIM, reference tools/test.py:175-182,
mmedit/models/restorers/basicvsr.py:155-233) on a REDS4-layout fixture that
tools/data/make_protocol_fixture.py writes, with a JSON artifact.

Legs (each optional):

1. ``card`` -- the flagship shape (64 channels, 8 blocks, 6 experts, the
   'padgather' warp) on the parity weights (tests/fixtures/parity/
   state_dict.npz, loaded directly: they carry the reference's
   ``generator.*`` names), every clip at full context (one pass over all
   ``--frames``: on an 80 GB card the backward-feature stack of 100 frames
   of 720p, 23.6 GB in float32, fits), then in ``--chunk-t`` windows (each
   window's first and last frames forced keyframes). Per clip and on the
   mean: PSNR/SSIM of both runs and their difference, the generator's
   frames/s (host clock around the synchronised forward) and
   ``torch.cuda.max_memory_allocated`` of each run. The clips are loaded
   once; the host metrics run on a thread for each CPU core, a frame each,
   and sum in frame order as the eval harness does.
2. ``exact`` -- tools/torch_test.py on the first ``--exact-clips`` clips
   with a narrower flagship (``--exact-mid/--exact-blocks/--exact-experts``,
   seeded weights): the whole-clip run against ``--frame-parallel exact
   --stream-clips N`` (over ``--pipeline-devices`` when given), which must
   write bitwise equal PNGs and print equal metrics, as
   tools/protocol_eval.py:275-283 requires.

Usage (on a card; ``--device cpu`` and a tiny geometry on the CPU):

    python tools/torch_protocol_eval.py [--frames 100] [--chunk-t 20] \\
        [--pipeline-devices cuda:0,cuda:0,cuda:0,cuda:0] \\
        --out build/protocol.json
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tools"), str(REPO / "tools" / "data")]

EVAL_RE = re.compile(r"\[eval\] (\S+): PSNR=([\d.]+) SSIM=([\d.]+) \((\d+) frames")
PARITY = REPO / "tests" / "fixtures" / "parity"


def ensure_fixture(root: Path, clips, frames, height, width) -> None:
    """The REDS4-layout fixture, written unless one of this spec is there."""
    spec = dict(clips=list(clips), frames=frames, height=height, width=width)
    spec_file = root / "fixture_spec.json"
    if spec_file.exists() and json.loads(spec_file.read_text()) == spec:
        print(f"[protocol] fixture reused at {root}")
        return
    from make_protocol_fixture import write_fixture

    t0 = time.perf_counter()
    write_fixture(root, clips=clips, frames=frames, height=height, width=width, quiet=True)
    spec_file.write_text(json.dumps(spec))
    print(f"[protocol] fixture written in {time.perf_counter() - t0:.1f} s", flush=True)


def write_config(path: Path, view: Path, root: Path, frames: int, mid: int, blocks: int,
                 experts: int) -> Path:
    """The flagship test pipeline over every clip folder of ``view``."""
    path.write_text(f"""
from pnp_vcve_torch.core.presets import flagship_data, flagship_model

model = flagship_model(mid_channels={mid}, num_blocks={blocks}, num_experts={experts})
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
data = flagship_data(test_lq={str(view / 'crf15' / 'png')!r},
                     test_gt={str(view / 'sharp' / 'png')!r},
                     test_qp_json={str(root / 'qp.json')!r})
data["test"].update(type="SRFolderMultipleGTDataset", num_input_frames={frames})
""")
    return path


def make_view(root: Path, view: Path, clips) -> None:
    """A folder view of ``clips`` (symlinks): the folder dataset evaluates
    whatever clip directories exist."""
    for sub in (("crf15", "png"), ("sharp", "png")):
        dst = view.joinpath(*sub)
        dst.mkdir(parents=True, exist_ok=True)
        for c in clips:
            if not (dst / c).exists():
                (dst / c).symlink_to(root.joinpath(*sub, c))
    if not (view / "crf15" / "mv").exists():
        (view / "crf15" / "mv").symlink_to(root / "crf15" / "mv")


def clip_metrics(restorer, out: np.ndarray, gt: np.ndarray) -> dict:
    """``restorer.evaluate_clip`` a frame at a time on a thread for each
    core (numpy releases the interpreter lock), summed in frame order: the
    harness's numbers."""
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        per = list(pool.map(lambda i: restorer.evaluate_clip(out[i:i + 1], gt[i:i + 1]),
                            range(out.shape[0])))
    return {k: sum(m[k] for m in per) / len(per) for k in per[0]}


def _mean(per_clip: dict) -> dict:
    return {k: float(np.mean([m[k] for m in per_clip.values()])) for k in ("PSNR", "SSIM")}


def card_leg(args, root: Path, device) -> dict:
    """The flagship on the parity weights, full context then chunked."""
    import torch

    from pnp_vcve_torch.core.builder import build_dataset, build_restorer
    from pnp_vcve_torch.core.checkpoint import load_generator_weights
    from pnp_vcve_torch.core.config import Config
    from pnp_vcve_torch.train.eval import enhance_clip
    from pnp_vcve_torch.train.train_step import make_eval_step

    spec = json.loads((PARITY / "spec.json").read_text())["spec"]
    cfg = Config.fromfile(write_config(root / "cfg_card.py", root, root, args.frames,
                                       spec["mid_channels"], spec["num_blocks"],
                                       spec["num_experts"]))
    restorer = build_restorer(cfg.model, cfg.get("test_cfg"), device=device)
    load_generator_weights(restorer.generator, str(PARITY / "state_dict.npz"))
    eval_step = make_eval_step(restorer.generator)
    runs = {"full_context": None, "chunked": args.chunk_t}
    res = {k: dict(per_clip={}, seconds=0.0, frames=0, peak_bytes=0) for k in runs}
    for sample in build_dataset(cfg.data["test"]):
        name = sample["clip_name"]
        for run, chunk_t in runs.items():
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = enhance_clip(eval_step, sample, chunk_t=chunk_t)  # numpy: synchronised
            dt = time.perf_counter() - t0
            r = res[run]
            r["seconds"] += dt
            r["frames"] += out.shape[0]
            if device.type == "cuda":
                r["peak_bytes"] = max(r["peak_bytes"], torch.cuda.max_memory_allocated())
            m = clip_metrics(restorer, out, sample["gt"])
            r["per_clip"][name] = dict(m, frames=out.shape[0], seconds=dt)
            print(f"[protocol] card {run} {name}: PSNR={m['PSNR']:.4f} SSIM={m['SSIM']:.4f} "
                  f"({out.shape[0]} frames, {dt:.3f} s)", flush=True)
            del out
    for r in res.values():
        r["mean"] = _mean(r["per_clip"])
        if device.type != "cuda":
            r["peak_bytes"] = "not measured (CPU run)"
    full, chunked = res["full_context"], res["chunked"]
    chunked["chunk_t"] = args.chunk_t
    return dict(
        model=spec, weights="tests/fixtures/parity/state_dict.npz (synthetic weights: "
        "PSNR is a plumbing check, not a quality claim)",
        full_context=full, chunked=chunked,
        delta_per_clip={c: {k: full["per_clip"][c][k] - chunked["per_clip"][c][k]
                            for k in ("PSNR", "SSIM")} for c in full["per_clip"]},
        delta_mean={k: full["mean"][k] - chunked["mean"][k] for k in ("PSNR", "SSIM")},
        frames_per_second={k: r["frames"] / r["seconds"] for k, r in res.items()},
    )


def _cli_run(cfg: Path, save: Path, extra: list) -> dict:
    """tools/torch_test.py in this process; per-clip metrics from its log."""
    import torch_test

    argv = [str(cfg), "-"] + extra + ["--save-path", str(save), "--save-image"]
    print("[protocol] tools/torch_test.py " + " ".join(argv), flush=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        mean = torch_test.main(argv)
    wall = time.perf_counter() - t0
    sys.stdout.write(log.getvalue()[-3000:])
    per_clip = {m.group(1): dict(PSNR=float(m.group(2)), SSIM=float(m.group(3)),
                                 frames=int(m.group(4)))
                for m in EVAL_RE.finditer(log.getvalue())}
    if not per_clip:
        raise RuntimeError("no per-clip [eval] lines:\n" + log.getvalue()[-2000:])
    return dict(per_clip=per_clip, mean=mean, wall_seconds=wall)


def compare_outputs(dir_a: Path, dir_b: Path) -> dict:
    """The largest uint8 difference over the PNGs both runs wrote."""
    from PIL import Image

    worst, n = 0, 0
    for pa in sorted(dir_a.glob("*/*.png")):
        pb = dir_b / pa.parent.name / pa.name
        if pb.exists():
            a = np.asarray(Image.open(pa), np.int16)
            worst = max(worst, int(np.abs(a - np.asarray(Image.open(pb), np.int16)).max()))
            n += 1
    return dict(frames_compared=n, max_uint8_diff=worst)


def exact_leg(args, root: Path, clips) -> dict:
    """The whole-clip run against the exact pipeline through the CLI."""
    view = root / "exact_view"
    make_view(root, view, clips)
    frames = args.frames
    cfg = write_config(root / "cfg_exact.py", view, root, frames, args.exact_mid,
                       args.exact_blocks, args.exact_experts)
    dev = ["--device", args.device]
    exact = ["--frame-parallel", "exact", "--stream-clips", str(args.stream_clips)]
    if args.pipeline_devices:
        exact += ["--pipeline-devices", args.pipeline_devices]
    a = _cli_run(cfg, root / "out_scan", dev)
    b = _cli_run(cfg, root / "out_exact", dev + exact)
    cmp = compare_outputs(root / "out_scan", root / "out_exact")
    equal = a["per_clip"] == b["per_clip"] and a["mean"] == b["mean"]
    if not equal:
        raise AssertionError(f"metrics differ: {a['per_clip']} {a['mean']} vs "
                             f"{b['per_clip']} {b['mean']}")
    if cmp["frames_compared"] != len(clips) * frames or cmp["max_uint8_diff"] != 0:
        raise AssertionError(f"exact-pipeline outputs differ: {cmp}")
    return dict(model=f"mid={args.exact_mid}/nb={args.exact_blocks}/K={args.exact_experts}",
                clips=list(clips), frames=frames, exact_args=exact, whole_clip_scan=a,
                exact_pipeline=b, cross_check=cmp, metrics_equal=equal,
                verdict="exact pipeline bitwise equal to the whole-clip scan")


def _card(device) -> str:
    import torch

    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return f"{torch.cuda.get_device_name(device)} ({smi.stdout.strip()})"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="'cuda' (kernels) or 'cpu'")
    p.add_argument("--root", default=str(REPO / "build" / "protocol"))
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--clips", default="000,011,015,020")
    p.add_argument("--chunk-t", type=int, default=20)
    p.add_argument("--skip-card", action="store_true")
    p.add_argument("--skip-exact", action="store_true")
    p.add_argument("--exact-mid", type=int, default=16)
    p.add_argument("--exact-blocks", type=int, default=2)
    p.add_argument("--exact-experts", type=int, default=3)
    p.add_argument("--exact-clips", type=int, default=2, help="the exact leg's first N clips")
    p.add_argument("--stream-clips", type=int, default=2)
    p.add_argument("--pipeline-devices", default=None)
    p.add_argument("--out", default=None, help="JSON artifact path")
    args = p.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    root = Path(args.root)
    clips = tuple(args.clips.split(","))
    ensure_fixture(root, clips, args.frames, args.height, args.width)
    art = dict(device=_card(device), fixture=dict(clips=list(clips), frames=args.frames,
                                                  height=args.height, width=args.width),
               protocol="reference tools/test.py clip eval (per-clip PSNR/SSIM)")
    if not args.skip_card:
        art["card"] = card_leg(args, root, device)
    if not args.skip_exact:
        art["exact"] = exact_leg(args, root, clips[:args.exact_clips])
    text = json.dumps(art, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
        print(f"[protocol] artifact -> {args.out}")
    print(text[:4000])
    return art


if __name__ == "__main__":
    main()
