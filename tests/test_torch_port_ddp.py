"""Data-parallel training in the port (``tools/torch_train.py --launcher
pytorch``, tools/torch_dist_train.sh) on the CPU, against one process on
the global batch: the counterpart of tools/train.py's ``dp`` mesh axis.

- the rank shards: each rank's batches are, bit for bit, its rows of the
  one-process batch of ``world * samples_per_gpu`` (the flagship's DAVIS
  mixture and the Big mixture, W = 2 and 3);
- the backend rule (gloo on the CPU and for ranks that share a card, NCCL
  where every rank has a card) as a function, and ``CHIPS`` / ``PNP_NUM_CHIPS``;
- tools/torch_dist_train.sh with 2 ranks (16 channels, 2 DRT blocks, 3
  experts, 4 frames at 16x16, 2 samples a rank): after 3 iterations its
  weights and logged losses (read unrounded from the run's scalars.json)
  within 1e-5 of one process on the global batch of 4
  (the bound of the 5-step Adam test against JAX in
  tests/test_torch_port_train.py); only rank 0 wrote checkpoints and log
  lines;
- a real 2-rank gloo world, started as tests/test_torch_port_multihost.py
  starts one, resuming that run from iteration 2: equal, bit for bit, to
  the uninterrupted run.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pnp_vcve_torch.parallel.multihost import choose_backend, num_cards

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ITERS = 3
PER_RANK = 2
TOL = 1e-5

# one rank of the CLI that records the files it saves
_WORKER = r"""
import json, os, sys
sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tools")]
import torch

saved, save = [], torch.save

def saving(obj, f, *a, **k):
    saved.append(os.path.basename(str(f)))
    return save(obj, f, *a, **k)

torch.save = saving
import torch_train

torch_train.main(sys.argv[2:])
print("RESULT " + json.dumps({"rank": int(os.environ["RANK"]), "saved": saved}))
"""


def _losses(work: Path) -> list:
    """The logged losses, unrounded, from the run's ``scalars.json``."""
    return [json.loads(ln)["loss"] for ln in (work / "scalars.json").read_text().splitlines()]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def davis_root(tmp_path_factory):
    """2 DAVIS-layout clips x 20 frames at 32x32, CRF 15/25/35 and sharp."""
    sys.path.insert(0, str(REPO / "tools" / "data"))
    from make_protocol_fixture import write_fixture

    root = tmp_path_factory.mktemp("davis")
    merged = {}
    for crf in (15, 25, 35):
        write_fixture(root, clips=("bear", "boat"), frames=20, height=32, width=32, crf=crf,
                      seed=0, quiet=True)
        merged.update(json.loads((root / "qp.json").read_text()))
    (root / "qp.json").write_text(json.dumps(merged))
    return root


def _davis_cfg(root, frames=4, patch=16):
    from pnp_vcve_torch.core.presets import train_dataset

    cfg = train_dataset("DAVISMultipleGTMixCompressDataset", str(root), "sharp",
                        str(root / "qp.json"))
    cfg["dataset"]["num_input_frames"] = frames
    crop = next(s for s in cfg["dataset"]["pipeline"] if s["type"] == "PairedRandomCrop_mv")
    crop["gt_patch_size"] = patch
    return cfg


def _big_cfg(root, frames=3, patch=16):
    roots = lambda sub: {"A": f"{root}/{sub}/png", "B": f"{root}/{sub}/png"}  # noqa: E731
    qp = str(root / "qp.json")
    return dict(
        type="BigMultipleGTMixCompressDataset",
        lq_folder=roots("crf15"), gt_folder=roots("sharp"), cprs15_folder=roots("crf15"),
        cprs25_folder=roots("crf25"), cprs35_folder=roots("crf35"), num_input_frames=frames,
        sequence_length={"A": 20, "B": 20}, scale=1,
        pipeline=[
            dict(type="GenerateFrameIndicesEDVR_mix", interval_list=[1, 2]),
            dict(type="LoadImageFromFileList_Mix_Compress_ipb_mixdataset", key="lq",
                 qp_slice_file={"A": qp, "B": qp}, data_ratio=[0.25, 0.5, 0.75, 1.0]),
            dict(type="PairedRandomCrop_mv", gt_patch_size=patch),
            dict(type="Flip", keys=["lq", "gt"], flip_ratio=0.5, direction="horizontal"),
        ],
    )


# ---- the rank shards ---------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("mixture", ["davis", "big"])
def test_rank_shards_are_rows_of_the_global_batch(davis_root, mixture, world):
    """Rank r of W loads rows r*s .. (r+1)*s - 1 of the one-process batch of
    W*s, bit for bit, at every step (two steps from a start step of 3)."""
    from pnp_vcve_torch.core.builder import build_dataset, build_train_datasets
    from pnp_vcve_torch.data.loader import PrefetchLoader, WeightedMixture

    if mixture == "davis":
        source = WeightedMixture(build_train_datasets([_davis_cfg(davis_root, patch=16)] * 2),
                                 [1, 2])
    else:
        source = build_dataset(_big_cfg(davis_root))
    s = 2
    one = PrefetchLoader(source, batch_size=world * s, seed=5, num_threads=2, start_step=3)
    ranks = [PrefetchLoader(source, batch_size=s, seed=5, num_threads=1, start_step=3,
                            rank=r, world=world) for r in range(world)]
    try:
        want = [next(iter(one)) for _ in range(2)]
        got = [[next(iter(ld)) for _ in range(2)] for ld in ranks]
    finally:
        for ld in [one, *ranks]:
            ld.stop()
    for r in range(world):
        for step in range(2):
            for k, v in want[step].items():
                np.testing.assert_array_equal(got[r][step][k].numpy(),
                                              v[r * s:(r + 1) * s].numpy(), err_msg=k)
    with pytest.raises(ValueError, match="outside a world"):
        PrefetchLoader(source, batch_size=s, rank=world, world=world)


# ---- the backend rule --------------------------------------------------------------------


@pytest.mark.parametrize("device_type,local_world,cards,want", [
    ("cpu", 2, 0, "gloo"),
    ("cpu", 1, 8, "gloo"),
    ("cuda", 2, 1, "gloo"),             # two ranks share the one card
    ("cuda", 8, 4, "gloo"),
    ("cuda", 1, 1, "cpu:gloo,cuda:nccl"),
    ("cuda", 4, 4, "cpu:gloo,cuda:nccl"),
    ("cuda", 2, 8, "cpu:gloo,cuda:nccl"),
])
def test_backend_rule(device_type, local_world, cards, want):
    assert choose_backend(device_type, local_world, cards) == want


def test_card_count_reads_chips(monkeypatch):
    """PNP_NUM_CHIPS (or CHIPS) bounds the cards as make_mesh bounds its
    devices; unset or 0 means every card; more than there are raises."""
    monkeypatch.delenv("PNP_NUM_CHIPS", raising=False)
    monkeypatch.delenv("CHIPS", raising=False)
    assert num_cards(8) == 8
    monkeypatch.setenv("CHIPS", "2")
    assert num_cards(8) == 2
    monkeypatch.setenv("PNP_NUM_CHIPS", "0")
    assert num_cards(8) == 8
    monkeypatch.setenv("PNP_NUM_CHIPS", "3")
    assert num_cards(8) == 3
    with pytest.raises(ValueError, match="CHIPS=3 requested but only 2 devices"):
        num_cards(2)


# ---- the CLI in a 2-rank world against one process ---------------------------------------------


@pytest.fixture(scope="module")
def train_cfg(davis_root, tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "ddp_train.py"
    path.write_text(f"""
_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / 'HR_davis_LR_128x128.py')!r}]
model = dict(generator=dict(mid_channels=16, num_blocks=2, num_experts=3))
data = dict(train=[{_davis_cfg(davis_root)!r}], workers_per_gpu=2,
            train_dataloader=dict(samples_per_gpu={PER_RANK}))
log_config = dict(interval=1)
checkpoint_config = dict(interval=2)
""")
    return path


def _args(cfg, work, *extra):
    return [str(cfg), "--device", "cpu", "--work-dir", str(work), "--total-iters", str(ITERS),
            *extra]


@pytest.fixture(scope="module")
def one_process(train_cfg, tmp_path_factory):
    """tools/torch_train.py in this process on the global batch of 2 x 2:
    its logged losses and its last checkpoint."""
    sys.path.insert(0, str(REPO / "tools"))
    import torch_train

    work = tmp_path_factory.mktemp("one")
    torch_train.main(_args(train_cfg, work, "--cfg-options",
                           f"data.train_dataloader.samples_per_gpu={2 * PER_RANK}"))
    return _losses(work), torch.load(work / "ckpt" / f"{ITERS}.pth", weights_only=True)


@pytest.fixture(scope="module")
def two_ranks(train_cfg, tmp_path_factory):
    """tools/torch_dist_train.sh CONFIG 2 --device cpu --time-allreduce:
    torchrun's two gloo ranks for 3 iterations, checkpoints at 2 and 3."""
    work = tmp_path_factory.mktemp("two") / "work"
    args = _args(train_cfg, work, "--time-allreduce")
    proc = subprocess.run(["bash", str(REPO / "tools" / "torch_dist_train.sh"), args[0], "2",
                           *args[1:]],
                          capture_output=True, text=True, cwd=work.parent, timeout=240,
                          env=dict(os.environ, PYTHON=sys.executable))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work, proc.stdout


def _world(tmp_path, n, args):
    worker = tmp_path / "rank.py"
    worker.write_text(_WORKER)
    # one thread a rank, as torchrun sets it
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, str(worker), str(REPO), *args, "--launcher",
                               "pytorch"], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=tmp_path)
             for r in range(n)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        result = json.loads(out.split("RESULT ")[-1])
        outs.append((result, out))
    return sorted(outs, key=lambda o: o[0]["rank"])


def _assert_weights_close(got, want, tol):
    assert got.keys() == want.keys()
    worst = max(float((got[k] - v).abs().max()) for k, v in want.items())
    assert worst <= tol, worst
    return worst


def test_dist_train_sh_two_ranks_equal_one_process(one_process, two_ranks):
    """2 ranks x 2 samples for 3 iterations through tools/torch_dist_train.sh:
    the weights and each logged loss within 1e-5 of one process on the
    batch of 4; rank 0 alone logged (each line once, each loss once) and
    printed the backend, its all-reduce time and every rank's launch
    counts."""
    want_losses, want = one_process
    work, stdout = two_ranks
    np.testing.assert_allclose(_losses(work), want_losses, rtol=0, atol=TOL)
    got = torch.load(work / "ckpt" / f"{ITERS}.pth", weights_only=True)
    _assert_weights_close(got["model"], want["model"], TOL)
    assert got["step"] == ITERS and got["scheduler"]["last_epoch"] == ITERS
    assert sorted(f.name for f in (work / "ckpt").iterdir()) == ["2.pth", f"{ITERS}.pth"]
    log = (work / "train.log").read_text()
    assert [log.count(f"iter {i}/3 loss=") for i in (1, 2, 3)] == [1, 1, 1]
    assert [stdout.count(f"iter {i}/3 loss=") for i in (1, 2, 3)] == [1, 1, 1]
    assert "all-reduce" in log and "global batch 4 = 2 x 2 rank(s)" in log
    assert stdout.count("[dist] backend gloo: 2 ranks, 2 on this node") == 1
    assert "kernel launches by rank: [{" in log


def test_two_rank_resume_equals_uninterrupted_run(two_ranks, train_cfg, tmp_path):
    """A real 2-rank gloo world (two processes on a free local port)
    resuming the torchrun run from its checkpoint 2 ends on its checkpoint
    3 bit for bit; only rank 0 saved a file or logged a line."""
    work, _ = two_ranks
    resumed = tmp_path / "resumed"
    (r0, out0), (r1, out1) = _world(tmp_path, 2, _args(train_cfg, resumed, "--resume-from",
                                                       str(work / "ckpt" / "2.pth")))
    assert r0["saved"] == [f".{ITERS}.pth.tmp"] and r1["saved"] == []
    assert "iter 3/3 loss=" in out0 and "iter " not in out1 and "[dist]" not in out1
    want = torch.load(work / "ckpt" / f"{ITERS}.pth", weights_only=True)
    got = torch.load(resumed / "ckpt" / f"{ITERS}.pth", weights_only=True)
    for k, v in want["model"].items():
        torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0)
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            torch.testing.assert_close(got["optimizer"]["state"][i][k], v, rtol=0, atol=0)
    assert _losses(resumed) == _losses(work)[2:]


def test_train_cli_never_falls_back(train_cfg, tmp_path, monkeypatch):
    """Without torchrun's variables --launcher pytorch and --multihost raise,
    and --device cuda raises without a card: no rank trains on one process
    or on the CPU instead."""
    sys.path.insert(0, str(REPO / "tools"))
    import torch_train

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for flag in ("--launcher=pytorch", "--multihost"):
        with pytest.raises(RuntimeError, match="torchrun"):
            torch_train.main(_args(train_cfg, tmp_path, flag))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_train.main([str(train_cfg), "--work-dir", str(tmp_path)])
    assert not (tmp_path / "ckpt").exists()


def test_averaged_loss_holds_no_gradient_buffer():
    """The averaged loss that the step returns, and that the loop keeps
    until its next log line, is a one-element tensor of its own, not a view
    of the flat gradient buffer: at log_config.interval=100 views would
    keep 100 buffers of the model's size alive. Untimed, the step adds no
    ``allreduce_s``."""
    import torch.distributed as dist

    from pnp_vcve_torch.train.train_step import _average_over_ranks

    params = [torch.nn.Parameter(torch.zeros(1000)) for _ in range(3)]
    for i, p in enumerate(params):
        p.grad = torch.full_like(p, float(i))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        held = [_average_over_ranks(params, torch.tensor(0.25), 1, False) for _ in range(3)]
    finally:
        dist.destroy_process_group()
    assert all(m.keys() == {"loss"} for m in held)
    assert [float(m["loss"]) for m in held] == [0.25] * 3
    assert all(m["loss"].untyped_storage().nbytes() == 4 for m in held)
    assert [float(p.grad[0]) for p in params] == [0.0, 1.0, 2.0]
