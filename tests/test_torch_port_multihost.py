"""The port's multi-process eval (pnp_vcve_torch/parallel/multihost.py,
``tools/torch_test.py --launcher pytorch --multihost`` and
tools/torch_dist_test.sh) in real 2-process gloo worlds on the CPU.

As tests/test_multihost.py does for JAX: 5 clips split 3/2 over two ranks
must give the exact count-weighted means; and two ranks of the CLI under
torchrun over 3 clips (an uneven 2/1 share) must give the single-process
CLI's dataset mean within 1e-6 relative.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from pnp_vcve_torch.parallel.multihost import (
    allreduce_clip_metrics,
    init_distributed,
    shard_clips,
)

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from pnp_vcve_torch.parallel.multihost import allreduce_clip_metrics, init_distributed, shard_clips
import torch.distributed as dist

device = init_distributed("pytorch", "cpu")
rank, world = dist.get_rank(), dist.get_world_size()
clips = [{"PSNR": float(i), "SSIM": float(i) / 10} for i in range(5)]
mine = [clips[i] for i in shard_clips(5, rank, world)]
agg = allreduce_clip_metrics(mine)
print(json.dumps({"rank": rank, "world": world, "device": str(device), "n": len(mine),
                  "psnr": agg["PSNR"], "ssim": agg["SSIM"]}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n,world", [(5, 2), (3, 2), (7, 3), (2, 4), (0, 2)])
def test_shard_clips_equals_jax(n, world):
    from pnp_vcve_tpu.parallel.multihost import shard_clips as jax_shard

    shards = [shard_clips(n, r, world) for r in range(world)]
    assert shards == [jax_shard(n, r, world) for r in range(world)]
    assert sorted(i for s in shards for i in s) == list(range(n))


def test_one_process_reduction_is_the_local_mean():
    """Without a process group: the count-weighted mean of this process's
    clips, in float32 as JAX builds it; no clips, no metrics."""
    clips = [{"PSNR": 30.0, "SSIM": 0.5}, {"PSNR": 31.0, "SSIM": 0.75}]
    assert allreduce_clip_metrics(clips) == {"PSNR": 30.5, "SSIM": 0.625}
    assert allreduce_clip_metrics([]) == {}


def test_two_process_world(tmp_path):
    """A real 2-rank gloo world: 5 clips split 3/2, the exact global means."""
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, str(worker), str(REPO)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted((o["rank"], o["n"]) for o in outs) == [(0, 3), (1, 2)]
    for o in outs:
        assert o["world"] == 2 and o["device"] == "cpu"
        assert abs(o["psnr"] - 2.0) < 1e-6 and abs(o["ssim"] - 0.2) < 1e-6


def test_launcher_without_torchrun_raises(monkeypatch, tmp_path):
    """No torchrun environment: init_distributed and the CLI's --launcher
    pytorch / --multihost raise; they never run one process instead."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        init_distributed("pytorch", "cpu")
    with pytest.raises(ValueError, match="only 'pytorch'"):
        init_distributed("slurm", "cpu")
    sys.path.insert(0, str(REPO / "tools"))
    import torch_test

    for flag in ("--launcher=pytorch", "--multihost"):
        with pytest.raises(RuntimeError, match="torchrun"):
            torch_test.main([str(tmp_path / "none.py"), "-", "--device", "cpu", flag])


def test_dist_test_sh_two_ranks_equal_one_process(tmp_path):
    """tools/torch_dist_test.sh CONFIG - 2 over 3 clips (ranks take 2 and 1):
    rank 0's --out holds the single-process CLI's dataset mean within 1e-6
    relative; each rank writes its own clips' PNGs."""
    sys.path[:0] = [str(REPO / "tools"), str(REPO / "tools" / "data")]
    import torch_test
    from make_protocol_fixture import write_fixture

    root = write_fixture(tmp_path / "fx", clips=("000", "011", "015"), frames=4, height=32,
                         width=48, quiet=True)
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
from pnp_vcve_torch.core.presets import flagship_data, flagship_model
model = flagship_model(mid_channels=8, num_blocks=1, num_experts=2)
test_cfg = dict(metrics=["PSNR", "SSIM"], crop_border=0)
data = flagship_data(test_lq={str(root / 'crf15' / 'png')!r},
                     test_gt={str(root / 'sharp' / 'png')!r},
                     test_qp_json={str(root / 'qp.json')!r})
data["test"].update(type="SRFolderMultipleGTDataset", num_input_frames=4)
""")
    one = torch_test.main([str(cfg), "-", "--device", "cpu"])
    proc = subprocess.run(
        ["bash", str(REPO / "tools" / "torch_dist_test.sh"), str(cfg), "-", "2", "--device",
         "cpu", "--out", str(tmp_path / "m.pkl"), "--save-path", str(tmp_path / "out"),
         "--save-image"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "m.pkl", "rb") as f:
        two = pickle.load(f)
    assert set(two) == set(one) == {"PSNR", "SSIM"}
    for k, v in one.items():
        assert abs(two[k] - v) <= 1e-6 * abs(v), (k, two[k], v)
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["000", "011", "015"]
    assert proc.stdout.count("[eval] dataset mean") == 2
