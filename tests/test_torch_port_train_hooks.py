"""The train CLI's hooks and flags in the port against the JAX package:
EMA (pnp_vcve_tpu/train/ema.py and utils/ema.py), the visualization grid
and hook, the tensorboard writer, the logger and environment report, the
loop's call points of the writer and the visual hook, and
tools/torch_train.py's ``--exp_name``, ``--deterministic``,
``--autoscale-lr`` and ``visual_config``.
"""

import json
import logging
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# ---- EMA ---------------------------------------------------------------------------------


def _param_stream(seed=0, steps=10):
    rng = np.random.default_rng(seed)
    shapes = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,), "gain": ()}
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(steps + 1)]


def test_ema_matches_jax_with_interval_and_start_iter():
    """10 steps, interval 2, start_iter 3: the warm-up copies, the ticks
    every second iteration from start_iter and the idle steps, to 1e-7."""
    from pnp_vcve_tpu.train.ema import ema_init as jax_init
    from pnp_vcve_tpu.train.ema import ema_update as jax_update
    from pnp_vcve_torch.train.ema import EmaState, ema_init, ema_update

    # eager, as the host-side EmaState calls it (under jax.jit XLA fuses the
    # lerp into an FMA, one rounding fewer)
    jax_update = partial(jax_update, momentum=0.9, interval=2, start_iter=3)
    stream = _param_stream()
    theirs = jax_init({k: jnp.asarray(v) for k, v in stream[0].items()})
    ours = ema_init({k: torch.from_numpy(v) for k, v in stream[0].items()})
    state = EmaState({k: torch.from_numpy(v) for k, v in stream[0].items()}, momentum=0.9,
                     interval=2, start_iter=3)
    changed = 0
    for step, params in enumerate(stream[1:]):
        before = {k: v.clone() for k, v in ours.items()}
        theirs = jax_update(theirs, {k: jnp.asarray(v) for k, v in params.items()}, step)
        ema_update(ours, {k: torch.from_numpy(v) for k, v in params.items()}, step,
                   momentum=0.9, interval=2, start_iter=3)
        state.update({k: torch.from_numpy(v) for k, v in params.items()}, step)
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=0, atol=1e-7)
            torch.testing.assert_close(state.params[k], ours[k], rtol=0, atol=0)
        changed += any(not torch.equal(before[k], ours[k]) for k in ours)
    assert changed == 3 + 3  # steps 0-2 copy the weights; steps 4, 6 and 8 tick


def test_ema_matches_jax_utils_tracker_and_takes_a_module():
    """utils/ema.py's tracker (1-based steps, ticks where s % interval == 0)
    is ema_update at step s - 1 with start_iter 0, up to float32 rounding
    (it computes ``m * e + (1 - m) * p``, train/ema.py ``p + (e - p) * m``:
    within 1e-6, two float32 ulps of the standard-normal weights' largest
    magnitudes, below 8); a module's parameters work as the live weights."""
    from pnp_vcve_tpu.utils.ema import EmaState as JaxTracker
    from pnp_vcve_torch.train.ema import EmaState

    stream = _param_stream(seed=1, steps=6)
    tracker = JaxTracker({k: jnp.asarray(v) for k, v in stream[0].items()}, momentum=0.75,
                         interval=2)
    ours = EmaState({k: torch.from_numpy(v) for k, v in stream[0].items()}, momentum=0.75,
                    interval=2)
    for s, params in enumerate(stream[1:], start=1):
        tracker.update(s, {k: jnp.asarray(v) for k, v in params.items()})
        ours.update({k: torch.from_numpy(v) for k, v in params.items()}, s - 1)
        for k, v in tracker.params.items():
            np.testing.assert_allclose(ours.params[k].numpy(), np.asarray(v), rtol=0, atol=1e-6)

    lin = torch.nn.Linear(3, 2)
    ema = EmaState(lin, momentum=0.5)
    with torch.no_grad():
        lin.weight.add_(1.0)
    ema.update(lin, 0)
    torch.testing.assert_close(ema.params["weight"], lin.weight.detach() - 0.5)


# ---- visualization -------------------------------------------------------------------------


@pytest.mark.parametrize("nrow,padding,rerange", [(1, 4, True), (2, 0, False), (3, 2, True)])
def test_image_grid_equals_jax(nrow, padding, rerange):
    from pnp_vcve_tpu.train.visualization import make_image_grid as jax_grid
    from pnp_vcve_torch.train.visualization import make_image_grid

    rng = np.random.default_rng(nrow)
    imgs = [rng.uniform(-1.2, 1.2, (h, w, 3)).astype(np.float32)
            for h, w in ((8, 12), (8, 12), (6, 12), (8, 10), (7, 9))]
    got = make_image_grid(imgs, nrow=nrow, padding=padding, rerange=rerange)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_grid(imgs, nrow=nrow, padding=padding,
                                                rerange=rerange))


def test_visualization_hook_equals_jax(tmp_path):
    """On the interval both hooks write the same PNG (5-D results show their
    middle frame); off it neither writes."""
    from PIL import Image

    from pnp_vcve_tpu.train.visualization import VisualizationHook as JaxHook
    from pnp_vcve_torch.train.visualization import VisualizationHook

    rng = np.random.default_rng(0)
    results = {"lq": rng.random((2, 3, 8, 8, 3), np.float32),
               "gt": rng.random((2, 8, 8, 3), np.float32),
               "output": rng.random((2, 8, 8, 3), np.float32)}
    kw = dict(res_name_list=["lq", "output", "gt", "absent"], interval=2, rerange=False,
              nrow=2, padding=1)
    ours = VisualizationHook(str(tmp_path / "ours"), **kw)
    theirs = JaxHook(str(tmp_path / "jax"), **kw)
    assert ours(0, results) is None and theirs(0, results) is None
    got, want = ours(1, results), theirs(1, results)
    assert Path(got).name == Path(want).name == "iter_2.png"
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


# ---- the writer and the logger --------------------------------------------------------------


def test_writer_writes_scalars_on_rank_0_only(tmp_path, monkeypatch):
    """The tensorboard writer and the JSON-lines writer in front of it
    (unrounded values) write on rank 0 and nothing on rank 1."""
    import pnp_vcve_torch.utils.logging as ul

    w = ul.JsonScalarWriter(str(tmp_path / "s0.json"), ul.TensorboardWriter(str(tmp_path / "tb0")))
    w.scalars(1, loss=0.123456789, iters_per_sec=2.0)
    w.scalars(2, **{"val/PSNR": 30.0})
    w.close()
    (events,) = (tmp_path / "tb0").iterdir()
    assert events.stat().st_size > 0
    assert [json.loads(ln) for ln in (tmp_path / "s0.json").read_text().splitlines()] == [
        {"step": 1, "loss": 0.123456789, "iters_per_sec": 2.0}, {"step": 2, "val/PSNR": 30.0}]

    monkeypatch.setattr(ul, "rank_and_world", lambda: (1, 2))
    w1 = ul.JsonScalarWriter(str(tmp_path / "s1.json"), ul.TensorboardWriter(str(tmp_path / "tb1")))
    w1.scalars(1, loss=0.5)
    w1.close()
    assert not (tmp_path / "tb1").exists() and not (tmp_path / "s1.json").exists()


def test_writer_without_packages_logs_once_and_does_nothing(tmp_path, monkeypatch, caplog):
    import pnp_vcve_torch.utils.logging as ul

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = logging.getLogger("pnp_vcve_torch")
    monkeypatch.setattr(logger, "propagate", True)
    monkeypatch.setattr(logger, "level", logging.INFO)
    with caplog.at_level(logging.INFO, logger="pnp_vcve_torch"):
        w = ul.TensorboardWriter(str(tmp_path / "tb"))
        w.scalars(1, loss=0.5)
        w.close()
    assert [r.message for r in caplog.records].count(
        "neither tensorboardX nor tensorboard is installed: no scalars are written") == 1
    assert not (tmp_path / "tb").exists()


def test_logger_rank_and_env_report(tmp_path, monkeypatch, capsys):
    """Rank 0 logs to stdout and its file; another rank is silenced to ERROR
    and opens no file; each call sets the handlers anew; the environment
    report names torch, CUDA, nvcc and the process group."""
    import pnp_vcve_torch.utils.logging as ul

    log0 = ul.get_root_logger(str(tmp_path / "a" / "train.log"))
    log0.info("hello")
    log0 = ul.get_root_logger(str(tmp_path / "b" / "train.log"))
    log0.info("again")
    assert "hello" in (tmp_path / "a" / "train.log").read_text()
    assert "again" in (tmp_path / "b" / "train.log").read_text()
    assert "hello" not in (tmp_path / "b" / "train.log").read_text()
    monkeypatch.setattr(ul, "rank_and_world", lambda: (1, 2))
    log1 = ul.get_root_logger(str(tmp_path / "c" / "train.log"))
    log1.info("quiet")
    assert log1.level == logging.ERROR and not (tmp_path / "c").exists()
    assert "quiet" not in capsys.readouterr().out
    env = ul.collect_env()
    assert env["torch"] == torch.__version__ and env["process group"] == "rank 1 of 2"
    assert {"python", "cuda (torch built with)", "cuda available", "nvcc"} <= set(env)
    ul.get_root_logger()  # rank 0 again, no file


# ---- the loop's call points -------------------------------------------------------------


def test_loop_hooks_called_where_jax_calls_them():
    """The writer, the visual hook, the logger and the evaluation: the same
    calls at the same steps as JAX's train_loop (rates left out)."""
    from pnp_vcve_tpu.train.loop import train_loop as jax_loop
    from pnp_vcve_torch.train.loop import train_loop
    from pnp_vcve_torch.train.state import TrainState

    def run(loop, wrap, state):
        events = []

        class Writer:
            def scalars(self, step, **values):
                events.append(("scalars", step, sorted(values),
                               values.get("loss"), values.get("val/PSNR")))

        def step_fn(st, batch):
            return st, {"loss": wrap(float(batch))}

        loop(state, step_fn, iter(range(10)), total_iters=7, log_interval=2,
             checkpoint_interval=100, eval_interval=3,
             eval_fn=lambda _: events.append(("eval",)) or {"PSNR": 30.0},
             logger=lambda msg: events.append(("log", msg.split(" (")[0])), start_iter=1,
             metrics_writer=Writer(), visual_fn=lambda s, b, st: events.append(("visual", s, b)))
        return events

    ours = run(train_loop, torch.tensor, TrainState(0, torch.nn.Linear(1, 1), None, None))
    theirs = run(jax_loop, float, SimpleNamespace(params=None))
    assert ours == theirs and ("scalars", 4, ["iters_per_sec", "loss"], 1.5, None) in ours


# ---- the CLI's flags ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_cfg(tmp_path_factory):
    sys.path[:0] = [str(REPO / "tools"), str(REPO / "tools" / "data")]
    import json

    from make_protocol_fixture import write_fixture

    from pnp_vcve_torch.core.presets import train_dataset

    root = tmp_path_factory.mktemp("davis")
    merged = {}
    for crf in (15, 25, 35):
        write_fixture(root, clips=("bear",), frames=20, height=32, width=32, crf=crf, seed=0,
                      quiet=True)
        merged.update(json.loads((root / "qp.json").read_text()))
    (root / "qp.json").write_text(json.dumps(merged))
    ds = train_dataset("DAVISMultipleGTMixCompressDataset", str(root), "sharp",
                       str(root / "qp.json"))
    ds["dataset"]["num_input_frames"] = 3
    next(s for s in ds["dataset"]["pipeline"]
         if s["type"] == "PairedRandomCrop_mv")["gt_patch_size"] = 16
    path = root / "cfg.py"
    path.write_text(f"""
_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / 'HR_davis_LR_128x128.py')!r}]
model = dict(generator=dict(mid_channels=8, num_blocks=1, num_experts=2))
data = dict(train=[{ds!r}], workers_per_gpu=1, train_dataloader=dict(samples_per_gpu=1))
log_config = dict(interval=1)
""")
    return path


def test_cli_flags_as_in_jax(cli_cfg, tmp_path, monkeypatch, capsys):
    """--exp_name puts the work dir at ./work_dirs/NAME unless --work-dir is
    given; --deterministic runs the steps under deterministic algorithms,
    restores the setting after, and a second run repeats the first bit for
    bit; --autoscale-lr changes nothing but a log line; visual_config
    writes the grid on its interval."""
    import torch_train

    import pnp_vcve_torch.train.train_step as ts

    monkeypatch.chdir(tmp_path)
    seen, make = [], ts.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            seen.append(torch.are_deterministic_algorithms_enabled())
            return step(state, batch)
        return run

    monkeypatch.setattr(ts, "make_train_step", recording)
    base = [str(cli_cfg), "--device", "cpu", "--total-iters", "1"]
    torch_train.main(base + ["--exp_name", "a", "--deterministic"])
    assert seen == [True] and not torch.are_deterministic_algorithms_enabled()
    torch_train.main(base + ["--exp_name", "b", "--deterministic", "--autoscale-lr"])
    assert "--autoscale-lr is accepted and ignored" in capsys.readouterr().out
    a, b = (torch.load(tmp_path / "work_dirs" / n / "ckpt" / "1.pth", weights_only=True)
            for n in "ab")
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    torch_train.main(base + ["--exp_name", "c", "--work-dir", str(tmp_path / "w"),
                             "--cfg-options", "visual_config.interval=1"])
    assert seen == [True, True, False]
    assert not (tmp_path / "work_dirs" / "c").exists()
    assert (tmp_path / "w" / "ckpt" / "1.pth").exists()
    assert (tmp_path / "w" / "visual" / "iter_1.png").exists()
    assert len(list((tmp_path / "w" / "tb").iterdir())) == 1
