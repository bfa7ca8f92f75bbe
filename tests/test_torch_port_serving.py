"""The port's batch-of-streams serving (pnp_vcve_torch.serving), its inference
APIs (pnp_vcve_torch.apis), the servable packager and the HTTP handler, on
the CPU at a tiny size (8 channels, 1 block, 2 experts; the kernels' plain
versions run here).

The scheduler cases are those of tests/test_serving_scheduler.py (ordering,
same-shape batching, the latency bound, errors, concurrent clients) on the
port; the executor and the video API are held to the JAX package's on the
same weights (carried through ``pnp_vcve_tpu.core.convert``) within 1e-4.
"""

import io
import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_torch import apis
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.serving import (
    StreamScheduler,
    batched_forward_executor,
    exact_stream_executor,
)
from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(mid_channels=8, num_blocks=1, num_experts=2)
TINY_CFG = dict(
    model=dict(type="BasicVSR", generator=dict(
        type="IconVSR_restore_wo_refill_mv_ipb_fast_domain_dynamic_with_par", **TINY)),
    test_cfg=dict(metrics=["PSNR", "SSIM"], crop_border=0),
)


def make_sample(rng, t, h, w):
    slices = np.full((t,), 66.0, np.float32)
    slices[0] = 73.0
    mvs_blk = (rng.standard_normal((t, h // 8, w // 8, 4)) * 3).astype(np.float32)
    return dict(
        lq=rng.random((t, h, w, 3)).astype(np.float32),
        gt=rng.random((t, h, w, 3)).astype(np.float32),
        qps=rng.random((t,)).astype(np.float32),
        slices=slices,
        mvs=np.repeat(np.repeat(mvs_blk, 8, axis=1), 8, axis=2),
        base_qps=np.full((t,), 15.0 / 255.0, np.float32),
        partitions=(rng.random((t, h, w, 3)) > 0.5).astype(np.float32) / 255.0,
    )


@pytest.fixture(scope="module")
def tiny():
    return build_generator(dict(type="PnPVCVE", **TINY, remat=False), device="cpu", seed=0)


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return convert_generator_state_dict(sd, num_blocks=TINY["num_blocks"])


# ---- the scheduler and the executors ------------------------------------------------------


def test_batched_executor_matches_sequential_and_jax(tiny):
    """B clips stacked on the batch axis equal B independent forwards, and
    JAX's batched_forward_executor on the same weights within 1e-4."""
    from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
    from pnp_vcve_tpu.serving import batched_forward_executor as jax_executor

    rng = np.random.default_rng(1)
    samples = [make_sample(rng, 4, 16, 16) for _ in range(3)]
    outs = batched_forward_executor(tiny)(samples)
    eval_step = make_eval_step(tiny)
    for s, o in zip(samples, outs):
        want = eval_step({k: np.asarray(s[k])[None] for k in MODEL_INPUT_KEYS})[0]
        np.testing.assert_allclose(o, want, atol=2e-6, rtol=1e-5)
    jax_outs = jax_executor(JaxPnPVCVE(**TINY, remat=False), _jax_params(tiny))(samples)
    for o, want in zip(outs, jax_outs):
        np.testing.assert_allclose(o, want, atol=1e-4, rtol=0)


def test_scheduler_orders_and_batches(tiny):
    rng = np.random.default_rng(2)
    sched = StreamScheduler(batched_forward_executor(tiny), max_batch=2, max_wait_s=0.2)
    # two streams, two shapes: same-shape clips of different streams batch
    # together, shapes never mix
    tickets = []
    for i in range(3):
        tickets.append(("a", i, sched.submit("a", make_sample(rng, 4, 16, 16))))
        tickets.append(("b", i, sched.submit("b", make_sample(rng, 4, 8, 16))))
    sched.close(drain=True)
    done = {}
    for sid, i, t in tickets:
        out = t.wait(timeout=60)
        assert t.seq == i
        assert out.shape[0] == 4
        done.setdefault(sid, []).append((i, t.done_at))
    for sid, seq_done in done.items():  # per-stream FIFO
        times = [d for _, d in sorted(seq_done)]
        assert times == sorted(times), f"stream {sid} completed out of order"
    st = sched.stats()
    assert st["clips"] == 6
    assert len(st["dispatches"]) < 6
    assert all(d["batch"] <= 2 for d in st["dispatches"])
    assert {d["shape"] for d in st["dispatches"]} == {(4, 16, 16, 3), (4, 8, 16, 3)}
    assert st["mean_latency_s"] > 0


def test_scheduler_latency_bound_flushes_partial_batch(tiny):
    """A lone clip does not wait for a full batch: max_wait_s dispatches it."""
    sched = StreamScheduler(batched_forward_executor(tiny), max_batch=4, max_wait_s=0.05)
    t = sched.submit("solo", make_sample(np.random.default_rng(3), 4, 16, 16))
    assert t.wait(timeout=60).shape == (4, 16, 16, 3)
    assert t.dispatched_batch == 1
    sched.close()


def test_scheduler_propagates_executor_errors():
    def boom(samples):
        raise RuntimeError("device on fire")

    sched = StreamScheduler(boom, max_batch=1, max_wait_s=0.01)
    t = sched.submit("s", dict(lq=np.zeros((2, 8, 8, 3), np.float32)))
    with pytest.raises(RuntimeError, match="device on fire"):
        t.wait(timeout=30)
    sched.close()


def test_scheduler_concurrent_submitters(tiny):
    """Threaded clients submitting at once: everything completes, each
    stream in order, and no forward records a graph, though the submitting
    threads have grad mode on (the dispatcher's executor holds inference
    mode on its own thread)."""
    graphs = []
    hook = tiny.register_forward_hook(lambda m, a, out: graphs.append(out.requires_grad))
    sched = StreamScheduler(batched_forward_executor(tiny), max_batch=3, max_wait_s=0.02)
    results = {}

    def client(i):
        rng = np.random.default_rng(10 + i)
        ts = [sched.submit(f"c{i}", make_sample(rng, 4, 16, 16)) for _ in range(3)]
        results[i] = [(t.seq, t.wait(timeout=120).shape) for t in ts]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    sched.close()
    hook.remove()
    assert results == {i: [(s, (4, 16, 16, 3)) for s in range(3)] for i in range(3)}
    assert graphs and not any(graphs)


def test_exact_stream_executor_not_ported(tiny):
    """The exact pipeline's executor behind the scheduler (two chunks on the
    CPU): dispatches of 1 and of 2 clips, each clip bitwise equal to its
    own full sweep."""
    rng = np.random.default_rng(8)
    samples = [make_sample(rng, 4, 16, 16) for _ in range(3)]
    sched = StreamScheduler(exact_stream_executor(tiny, ["cpu", "cpu"]), max_batch=2,
                            max_wait_s=0.5)
    tickets = [sched.submit("a", samples[0]), sched.submit("a", samples[1])]
    outs = [t.wait(60) for t in tickets]
    tickets.append(sched.submit("b", samples[2]))
    outs.append(tickets[-1].wait(60))
    sched.close()
    assert sorted(t.dispatched_batch for t in tickets) == [1, 2, 2]
    eval_step = make_eval_step(tiny)
    for s, o in zip(samples, outs):
        np.testing.assert_array_equal(
            o, eval_step({k: np.asarray(s[k])[None] for k in MODEL_INPUT_KEYS})[0])


# ---- the APIs ---------------------------------------------------------------------------------


def _write_tiny_cfg(path):
    path.write_text("".join(f"{k} = {v!r}\n" for k, v in TINY_CFG.items()))
    return path


def test_init_model_from_dict_and_file(tmp_path, tiny):
    """A dict and a file give the same generator; a checkpoint loads; the
    card is refused without a card and unported kinds name their item."""
    sd_path = tmp_path / "w.pth"
    torch.save(tiny.state_dict(), sd_path)
    a = apis.init_model(TINY_CFG, str(sd_path), device="cpu")
    b = apis.init_model(str(_write_tiny_cfg(tmp_path / "tiny.py")), str(sd_path), device="cpu")
    assert a.device.type == b.device.type == "cpu"
    for k, v in tiny.state_dict().items():
        torch.testing.assert_close(a.generator.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(b.generator.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        apis.init_model(dict(model=dict(type="DIM", backbone=dict())), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            apis.init_model(TINY_CFG)


def test_seed_helpers():
    assert apis.init_random_seed(7) == 7
    assert 0 <= apis.init_random_seed() < 2**31
    draws = []
    for _ in range(2):
        apis.set_random_seed(3)
        draws.append((np.random.rand(3), torch.rand(3)))
    np.testing.assert_array_equal(draws[0][0], draws[1][0])
    torch.testing.assert_close(draws[0][1], draws[1][1], rtol=0, atol=0)


@pytest.fixture(scope="module")
def sidecar_clip(tmp_path_factory):
    """One clip of 4 PNG frames at 32x48 under crf25/png/000 with MV record
    sidecars (16x16 and 8x8 blocks, forward and backward, an I/P/B/P slice
    pattern) and a qp.json."""
    root = tmp_path_factory.mktemp("sidecars")
    rng = np.random.default_rng(4)
    png, mv = root / "crf25" / "png" / "000", root / "crf25" / "mv" / "000"
    png.mkdir(parents=True)
    mv.mkdir(parents=True)
    slices = "IPBP"
    entries = {}
    for i, st in enumerate(slices):
        Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)).save(
            png / f"{i:08d}.png")
        recs = []
        if st != "I":
            for y in (8, 24):
                for x in (8, 24, 40):
                    recs.append([-1, 16, 16, x, y, x, y, *rng.integers(-40, 40, 2), 4])
            recs.append([1, 8, 8, 12, 12, 12, 12, *rng.integers(-40, 40, 2), 4])
        np.save(mv / f"{i:08d}.npy", np.asarray(recs, np.float32).reshape(-1, 10))
        entries[str(i)] = {"QP": float(20 + i), "slice": st}
    (root / "qp.json").write_text(json.dumps({"crf25": {"000": entries}}))
    return root


def test_restoration_video_inference_matches_jax(sidecar_clip, tiny):
    """The MV sidecars, QP/slice JSON and max_seq_len chunking give the JAX
    package's restoration_video_inference result on the same weights within
    1e-4."""
    from pnp_vcve_tpu import apis as japis

    jm = japis.init_model(TINY_CFG)
    jm.variables = {"params": _jax_params(tiny)}
    model = apis.init_model(TINY_CFG, device="cpu")
    model.generator.load_state_dict(tiny.state_dict())
    kw = dict(img_dir=str(sidecar_clip / "crf25" / "png" / "000"),
              mv_dir=str(sidecar_clip / "crf25" / "mv" / "000"),
              qp_slice_file=str(sidecar_clip / "qp.json"))
    for max_seq_len in (None, 2):
        got = apis.restoration_video_inference(model, max_seq_len=max_seq_len, **kw)
        want = np.asarray(japis.restoration_video_inference(jm, max_seq_len=max_seq_len, **kw))
        assert got.shape == (4, 32, 48, 3)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---- the packager and the handler --------------------------------------------------------------


def _tool(name):
    sys.path.insert(0, str(REPO / "tools"))
    return __import__(name)


def test_packager_layout_and_refusal(tmp_path, tiny):
    from pnp_vcve_torch.core.config import Config

    pack = _tool("torch_pnp2servable").pnp2servable
    cfg = REPO / "pnp_vcve_torch" / "configs" / "HR_davis_LR_128x128_serving.py"
    sd_path = tmp_path / "w.pth"
    torch.save(tiny.state_dict(), sd_path)
    out = pack(str(cfg), str(sd_path), str(tmp_path / "srv"), model_name="pnp")
    assert sorted(p.name for p in out.iterdir()) == ["MANIFEST.json", "config.py", "weights.pth"]
    manifest = json.loads((out / "MANIFEST.json").read_text())
    assert manifest["model"] == {"modelName": "pnp", "modelVersion": "1.0",
                                 "configFile": "config.py", "serializedFile": "weights.pth"}
    # frozen: no _base_ chain left, the same merged config
    assert not any(line.startswith("_base_")
                   for line in (out / "config.py").read_text().splitlines())
    assert Config.fromfile(out / "config.py").to_dict() == Config.fromfile(cfg).to_dict()
    for k, v in torch.load(out / "weights.pth", weights_only=True).items():
        torch.testing.assert_close(v, tiny.state_dict()[k], rtol=0, atol=0)
    with pytest.raises(FileExistsError, match="--force"):
        pack(str(cfg), str(sd_path), str(tmp_path / "srv"), model_name="pnp")
    out = pack(str(cfg), "-", str(tmp_path / "srv"), model_name="pnp", force=True)
    assert json.loads((out / "MANIFEST.json").read_text())["model"]["serializedFile"] is None
    assert not (out / "weights.pth").exists()


def test_handler_round_trip(tmp_path, tiny):
    """Pack a tiny servable, serve it on port 0: a POSTed PNG comes back as
    the PNG of apis.restoration_inference on the same frame; /ping answers;
    an unknown model is a 404."""
    handler_mod = _tool("torch_serving_handler")
    sd_path = tmp_path / "w.pth"
    torch.save(tiny.state_dict(), sd_path)
    out = _tool("torch_pnp2servable").pnp2servable(
        str(_write_tiny_cfg(tmp_path / "tiny.py")), str(sd_path), str(tmp_path / "srv"),
        model_name="tiny")
    h = handler_mod.PnPServingHandler()
    h.initialize(out, device="cpu")
    srv, port = handler_mod.serve_background(h, 0)
    try:
        frame = np.random.default_rng(5).integers(0, 256, (24, 40, 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predictions/tiny",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            got = np.asarray(Image.open(io.BytesIO(r.read())))
        from pnp_vcve_torch.metrics import tensor2img

        want = tensor2img(apis.restoration_inference(h.model, frame))
        np.testing.assert_array_equal(got, want)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/ping", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "Healthy"}
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/predictions/other", data=b"x", method="POST"),
                timeout=30)
    finally:
        srv.shutdown()
        srv.server_close()


def test_kernel_bounds_tool(capsys):
    """tools/torch_kernel_bounds.py: a bound for each B10 TPU probe (B8 and
    B9 are K3 and K5, whose bounds chip_smoke.py computes), counted as the
    Hopper kernel that ports it does the work: probe_floor moves its 720p
    bf16 window in and out (K6); probe_select (K11) and probe_dma (K12) read
    the distinct input pixels their seeded tables pick (847,728 and 841,168
    of the padded input's 1,021,440: neighbouring taps and windows overlap);
    each bound by the bytes."""
    rows = _tool("torch_kernel_bounds").main()
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["bounds"] == rows
    assert {r["item"] for r in rows} == {"B10"}
    by_fn = {r["function"].split()[1]: r for r in rows}
    assert {"probe_floor", "probe_select", "probe_dma", "probe_floor128", "probe_mmsel"} <= set(by_fn)
    assert not {"drt_block_packed", "conv3x3_pallas", "drt_block_pallas", "conv3x3_packed",
                "conv3x3_packed_v2"} & set(by_fn)
    floor = by_fn["probe_floor"]
    assert floor["bytes"] == (720 * 1280 * 64 + 720 * 1280 * 64) * 2
    assert floor["bound_by"] == "bytes"
    assert abs(floor["bound_ms"] - floor["bytes"] / 3.35e12 * 1e3) < 1e-9
    assert by_fn["probe_select"]["bytes"] == ((847728 + 720 * 1280) * 64 * 2
                                              + 6 * 90 * 1280 * 4)
    assert by_fn["probe_dma"]["bytes"] == 841168 * 64 * 2 + 14400 * (64 * 64 * 2 + 2 * 4)
    assert {by_fn[f]["bound_by"] for f in ("probe_select", "probe_dma")} == {"bytes"}
    assert all(r["port"] for r in rows)  # every B10 probe has its Hopper kernel
    assert all(r["bound_ms"] == max(r["bytes_ms"], r["ops_ms"]) > 0 for r in rows)
