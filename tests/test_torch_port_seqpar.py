"""The port's exact two-sweep pipeline and clip stream
(pnp_vcve_torch/parallel/seqpar.py), the overlapped-window eval, the eval
harness's exact mode, and tools/torch_protocol_eval.py, on the CPU.

The pipeline runs over a device list; here every chunk's device is the CPU
(``devices=[cpu] * D``), which drives the same schedule, carries and chunk
inputs as distinct cards. The output must equal the port's full sweep bit
for bit (D = 1, 2, 4 under 'padgather' and 'pf'), and JAX's full
``PnPVCVE.apply`` on the same weights within 1e-4. JAX's own ``shard_map``
pipeline is not run here: tests/test_seqpar_exact.py holds it to JAX's full
sweep. Clips of t = 8 with the I/P/B slices of tests/test_seqpar_exact.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.models.restorer import Restorer
from pnp_vcve_torch.parallel import seqpar
from pnp_vcve_torch.parallel.seqpar import (
    enhance_clip_exact_pipeline,
    enhance_clips_exact_stream,
    largest_divisor_chunks,
)
from pnp_vcve_torch.train.eval import (
    enhance_clip,
    enhance_clip_frame_parallel,
    evaluate_dataset,
)
from pnp_vcve_torch.train.train_step import MODEL_INPUT_KEYS, make_eval_step

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, H, W = 8, 16, 16
SLICES = [
    [73.0, 66.0, 80.0, 66.0, 66.0, 80.0, 66.0, 66.0],
    [73.0, 80.0, 66.0, 66.0, 80.0, 66.0, 66.0, 80.0],
    [66.0] * 8,  # no keyframe but the forced first and last
]
MODELS = {
    "padgather": dict(mid_channels=8, num_blocks=2, num_experts=2),
    "pf": dict(mid_channels=64, num_blocks=1, num_experts=2, use_pallas_kernels=True,
               warp_impl="pf"),
}
CPU = torch.device("cpu")


def make_clip(rng, slices, h=H, w=W):
    """One clip, MVs constant over 8x8 blocks up to +-12 px, with a GT."""
    mv = rng.uniform(-12.0, 12.0, (T, h // 8, w // 8, 4)).astype(np.float32)
    return dict(
        lq=rng.random((T, h, w, 3), np.float32),
        gt=rng.random((T, h, w, 3), np.float32),
        qps=rng.random(T).astype(np.float32),
        slices=np.asarray(slices, np.float32),
        mvs=np.repeat(np.repeat(mv, 8, 1), 8, 2),
        base_qps=np.full(T, 15.0 / 255.0, np.float32),
        partitions=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T, h, w))] / 255.0,
    )


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    return [make_clip(rng, s) for s in SLICES]


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_and_full(request, clips):
    """A seeded generator and its full sweep of each clip."""
    model = build_generator(dict(type="PnPVCVE", **MODELS[request.param], remat=False),
                            device="cpu", seed=1)
    step = make_eval_step(model)
    return model, [step({k: c[k][None] for k in MODEL_INPUT_KEYS})[0] for c in clips]


@pytest.mark.parametrize("D", [1, 2, 4])
def test_pipeline_bitwise_equals_full_sweep(model_and_full, clips, D):
    model, full = model_and_full
    for clip, want in zip(clips, full):
        np.testing.assert_array_equal(enhance_clip_exact_pipeline(model, clip, [CPU] * D), want)


def test_stream_bitwise_equals_per_clip_pipelines(model_and_full, clips):
    """B = 3 clips through D = 2; and the corners B = 1 with D = t (one frame
    a chunk)."""
    model, full = model_and_full
    streamed = enhance_clips_exact_stream(model, clips, [CPU] * 2)
    assert len(streamed) == 3
    for clip, got, want in zip(clips, streamed, full):
        np.testing.assert_array_equal(got, enhance_clip_exact_pipeline(model, clip, [CPU] * 2))
        np.testing.assert_array_equal(got, want)
    (one,) = enhance_clips_exact_stream(model, clips[:1], [CPU] * T)
    np.testing.assert_array_equal(one, full[0])


def test_pipeline_refusals(model_and_full, clips):
    model, _ = model_and_full
    with pytest.raises(ValueError, match="not divisible"):
        enhance_clip_exact_pipeline(model, clips[0], [CPU] * 3)
    odd = dict(clips[1], lq=clips[1]["lq"][:, :8])
    with pytest.raises(ValueError, match="one shape"):
        enhance_clips_exact_stream(model, [clips[0], odd], [CPU] * 2)


def test_pipeline_bfloat16_features(clips):
    """feature_dtype=bfloat16: the stream in bf16 equals the generator's own
    bf16 full sweep, and the generator keeps its float32 type afterwards."""
    model = build_generator(dict(type="PnPVCVE", **MODELS["padgather"], remat=False),
                            device="cpu", seed=2)
    got = enhance_clips_exact_stream(model, clips[:2], [CPU] * 4, feature_dtype=torch.bfloat16)
    assert model.feature_dtype == torch.float32
    model.feature_dtype = torch.bfloat16
    step = make_eval_step(model)
    for clip, g in zip(clips, got):
        np.testing.assert_array_equal(g, step({k: clip[k][None] for k in MODEL_INPUT_KEYS})[0])


def _jax_twin(model, cfg):
    """JAX's PnPVCVE and params on the port's weights (reference names)."""
    from pnp_vcve_tpu.core.convert import convert_generator_state_dict
    from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE

    params = convert_generator_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, num_blocks=cfg["num_blocks"])
    return JaxPnPVCVE(**cfg, remat=False), params


def test_pipeline_matches_jax_full_and_chunked_inputs(clips):
    """D = 2 within 1e-4 of JAX's full PnPVCVE.apply; every chunk of
    ``_chunked_inputs`` (the keyframe mask too) equal to JAX's."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.parallel import seqpar as jax_seqpar

    cfg = MODELS["padgather"]
    model = build_generator(dict(type="PnPVCVE", **cfg, remat=False), device="cpu", seed=3)
    jm, params = _jax_twin(model, cfg)
    clip = clips[0]
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, **x))(
        params, {k: jnp.asarray(v[None]) for k, v in dict(
            lrs=clip["lq"], qps=clip["qps"], slices=clip["slices"], mvs=clip["mvs"],
            base_qps=clip["base_qps"], par_map=clip["partitions"]).items()}))[0]
    np.testing.assert_allclose(enhance_clip_exact_pipeline(model, clip, [CPU] * 2), want,
                               atol=1e-4, rtol=0)
    for c in clips:
        for D in (2, 4, 8):
            ours, theirs = seqpar._chunked_inputs(c, D), jax_seqpar._chunked_inputs(c, D)
            assert sorted(ours) == sorted(theirs)
            for k in ours:
                np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    for t in range(1, 13):
        for m in range(1, 9):
            assert largest_divisor_chunks(t, m) == jax_seqpar.largest_divisor_chunks(t, m)


def test_frame_parallel_halo_matches_jax(clips):
    """The overlapped windows at halo_t 0 and 2 over two devices within 1e-4
    of JAX's enhance_clip_frame_parallel on a 2-device mesh; halo_t = 0
    within 1e-6 of enhance_clip(chunk_t) (the windows batched two at a
    time there, one at a time here)."""
    import jax

    from pnp_vcve_tpu.parallel.sharding import make_mesh
    from pnp_vcve_tpu.train.eval import enhance_clip_frame_parallel as jax_halo
    from pnp_vcve_tpu.train.train_step import make_eval_step as jax_eval_step

    cfg = MODELS["padgather"]
    model = build_generator(dict(type="PnPVCVE", **cfg, remat=False), device="cpu", seed=4)
    jm, params = _jax_twin(model, cfg)
    mesh = make_mesh(devices=jax.devices()[:2])
    step = jax_eval_step(jm)
    clip = clips[1]
    for halo in (0, 2):
        got = enhance_clip_frame_parallel(model, clip, [CPU] * 2, chunk_t=4, halo_t=halo)
        assert got.shape == (T, H, W, 3)
        np.testing.assert_allclose(got, jax_halo(step, params, clip, mesh, chunk_t=4,
                                                 halo_t=halo), atol=1e-4, rtol=0)
        if halo == 0:
            np.testing.assert_allclose(
                got, enhance_clip(make_eval_step(model), clip, chunk_t=4), atol=1e-6, rtol=0)
    # a window list padded to the device count: 3 windows of 3 frames on 2
    got = enhance_clip_frame_parallel(model, clip, [CPU] * 2, chunk_t=3, halo_t=1)
    np.testing.assert_allclose(got, jax_halo(step, params, clip, mesh, chunk_t=3, halo_t=1),
                               atol=1e-4, rtol=0)


def test_evaluate_dataset_exact_stream_equals_plain(clips, tmp_path):
    """evaluate_dataset(frame_parallel='exact', stream_clips=2) over three
    clips (two same-shape, then one of another shape: a flush before it)
    gives the plain path's metrics and PNGs exactly; so does the cascade
    into a BasicVSR++ after each mode (its offset heads seeded non-zero)."""
    model = build_generator(dict(type="PnPVCVE", **MODELS["padgather"], remat=False),
                            device="cpu", seed=5)
    restorer = Restorer(generator=model, test_cfg=dict(metrics=["PSNR", "SSIM"], crop_border=0))
    wide = make_clip(np.random.default_rng(9), SLICES[2], w=24)
    data = [dict(c, clip_name=f"{i:03d}") for i, c in enumerate([clips[0], clips[1], wide])]
    plain = evaluate_dataset(restorer, data, save_path=str(tmp_path / "a"), save_image=True,
                             verbose=False)
    exact = evaluate_dataset(restorer, data, save_path=str(tmp_path / "b"), save_image=True,
                             verbose=False, frame_parallel="exact", stream_clips=2,
                             devices=[CPU] * 4)
    assert exact == plain and set(plain) == {"PSNR", "SSIM"}
    pngs = sorted((tmp_path / "a").glob("*/*.png"))
    assert len(pngs) == 3 * T
    for p in pngs:
        assert p.read_bytes() == (tmp_path / "b" / p.parent.name / p.name).read_bytes()
    vsr = build_generator(dict(type="BasicVSRPlusPlus", mid_channels=8, num_blocks=1,
                               deform_groups=2, is_low_res_input=False), device="cpu", seed=6)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for align in vsr.deform_align.values():
            w = align.conv_offset[6].weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
    cascade = (vsr, Restorer(generator=vsr))
    plain_c = evaluate_dataset(restorer, data, verbose=False, cascade=cascade)
    exact_c = evaluate_dataset(restorer, data, verbose=False, cascade=cascade,
                               frame_parallel="exact", stream_clips=2, devices=[CPU] * 4)
    assert exact_c == plain_c and plain_c != plain


def test_protocol_eval_tool_both_legs(tmp_path):
    """tools/torch_protocol_eval.py at a tiny geometry on the CPU: the card
    leg (full context and chunked, its metric delta) and the exact leg (the
    whole-clip run against --frame-parallel exact --stream-clips 2 through
    tools/torch_test.py, bitwise PNGs and equal metrics)."""
    sys.path.insert(0, str(REPO / "tools"))
    import torch_protocol_eval

    out = tmp_path / "protocol.json"
    art = torch_protocol_eval.main([
        "--device", "cpu", "--root", str(tmp_path / "fx"), "--frames", "6", "--height", "32",
        "--width", "48", "--clips", "000,011", "--chunk-t", "3", "--exact-mid", "8",
        "--exact-blocks", "1", "--exact-experts", "2", "--pipeline-devices", "cpu,cpu",
        "--out", str(out)])
    card, exact = art["card"], art["exact"]
    assert set(card["full_context"]["per_clip"]) == {"000", "011"}
    assert card["chunked"]["chunk_t"] == 3
    assert np.isfinite(card["delta_mean"]["PSNR"]) and card["frames_per_second"]["full_context"] > 0
    assert exact["cross_check"]["frames_compared"] == 2 * 6
    assert exact["cross_check"]["max_uint8_diff"] == 0 and exact["metrics_equal"]
    assert out.exists()
