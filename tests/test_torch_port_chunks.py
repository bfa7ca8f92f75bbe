"""The chunk API of the port's PnPVCVE (``sweep``, ``carry``, ``bwd_feats``,
``keyframe_mask``; JAX pnp_vcve.py:430-444, 549-601), on the CPU in
float32 (the port runs its kernels' plain versions here).

An 8-frame clip runs as two chunks of 3 and 5 frames, the boundary not at a
keyframe: the backward sweep right to left, then the forward sweep left to
right, each chunk from the carry of the one before, the clip's keyframes
passed as ``keyframe_mask`` (as JAX's tests/test_seqpar_exact.py:38-66
drives it). Chunked equals the full clip within 2e-6 (the port against
itself, under 'padgather', 'pf' and vsr with the basic aligners) and JAX's
full clip within 1e-4 ('padgather'; the 'pf' model is held to JAX in
tests/test_torch_port_pf.py). JAX is imported inside the test that needs
it, so that the card test (marker ``cuda``) runs where JAX is absent:
``python -m pytest -m cuda --noconftest tests/test_torch_port_chunks.py``.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.models.pnp_vcve import keyframe_indices

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

T, SPLIT = 8, 3
SLICES = [73.0, 66.0, 80.0, 66.0, 66.0, 80.0, 66.0, 66.0]  # keyframes 0, 2, 5, 7 (forced)
MODELS = {
    "padgather": dict(mid_channels=8, num_blocks=2, num_experts=2),
    "pf": dict(mid_channels=64, num_blocks=2, num_experts=2, use_pallas_kernels=True,
               warp_impl="pf"),
    "vsr_basic": dict(mid_channels=8, num_blocks=1, num_experts=2, deform_groups=2, vsr=True,
                      deform="basic"),
}


def _inputs(seed, b=2, h=16, w=16, device="cpu"):
    """Clips of T frames, MVs constant over 8x8 blocks (up to +-12 px: the
    pf clamp bites)."""
    rng = np.random.default_rng(seed)
    mv = rng.uniform(-12.0, 12.0, (b, T, h // 8, w // 8, 4)).astype(np.float32)
    inp = dict(
        lrs=rng.random((b, T, h, w, 3), np.float32),
        qps=rng.random((b, T), np.float32),
        slices=np.array([SLICES, SLICES[::-1]], np.float32)[:b],
        mvs=np.repeat(np.repeat(mv, 8, 2), 8, 3),
        base_qps=np.full((b, T), 15.0 / 255.0, np.float32),
        par_map=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, T, h, w))] / 255.0,
    )
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in inp.items()}


def _chunked(model, inp, split=SPLIT):
    """The clip as chunks [0, split) and [split, T) through the chunk API."""
    km = keyframe_indices(inp["slices"])[0]

    def part(s, e):
        return {k: v[:, s:e] for k, v in inp.items()}

    left, right = part(0, split), part(split, T)
    feats_r, carry_b = model(**right, sweep="backward", keyframe_mask=km[:, split:])
    feats_l, _ = model(**left, sweep="backward", carry=carry_b, keyframe_mask=km[:, :split])
    ys_l, carry_f = model(**left, sweep="forward", bwd_feats=feats_l,
                          keyframe_mask=km[:, :split])
    ys_r, _ = model(**right, sweep="forward", carry=carry_f, bwd_feats=feats_r,
                    keyframe_mask=km[:, split:])
    return torch.cat([ys_l, ys_r], dim=1), (feats_l, carry_b, carry_f)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_chunked_equals_full(name):
    """Chunked within 2e-6 of the full clip; the backward features and the
    carries in the feature type at carry_feature_shape."""
    model = build_generator(dict(type="PnPVCVE", **MODELS[name], remat=False), device="cpu",
                            seed=3)
    if model.forward_deform_align is not None:  # offsets that move the samples
        gen = torch.Generator().manual_seed(4)
        for m in (model.backward_deform_align, model.forward_deform_align):
            with torch.no_grad():
                m.conv_offset[2].weight.copy_(torch.randn(m.conv_offset[2].weight.shape,
                                                          generator=gen) * 0.5)
    inp = _inputs(5)
    with torch.inference_mode():
        full = model(**inp)
        got, (feats, carry_b, carry_f) = _chunked(model, inp)
    torch.testing.assert_close(got, full, rtol=0, atol=2e-6)
    b, _, h, w, _ = inp["lrs"].shape
    shape = (b, *model.carry_feature_shape(h, w))
    assert feats.shape == (b, SPLIT, *shape[1:]) and feats.dtype == model.feature_dtype
    for carry in (carry_b, carry_f):
        assert carry[0].shape == carry[1].shape == shape and carry[2].dtype == torch.bool


def test_chunked_matches_jax_full():
    """'padgather' chunked within 1e-4 of JAX's full clip (JAX's weights
    from the port's through the reference's names)."""
    import jax
    import jax.numpy as jnp

    from pnp_vcve_tpu.core.convert import convert_generator_state_dict
    from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE

    cfg = MODELS["padgather"]
    model = build_generator(dict(type="PnPVCVE", **cfg, remat=False), device="cpu", seed=6)
    params = convert_generator_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, num_blocks=cfg["num_blocks"])
    inp = _inputs(7)
    jm = JaxPnPVCVE(**cfg, remat=False)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, **x))(
        params, {k: jnp.asarray(v.numpy()) for k, v in inp.items()}))
    with torch.inference_mode():
        got, _ = _chunked(model, inp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_chunk_features_keep_the_feature_type():
    """bfloat16 features: bwd_feats and the carries stay bfloat16, and the
    chunked clip equals the full one (the same roundings in the same
    order)."""
    model = build_generator(dict(type="PnPVCVE", **MODELS["padgather"], remat=False),
                            device="cpu", seed=8)
    model.feature_dtype = torch.bfloat16
    inp = _inputs(9, b=1)
    with torch.inference_mode():
        full = model(**inp)
        got, (feats, carry_b, carry_f) = _chunked(model, inp)
    assert feats.dtype == carry_b[0].dtype == carry_f[1].dtype == torch.bfloat16
    torch.testing.assert_close(got, full, rtol=0, atol=0)


def test_chunk_api_refusals():
    model = build_generator(dict(type="PnPVCVE", **MODELS["padgather"]), device="cpu")
    inp = _inputs(0, b=1)
    with pytest.raises(ValueError, match="requires bwd_feats"), torch.inference_mode():
        model(**inp, sweep="forward")
    with pytest.raises(ValueError, match="sweep must be"), torch.inference_mode():
        model(**inp, sweep="both")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["padgather", "pf"])
def test_chunked_equals_full_on_the_card(name):
    """On the card (the kernels): chunked within 1e-5 of the full clip in
    float32 at 64 channels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    cfg = {**MODELS[name], "mid_channels": 64}
    model = build_generator(dict(type="PnPVCVE", **cfg), device="cuda", seed=10)
    inp = _inputs(11, h=32, w=48, device="cuda")
    with torch.inference_mode():
        full = model(**inp)
        got, _ = _chunked(model, inp)
    assert float((got - full).abs().max()) <= 1e-5
