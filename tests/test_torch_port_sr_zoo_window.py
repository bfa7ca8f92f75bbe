"""The port's window and single-image super-resolution models against the
JAX package on the CPU: EDVR, IconVSR at padding 3 (EDVR-M's 7-frame
refill windows), TDAN and TOFlow (forward, and EDVR and TOFlow
through ``restoration_video_inference``'s sliding window; TDAN's pair
refused by the API as JAX fails on it), EDSR, RRDBNet, MSRResNet, SRCNN and
RDN (forward and through ``restoration_inference``), and
``resize_bicubic`` enlarging. The weights, sizes and helpers are
tests/test_torch_port_sr_zoo.py's.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_port_sr_zoo import (  # noqa: F401  (the fixtures)
    SISR,
    SMALL,
    _api_models,
    _check_model,
    _close,
    _jax_ops_traced_once,
    _t,
    clip_dir,
)

from pnp_vcve_torch.core.builder import build_generator

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)


def test_iconvsr_padding3_matches_jax():
    """IconVSR at padding 3 (stride 5: keyframes 0 and 4) on 5 frames at
    20x28, fewer than the mirrored padding's 7: JAX gathers the end frames
    with clamped indices, and so does the port; within 1e-4."""
    _check_model("iconvsr", padding=3, keyframe_stride=5)


@pytest.mark.parametrize("name,over", [
    ("edvr", {}), ("tdan", {}), ("toflow", {}), ("toflow", dict(adapt_official_weights=True)),
    ("edsr", {}), ("edsr", dict(upscale_factor=3, res_scale=0.1)), ("rrdb", {}),
    ("rrdb", dict(upscale_factor=2)), ("rrdb", dict(upscale_factor=1)), ("msr", {}),
    ("srcnn", {}), ("rdn", {}),
], ids=lambda v: "-".join(f"{k}{x}" for k, x in v.items()) if isinstance(v, dict) else v)
def test_model_matches_jax(name, over):
    """Each model carried by its core/convert.py function: forward within
    1e-4 of JAX at 20x28. EDVR's pyramid quarter level is an odd 5x7, so
    TSA's second pools and its resize back are uneven (h / 2 is even on any
    side EDVR takes), and its offset heads are not zero; TDAN's pair (the x4
    frame and the aligned LR frames); TOFlow with and without the official
    weights' frame order; RRDBNet at x4, x2 and x1 (pixel-unshuffled in
    JAX's channel order); SRCNN's bicubic x4 at 20x28."""
    _check_model(name, **over)


def test_resize_bicubic_upscale_matches_jax():
    """``ops/resize.py: resize_bicubic`` enlarging x4 (and by 3 and 5) at
    odd sizes against ``jax.image.resize(.., 'bicubic')`` within 1e-5."""
    from pnp_vcve_torch.ops.resize import resize_bicubic

    x = np.random.default_rng(4).random((2, 7, 9, 3), np.float32)
    for size in ((28, 36), (21, 45)):
        want = jax.image.resize(x, (2, *size, 3), "bicubic")
        _close(resize_bicubic(_t(x), size), want, 1e-5)


def test_window_models_refuse_other_shapes():
    """EDVR refuses sides that are not multiples of 4 (JAX fails there);
    TOFlow and TDAN refuse windows of another length."""
    models = {n: build_generator(dict(type=SMALL[n][0], **SMALL[n][1]), device="cpu")
              for n in ("edvr", "tdan", "toflow")}
    with torch.inference_mode():
        with pytest.raises(ValueError, match="multiples of 4"):
            models["edvr"](torch.zeros(1, 5, 18, 16, 3))
        with pytest.raises(ValueError, match="windows of 5"):
            models["tdan"](torch.zeros(1, 3, 16, 16, 3))
        with pytest.raises(ValueError, match="windows of 7"):
            models["toflow"](torch.zeros(1, 5, 16, 16, 3))


@pytest.mark.parametrize("name,window", [("edvr", 5), ("toflow", 7)])
def test_video_inference_sliding_window_matches_jax(clip_dir, name, window):
    """``restoration_video_inference(window_size=5 / 7)`` with EDVR and
    TOFlow on a 5-frame PNG clip (reflect-padded at both ends): each frame
    within 1e-4 of JAX's function on the same weights."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    jmodel, model = _api_models(name)
    want = japis.restoration_video_inference(jmodel, clip_dir, window_size=window)
    got = apis.restoration_video_inference(model, clip_dir, window_size=window)
    lq = apis._read_frame_dir(clip_dir, "{:08d}.png", 0)
    scale = 1 if name == "toflow" else 4
    assert got.shape == (5, scale * lq.shape[1], scale * lq.shape[2], 3)
    _close(got, want)


@pytest.mark.parametrize("kwargs", [dict(window_size=5), {}])
def test_video_inference_refuses_tdan_as_jax_fails(clip_dir, kwargs):
    """TDAN returns ``(hr, aligned_lrs)``: JAX's function raises a
    ValueError on the pair (``np.asarray`` of two shapes), in the window
    branch and over the whole clip; the port raises a ValueError that names
    the pair."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    jmodel, model = _api_models("tdan")
    with pytest.raises(ValueError):
        japis.restoration_video_inference(jmodel, clip_dir, **kwargs)
    with pytest.raises(ValueError, match="returns 2 outputs"):
        apis.restoration_video_inference(model, clip_dir, **kwargs)


@pytest.mark.parametrize("name", SISR)
def test_restoration_inference_matches_jax(clip_dir, name):
    """``restoration_inference`` of each single-image model on a PNG: within
    1e-4 of JAX's function (the x4 output clipped to [0, 1])."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    jmodel, model = _api_models(name)
    png = f"{clip_dir}/00000002.png"
    want = japis.restoration_inference(jmodel, png)
    got = apis.restoration_inference(model, png)
    assert got.shape == want.shape and got.min() >= 0.0 and got.max() <= 1.0
    _close(got, want)


def test_restoration_inference_refuses_a_clip_model(clip_dir):
    """A video model on one image: JAX raises a ValueError (its 5-D input
    unpacked from 4); the port raises one that points at the video
    function."""
    from pnp_vcve_tpu import apis as japis
    from pnp_vcve_torch import apis

    jmodel, model = _api_models("edvr")
    png = f"{clip_dir}/00000000.png"
    with pytest.raises(ValueError):
        japis.restoration_inference(jmodel, png)
    with pytest.raises(ValueError, match="restoration_video_inference"):
        apis.restoration_inference(model, png)
