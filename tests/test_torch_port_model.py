"""The port's PnPVCVE against the JAX package's, and the recorded reference
parity fixture through the port, on the CPU in float32 (the port runs its
kernels' plain versions here).

Weights are drawn by the port, carried to the JAX side through
``pnp_vcve_tpu.core.convert`` (the reference names are the common ground),
and inputs come from numpy generators.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.core.checkpoint import load_generator_weights, read_state_dict
from pnp_vcve_torch.core.convert import from_jax_params

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "parity"
SMALL = dict(mid_channels=16, num_blocks=2, num_experts=3)


def _jax_params(model):
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return convert_generator_state_dict(sd, num_blocks=SMALL["num_blocks"])


def _inputs(rng, b, t, h, w, slices):
    return dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.asarray(slices, np.float32),
        mvs=rng.uniform(-6.0, 6.0, (b, t, h, w, 4)).astype(np.float32),
        base_qps=np.full((b, t), 25 / 255.0, np.float32),
        par_map=(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h, w))] / 255.0),
    )


VARIANTS = {
    # 30 x 46 needs the x4 pad (reflect lrs, zero priors, cropped output)
    "pad": dict(t=5, h=30, w=46, mirror=False,
                slices=[[73, 66, 66, 66, 66], [73, 66, 66, 66, 66]]),
    # frames i and t-1-i equal; the forward sweep takes the mirrored flows.
    # The JAX flow layout runs only t=2 (ROADMAP Queue C)
    "mirror": dict(t=2, h=16, w=24, mirror=True, slices=[[73, 66], [66, 66]]),
    # I/P/B patterns where prev_was_key flips, key frames mid-clip
    "ipb": dict(t=5, h=16, w=24, mirror=False,
                slices=[[73, 66, 80, 66, 66], [66, 80, 66, 80, 66]]),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_jax(variant):
    v = VARIANTS[variant]
    rng = np.random.default_rng(3)
    model = build_generator(dict(type="PnPVCVE", **SMALL), device="cpu", seed=5)
    inp = _inputs(rng, 2, v["t"], v["h"], v["w"], v["slices"])
    if v["mirror"]:
        t = v["t"]
        for k in ("lrs", "par_map"):
            inp[k][:, t // 2:] = inp[k][:, : t // 2][:, ::-1]

    jm = JaxPnPVCVE(**SMALL, remat=False)
    apply = jax.jit(lambda p, x: jm.apply({"params": p}, **x, is_mirror_extended=v["mirror"]))
    want = np.asarray(apply(_jax_params(model), {k: jnp.asarray(a) for k, a in inp.items()}))
    with torch.inference_mode():
        got = model(**{k: torch.from_numpy(a) for k, a in inp.items()},
                    is_mirror_extended=v["mirror"]).numpy()
    assert got.shape == (2, v["t"], v["h"], v["w"], 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_mirror_longer_than_two_frames_refused():
    model = build_generator(dict(type="PnPVCVE", **SMALL), device="cpu")
    inp = _inputs(np.random.default_rng(0), 1, 4, 8, 8, [[73, 66, 66, 73]])
    with pytest.raises(NotImplementedError, match="Queue C"):
        model(**{k: torch.from_numpy(a) for k, a in inp.items()}, is_mirror_extended=True)


def test_weights_round_trip_exact():
    """JAX params -> from_jax_params -> convert_generator_state_dict gives the
    same params bit for bit, and the state dict loads strictly."""
    model = build_generator(dict(type="PnPVCVE", **SMALL), device="cpu", seed=1)
    params = _jax_params(model)
    sd = from_jax_params(params)
    model.load_state_dict(sd, strict=True)
    back = convert_generator_state_dict({k: v.numpy() for k, v in sd.items()},
                                        num_blocks=SMALL["num_blocks"])
    a = jax.tree_util.tree_leaves_with_path(params)
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(a) == len(b)
    for path, leaf in a:
        np.testing.assert_array_equal(b[path], leaf)


def _fixture_clip(tmp_path, spec):
    from pnp_vcve_torch.core.presets import flagship_data
    from pnp_vcve_torch.core.builder import build_dataset
    from tools.record_parity_fixture import build_dataset_from_spec

    build_dataset_from_spec(spec, str(tmp_path))
    cfg = dict(flagship_data(
        test_lq=f"{tmp_path}/crf35/png", test_gt=f"{tmp_path}/sharp/png",
        test_qp_json=f"{tmp_path}/qp.json",
    )["test"])
    cfg["num_input_frames"] = spec["frames"]
    return build_dataset(cfg).load_clip(0)


def _gate(sd, spec, meta, sample):
    """The fixture gate's checks (tools/parity_check.py:47-49) -> failures."""
    from pnp_vcve_torch.models.restorer import Restorer
    from pnp_vcve_torch.train.eval import enhance_clip
    from pnp_vcve_torch.train.train_step import make_eval_step

    model = build_generator(
        dict(type="PnPVCVE", mid_channels=spec["mid_channels"],
             num_blocks=spec["num_blocks"], num_experts=spec["num_experts"]),
        device="cpu",
    )
    model.load_state_dict(sd, strict=True)
    out = enhance_clip(make_eval_step(model), sample)
    name = sample["clip_name"]
    want = np.load(FIXTURE / "expected.npz")[name].astype(np.float32)
    m = Restorer(model).evaluate_clip(out, sample["gt"])
    rec = meta["per_clip_metrics"][name]
    fails = []
    if np.abs(out - want).max() > 2e-3:
        fails.append(f"out diff {np.abs(out - want).max():.2e}")
    if abs(m["PSNR"] - rec["PSNR"]) > 0.05:
        fails.append(f"PSNR {m['PSNR']:.4f} vs {rec['PSNR']:.4f}")
    if abs(m["SSIM"] - rec["SSIM"]) > 0.001:
        fails.append(f"SSIM {m['SSIM']:.5f} vs {rec['SSIM']:.5f}")
    return fails


def test_reference_fixture_through_port(tmp_path):
    """The recorded reference weights load directly under their names at the
    full flagship widths (64 ch, 8 blocks, 6 experts); the port meets the
    gate's tolerances on the first clip, and a tampered conv_last fails."""
    meta = json.loads((FIXTURE / "spec.json").read_text())
    spec = meta["spec"]
    sample = _fixture_clip(tmp_path, spec)
    sd = read_state_dict(FIXTURE / "state_dict.npz")
    assert _gate(sd, spec, meta, sample) == []
    sd["conv_last.weight"] = sd["conv_last.weight"] + 0.05
    assert _gate(sd, spec, meta, sample) != []


def test_checkpoint_npz_and_pth_load_alike(tmp_path):
    """A .pth with the reference's ``generator.`` prefix and extra entries
    loads like the bare .npz; '-' draws a seeded random init."""
    sd = read_state_dict(FIXTURE / "state_dict.npz")
    torch.save({"state_dict": {**{f"generator.{k}": v for k, v in sd.items()},
                               "discriminator.w": torch.zeros(1)}}, tmp_path / "ref.pth")
    cfg = dict(type="PnPVCVE")
    a = load_generator_weights(build_generator(cfg, device="cpu"), str(FIXTURE / "state_dict.npz"))
    b = load_generator_weights(build_generator(cfg, device="cpu"), str(tmp_path / "ref.pth"))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    r1 = load_generator_weights(build_generator(cfg, device="cpu", seed=3), "-", seed=9)
    r2 = load_generator_weights(build_generator(cfg, device="cpu", seed=4), "-", seed=9)
    for k, v in r1.state_dict().items():
        torch.testing.assert_close(r2.state_dict()[k], v, rtol=0, atol=0)
