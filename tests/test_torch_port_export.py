"""The port's model kernels as registered ops (pnp_vcve_torch/kernels/
ops_registry.py) and the export of the eval forward through them
(tools/torch_export_model.py), on the CPU at small widths (16 channels, 2
blocks, 3 experts; 64 channels under 'pf'; 3 frames at 32x32), and a block
form (one_layer=False, K5) exported in process.

The exported artifacts are reloaded and run: the 'padgather' one against
the JAX package's eager forward on the same weights (carried through
``pnp_vcve_tpu.core.convert``, as tests/test_torch_port_model.py carries
them) within 1e-4; the 'pf' one against the port's eager 'pf' forward
within 1e-6 (tests/test_torch_port_pf.py holds that forward to JAX's Pallas
path). On the CPU each op runs its plain version, so the artifacts hold
the same ops as on the card.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.kernels.ops_registry import OPS, flop_per_pixel

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import torch_export_model  # noqa: E402
import torch_kernel_bounds  # noqa: E402

T, H, W = 3, 32, 32
SMALL = dict(mid_channels=16, num_blocks=2, num_experts=3)
CONFIGS = {
    "padgather": ("HR_davis_LR_128x128.py", SMALL),
    "pf": ("HR_davis_LR_128x128_serving.py", {**SMALL, "mid_channels": 64}),
}
BLOCK_FORM = {**SMALL, "num_blocks": 1, "one_layer": False}
# ops in each artifact's graph: per sweep step a warp, an input conv and the
# blocks (under 'pf' the last one K3s; unfused blocks two K5 each), a head
# per forward step
GRAPH_OPS = {
    "padgather": {"flow_warp": 2 * T, "input_conv": 2 * T, "drt_block": 4 * T, "head": T},
    "pf": {"flow_warp_block": 2 * T, "input_conv": 2 * T, "drt_block": 2 * T,
           "drt_block_select": 2 * T, "head": T},
    "one_layer_false": {"flow_warp": 2 * T, "input_conv": 2 * T, "conv3x3": 4 * T, "head": T},
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each config exported through the CLI with --verify: ``{name: (CLI
    result, reloaded program, config path)}``. (Saving and reloading an
    artifact takes ~2.5 s here.)"""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for name, (base, gen) in CONFIGS.items():
        cfg = root / f"{name}.py"
        cfg.write_text(f"_base_ = [{str(REPO / 'pnp_vcve_torch' / 'configs' / base)!r}]\n"
                       f"model = dict(generator={gen!r})\n")
        pt2 = root / f"{name}.pt2"
        res = torch_export_model.main([str(cfg), "-", str(pt2), "--shape", str(T), str(H), str(W),
                                       "--verify", "--device", "cpu"])
        out[name] = (res, res["loaded"], str(cfg))
    return out


def _inputs(rng):
    """Seeded numpy inputs at the artifacts' shape: I/P/B slices, MVs of a
    few pixels constant on 8x8 blocks, one-hot partitions."""
    mv = rng.uniform(-6.0, 6.0, (1, T, H // 8, W // 8, 4)).astype(np.float32)
    return dict(
        lrs=rng.random((1, T, H, W, 3), np.float32),
        qps=rng.random((1, T), np.float32),
        slices=np.asarray([[73.0, 66.0, 80.0]], np.float32),
        mvs=np.repeat(np.repeat(mv, 8, 2), 8, 3),
        base_qps=np.full((1, T), 25 / 255.0, np.float32),
        par_map=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (1, T, H, W))] / 255.0,
    )


def _run(program, inp):
    with torch.no_grad():
        return program.module()(*(torch.from_numpy(v) for v in inp.values())).numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_export_cli_names_the_ops(exported, name):
    """The CLI verified each artifact against the eager forward (here: equal),
    and the reloaded graph holds each op the config runs, as often as the
    sweeps call it."""
    res, program, _ = exported[name]
    assert res["max_abs_err"] == 0.0 and res["bytes"] > 0
    assert res["ops"] == GRAPH_OPS[name]
    assert dict(torch_export_model.op_counts(program)) == GRAPH_OPS[name]
    assert torch_export_model.input_shape(program) == (T, H, W)


def test_block_form_exports_k5():
    """The unfused block form (one_layer=False: two K5 a block) exports with
    the conv3x3 op in its graph, and the program equals the eager forward."""
    from pnp_vcve_torch.core.builder import build_generator

    model = build_generator(dict(type="PnPVCVE", **BLOCK_FORM), device="cpu", seed=4).eval()
    for p in model.parameters():
        p.requires_grad_(False)
    program = torch_export_model.export(model, T, H, W, "cpu")
    assert dict(torch_export_model.op_counts(program)) == GRAPH_OPS["one_layer_false"]
    inp = _inputs(np.random.default_rng(9))
    with torch.no_grad():
        want = model(*(torch.from_numpy(v) for v in inp.values())).numpy()
    np.testing.assert_array_equal(_run(program, inp), want)


def test_padgather_artifact_matches_jax(exported):
    """The reloaded 'padgather' artifact on seeded inputs against the JAX
    package's eager forward on the artifact's own weights: 1e-4."""
    _, program, _ = exported["padgather"]
    sd = {k: v.numpy() for k, v in program.module().state_dict().items()}
    params = convert_generator_state_dict(sd, num_blocks=SMALL["num_blocks"])
    inp = _inputs(np.random.default_rng(7))
    jm = JaxPnPVCVE(**SMALL, remat=False)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, **x))(
        params, {k: jnp.asarray(v) for k, v in inp.items()}))
    got = _run(program, inp)
    assert got.shape == (1, T, H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pf_artifact_matches_eager_pf(exported):
    """The reloaded 'pf' artifact against the port's eager 'pf' forward on
    the same weights and seeded inputs: 1e-6."""
    _, program, cfg = exported["pf"]
    model = torch_export_model.load_model(cfg, "-", torch.device("cpu"))
    model.load_state_dict(program.module().state_dict())
    assert model.warp_impl == "pf" and model.mid_channels == 64
    inp = _inputs(np.random.default_rng(8))
    with torch.no_grad():
        want = model(*(torch.from_numpy(v) for v in inp.values())).numpy()
    np.testing.assert_allclose(_run(program, inp), want, atol=1e-6, rtol=0)


# ---- the ops -------------------------------------------------------------------------------


def _op_args(name, c, dtype, gen, b=2, h=8, w=16):
    """Arguments of op ``name`` at width ``c`` with features in ``dtype``
    (weights float32, as the model passes them)."""
    f = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    x = f(b, h, w, c).to(dtype)
    par = torch.eye(3)[torch.randint(0, 3, (b, h, w), generator=gen)].to(dtype)
    drt = (x, par, f(b, 3, 3, c, c) / c, f(b, c), f(b, c), f(c, 3, c) / c, f(3, 3, c, c) / c, f(c))
    return {
        "flow_warp": (x, (3 * f(b, h, w, 2)).to(dtype)),
        "flow_warp_block": (x, 3 * f(b, h, w, 2), 16.0),
        "input_conv": ([f(b, h, w, 3).to(dtype), x, x.clone()],
                       [f(b, 3, 3, 3, c), f(b, 3, 3, c, c) / c, f(b, 3, 3, c, c) / c], f(c)),
        "drt_block": drt,
        "drt_block_select": (*drt, f(b, h, w, c).to(dtype), torch.tensor([1.0, 0.0])),
        "head": (x, f(3, 3, c, c) / c, f(c), f(3, 3, c, 3) / c, f(3)),
        "conv3x3": (x, f(b, 3, 3, c, 24) / c, f(b, 24), f(b, 24)),
    }[name]


def _widths(name):
    """64, and K3's and K4's two-launch widths (216 and 192: above their
    one-launch widths in float32, launch.ONE_LAUNCH_WIDTH); K3s runs at 64."""
    return {"drt_block": (64, 216), "head": (64, 192)}.get(name, (64,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_fake_impl_matches_plain(name, dtype):
    """Under FakeTensorMode each op's fake output has the plain version's
    shapes and types (K3s: both outputs), at 64 channels and at K3's and
    K4's two-launch widths, in float32 and bfloat16."""
    op, plain = OPS[name], getattr(K.PLAIN, name)
    for c in _widths(name):
        args = _op_args(name, c, dtype, torch.Generator().manual_seed(c))
        want = plain(*args)
        mode = FakeTensorMode()
        fake_args = [[mode.from_tensor(t) for t in a] if isinstance(a, list)
                     else mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with mode:
            got = op(*fake_args)
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for g, w in pairs:
            assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype), (name, c)


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck(name):
    """torch.library.opcheck on the CPU: the schema, the fake implementation
    against the plain one, the autograd registration and an AOT dispatch
    with dynamic shapes."""
    torch.library.opcheck(OPS[name], _op_args(name, 8, torch.float32,
                                              torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("name,label", [
    ("input_conv", "input_conv (backward, 3 parts)"), ("input_conv", "input_conv (forward, 4 parts)"),
    ("drt_block", "drt_block"), ("drt_block_select", "drt_block_select"), ("head", "head"),
    ("conv3x3", "conv3x3"), ("flow_warp", "flow_warp"), ("flow_warp_block", "flow_warp_block"),
])
def test_flop_formula_is_the_bounds_count(name, label):
    """Each op's FLOP formula is tools/torch_kernel_bounds.py's count an
    output pixel (64 channels) times the pixels, as the FLOP counter reads
    it."""
    c, parts = 64, ([3, 64, 64] if "3 parts" in label else [3, 64, 64, 64])
    per_px = flop_per_pixel(name, c, c_in=c, parts=parts)
    assert per_px == torch_kernel_bounds.model_flop_per_pixel(label, c)
    if name == "input_conv" and "4 parts" in label:
        return
    args = _op_args(name, 8, torch.float32, torch.Generator().manual_seed(2))
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        OPS[name](*args)
    b, h, w = args[0][0].shape[:3] if name == "input_conv" else args[0].shape[:3]
    c_out = 24 if name == "conv3x3" else 8
    want = flop_per_pixel(name, c_out, c_in=8, parts=[3, 8, 8]) * b * h * w
    assert counter.get_total_flops() == want
