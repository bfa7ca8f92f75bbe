"""The probe kernels K6-K10 (B10's multiplying probes and the copy floors
beside them), the port against the JAX package's probe tools, on the CPU
(the port runs its kernels' plain versions here; the JAX Pallas kernels run
in interpret mode).

Each JAX probe file is run as it is, its module constants shrunk with
monkeypatch (they are read at trace time), its ``timeit`` cut to one call
and, where its kernels are closures inside ``main``, its ``stage`` swapped
for a recorder of the outputs. The port's tool runs with ``--device cpu``
at the same shapes: the same numpy seed gives both the same inputs.

Tolerances:

- K6's copies (probe_floor128, k_dma, k_nodma), k2, k3 and k4 (int8
  products, and K9's quantization of k3's and k4's inputs): bitwise;
- k1, k5 (bf16 products, float32 sums in another order) and the H pass of
  k_fori_dot on its inputs of ones (columns 0..127; the TPU probe never
  writes 128..255): max|diff| <= 1e-5 max|ref|;
- probe_mmsel: within one bf16 ulp of the output. The H pass rounds a
  float32 sum to bf16, and a sum taken in another order can round to the
  neighbouring bf16 value;
- k_fori_dot on random inputs and a selection matrix of two random taps a
  row (build_s's form): bitwise, since a sum of two exact products and
  zeros rounds alike in any order.
"""

import contextlib
import importlib
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import probes as P

TOOLS = str(Path(__file__).resolve().parents[1] / "tools")

INT8_SHAPES = dict(M=64, K=32, N=16, BH=6, BW=20, C2=32, ROWS=4, COLS=18)
WARP2_HW, WARP2_C = (16, 256), 64
BISECT_HW = (32, 256)  # k_nodma reads rows 16..23 of an h-row input


@contextlib.contextmanager
def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _tool(name):
    """A module of tools/, imported with tools/ on the path only for the
    import and the JAX package's persistent compile cache off (a JAX
    probe's import would turn one on for the whole process)."""
    saved = os.environ.get("PNP_COMPILE_CACHE")
    os.environ["PNP_COMPILE_CACHE"] = "0"
    sys.path.insert(0, TOOLS)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(TOOLS)
        if saved is None:
            del os.environ["PNP_COMPILE_CACHE"]
        else:
            os.environ["PNP_COMPILE_CACHE"] = saved


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32 if x.dtype == jnp.bfloat16 else x.dtype)


def _bitwise(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _rel(got, ref, rtol=1e-5):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rtol * scale, f"max|diff| {err:.3g} > {rtol} * {scale:.3g}"


def _one_bf16_ulp(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)  # bf16 keeps 8 significant bits
    bad = np.abs(got - ref) > ulp
    assert not bad.any(), f"{bad.sum()} of {bad.size} values off by more than one bf16 ulp"


# ---- tools/int8_probe.py: K8, K9, K10 ----------------------------------------------------------


@pytest.fixture(scope="module")
def int8_runs():
    jax_probe = _tool("int8_probe")
    outs = {}

    def record(name, fn):
        t, out = fn()
        outs[name] = out
        return t, out

    with pytest.MonkeyPatch.context() as mp, _interpret():
        for k, v in INT8_SHAPES.items():
            mp.setattr(jax_probe, k, v)
        mp.setattr(jax_probe, "stage", record)
        mp.setattr(jax_probe, "timeit", lambda f, *a, n=100: (1.0, f(*a)))
        jax_probe.main()
    s = INT8_SHAPES
    port = _tool("torch_int8_probe").main([
        "--device", "cpu", "--mkn", str(s["M"]), str(s["K"]), str(s["N"]),
        "--band", str(s["BH"]), str(s["BW"]), str(s["C2"]), "--out", str(s["ROWS"]),
        str(s["COLS"]), "--n", "1"])
    return outs, port


@pytest.mark.parametrize("name,check", [
    ("bf16 matmul", _rel),
    ("int8 matmul", _bitwise),
    ("quantize-in-kernel + int8 matmul", _bitwise),
    ("int8 tap-conv (strided slices)", _bitwise),
    ("bf16 tap-conv (same geometry)", _rel),
])
def test_int8_probe_matches_jax(int8_runs, name, check):
    """Each stage of tools/torch_int8_probe.py on the CPU (K8, K9 + K8,
    K9 + K10, K10's plain versions) against the JAX kernel of
    tools/int8_probe.py on the same inputs."""
    jax_outs, port = int8_runs
    assert port[name]["out"] is not None
    check(port[name]["out"], jax_outs[name])


def test_absmax_quantize_rounds_half_to_even():
    """K9's plain version: round half to even after IEEE division, clip to
    +-127, s = max(max|x|, 1e-6) / 127 in float32."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0, 0.0], dtype=torch.bfloat16)
    q, s = P.absmax_quantize(x)
    assert s.dtype == torch.float32 and float(s) == np.float32(127.0) / np.float32(127.0)
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -127, 0]
    q0, s0 = P.absmax_quantize(torch.zeros(8, dtype=torch.bfloat16))
    assert float(s0) == np.float32(np.float32(1e-6) / np.float32(127.0)) and not q0.any()


# ---- tools/warp_kernel_probe2.py: K6 and K7 ----------------------------------------------------


@pytest.fixture(scope="module")
def warp2_runs():
    jax_probe = _tool("warp_kernel_probe2")
    h, w = WARP2_HW
    outs = {}

    def record(name, fn):
        ms, out = fn()
        outs[name] = out
        return ms

    with pytest.MonkeyPatch.context() as mp, _interpret():
        for k, v in dict(H=h, W=w, C=WARP2_C, NBY=h // 8, WP=w + 64, HP=h + 40,
                         NT=w // 128).items():
            mp.setattr(jax_probe, k, v)
        mp.setattr(jax_probe, "stage", record)
        mp.setattr(jax_probe, "timeit", lambda f, *a, n=30: (0.0, f(*a)))
        jax_probe.main()
    port = _tool("torch_warp_kernel_probe2").main([
        "--device", "cpu", "--hw", str(h), str(w), "--channels", str(WARP2_C), "--n", "1"])
    return outs, port


@pytest.mark.parametrize("name,check", [
    ("band DMA floor (128-lane)", _bitwise),
    ("matmul-select H + dense V", _one_bf16_ulp),
])
def test_warp_kernel_probe2_matches_jax(warp2_runs, name, check):
    """tools/torch_warp_kernel_probe2.py on the CPU (K6's and K7's plain
    versions, build_s) against probe_floor128 and probe_mmsel."""
    jax_outs, port = warp2_runs
    assert port[name]["out"] is not None
    check(port[name]["out"], jax_outs[name])


# ---- tools/warp_bisect.py: K6 and K7's H pass --------------------------------------------------


class _RandomOnes:
    """Stands in for jax.numpy inside warp_bisect: ``ones`` gives seeded
    values (kept, for the port), everything else is jax.numpy's. The
    (1, 1, 128, 184) selection matrix of k_fori_dot gets two random taps a
    row at random columns, as build_s makes them; the rest normal values."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.made = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def ones(self, shape, dtype):
        if tuple(shape[:2]) == (1, 1):
            rows, kw = shape[2], shape[3]
            a = np.zeros(shape, np.float32)
            m = np.arange(rows) + self.rng.integers(15, 50, rows)
            a[0, 0, np.arange(rows), m] = self.rng.random(rows)
            a[0, 0, np.arange(rows), m + 1] = self.rng.random(rows)
        else:
            a = self.rng.standard_normal(shape).astype(np.float32)
        self.made.append(a)
        return jnp.asarray(a, dtype)


def _bisect_jax(which, lanes, fake=None):
    jax_probe = _tool("warp_bisect")
    h, w = BISECT_HW
    fn = {"dma": jax_probe.k_dma, "nodma": jax_probe.k_nodma, "fori": jax_probe.k_fori_dot}[which]
    with pytest.MonkeyPatch.context() as mp, _interpret():
        mp.setattr(jax_probe, "H", h)
        mp.setattr(jax_probe, "W", w)
        mp.setattr(jax_probe, "WPAD", w + 64)
        if fake is not None:
            mp.setattr(jax_probe, "jnp", fake)
        return fn(lanes)


@pytest.mark.parametrize("stage", ["dma64", "dma128", "nodma64", "fori128", "fori64"])
def test_warp_bisect_matches_jax(stage):
    """tools/torch_warp_bisect.py on the CPU against the JAX stage on its
    inputs of ones, then the same port wrapper against the JAX kernel on
    seeded inputs (normal values; S of two random taps a row). fori:
    columns 0..127 only, the port's 128..255 zeros."""
    bisect = _tool("torch_warp_bisect")
    _, which, lanes = bisect.STAGES[stage]
    h, w = BISECT_HW
    port = bisect.main([stage, "--device", "cpu", "--hw", str(h), str(w)])[stage]
    ref = _bisect_jax(which, lanes)
    fake = _RandomOnes(7)
    ref_rand = _bisect_jax(which, lanes, fake)
    ins = [torch.from_numpy(a).to(torch.bfloat16) for a in fake.made]
    if which == "fori":
        x, s = ins  # k_fori_dot makes x, then s
        got_rand = P.mmsel_h(x, s, h // 8, 16, w)
        assert not port["out"][..., 128:, :].any() and not got_rand[..., 128:, :].any()
        _rel(port["out"][..., :128, :], np.asarray(ref, np.float32)[..., :128, :])
        _bitwise(got_rand[..., :128, :], np.asarray(ref_rand, np.float32)[..., :128, :])
    else:
        got_rand = P.window_copy(ins[0], h, w, 16, 32, 8 if which == "nodma" else 0)
        _bitwise(port["out"], ref)
        _bitwise(got_rand, ref_rand)


def test_probe_wrappers_refuse_what_they_cannot_take():
    """Shape checks that hold on every device."""
    x = torch.zeros((1, 24, 40, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="outside src"):
        P.window_copy(x, 16, 32, 16, 0)
    band = torch.zeros((6, 20, 32), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 32, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tapconv"):
        P.tapconv(band, w, 5, 18)
    with pytest.raises(ValueError, match="scale"):
        P.tapconv(band, w, 4, 18, torch.ones(1))
