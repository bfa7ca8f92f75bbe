"""The port's serving warps ('pf', 'block8'), its key-select DRT block and the
whole model under the serving config against the JAX package, on the CPU in
float32 (the port runs its kernels' plain versions here).

The JAX Pallas kernels run in interpret mode, as the JAX package's own tests
run them (tests/test_warp_pf.py, tests/test_kernels.py). Inputs come from
numpy generators; weights are drawn by the port and carried to the JAX side
through ``pnp_vcve_tpu.core.convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_vcve_tpu.core.convert import convert_generator_state_dict
from pnp_vcve_tpu.models import PnPVCVE as JaxPnPVCVE
from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import warp as kw
from pnp_vcve_torch.ops import warp as twarp

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _block_flow(rng, b, h, w, reach=24.0):
    """Flows constant over 8x8 blocks, up to +-reach px."""
    fb = rng.uniform(-reach, reach, (b, -(-h // 8), -(-w // 8), 2)).astype(np.float32)
    return np.repeat(np.repeat(fb, 8, axis=1), 8, axis=2)[:, :h, :w]


# ---- the warps ---------------------------------------------------------------------


def _jax_pf(x, flow, tables):
    from pnp_vcve_tpu.kernels.drt_stack import pack_pf, unpack_pf
    from pnp_vcve_tpu.kernels import warp_pf as jpf

    b, h, w, _ = x.shape
    tile = next(t for t in (128, 64, 32, 16, 8) if (w // 2) % t == 0)
    xpf, fl = pack_pf(jnp.asarray(x), 8), jnp.asarray(flow)
    if tables == "dense":
        ypf = jpf.warp_pf(xpf, *jpf.build_warp_tables(fl, h, w, tile), h, w, tile)
    else:
        ypf = jpf.warp_pf_compact(xpf, jpf.build_warp_tables_compact(fl, h, w, tile), h, w, tile)
    return np.asarray(unpack_pf(ypf, h, w))


@pytest.mark.parametrize("tables", ["dense", "compact"])
@pytest.mark.parametrize("hw", [(16, 32), (32, 256)])
def test_pf_warp_matches_jax_warp_pf(tables, hw):
    """flow_warp(impl='pf') and K1b's wrapper with max_mv=16 equal JAX
    flow_warp_pf (both table forms) on block-constant flows up to +-24 px,
    where the +-16 px clamp bites, and on a field that is not
    block-constant (each block reads its top-left pixel)."""
    rng = np.random.default_rng(0)
    b, (h, w) = 2, hw
    x = rng.standard_normal((b, h, w, 64)).astype(np.float32)
    flow = _block_flow(rng, b, h, w)
    fields = [flow]
    if hw == (16, 32):
        fields.append(flow + rng.uniform(-3.0, 3.0, flow.shape).astype(np.float32))
    for fl in fields:
        want = _jax_pf(x, fl, tables)
        np.testing.assert_allclose(twarp.flow_warp(_t(x), _t(fl), impl="pf").numpy(), want,
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(K.KERNELS.flow_warp_block(_t(x), _t(fl), 16.0).numpy(),
                                   want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(16, 32), (24, 36)])
def test_block8_warp_matches_jax(hw):
    """flow_warp(impl='block8') equals JAX's on a field that is not
    block-constant, and falls back to the per-pixel warp at w=36, as JAX
    does."""
    from pnp_vcve_tpu.ops.warp import flow_warp as jwarp

    rng = np.random.default_rng(1)
    b, (h, w) = 2, hw
    x = rng.standard_normal((b, h, w, 64)).astype(np.float32)
    flow = rng.uniform(-24.0, 24.0, (b, h, w, 2)).astype(np.float32)
    want = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(flow), impl="block8"))
    np.testing.assert_allclose(twarp.flow_warp(_t(x), _t(flow), impl="block8").numpy(), want,
                               atol=1e-5, rtol=0)
    if w % 8 == 0:
        np.testing.assert_allclose(K.KERNELS.flow_warp_block(_t(x), _t(flow)).numpy(), want,
                                   atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(want, np.asarray(jwarp(jnp.asarray(x), jnp.asarray(flow))),
                                   atol=0, rtol=0)
        with pytest.raises(ValueError, match="multiples of 16"):
            twarp.flow_warp(_t(x), _t(flow), impl="pf")


def test_block_warp_refuses_grad():
    """K1b has no gradient (JAX's warp_pf has no VJP)."""
    x = torch.zeros((1, 8, 8, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        K.KERNELS.flow_warp_block(x, torch.zeros((1, 8, 8, 2)), 16.0)


# ---- the key-select DRT block ---------------------------------------------------------


def test_drt_block_select_matches_jax_key_select():
    """drt_block_select_plain against JAX drt_stack_packed_from_pf(...,
    key_select=...) (the case of tests/test_kernels.py:215-253 at 64
    channels): out within 1e-5 of JAX, new_last_key bitwise the select of
    the port's own out, one keyframe sample and one not."""
    from pnp_vcve_tpu.kernels.drt_stack import drt_stack_packed_from_pf, pack_pf, unpack_pf

    rng = np.random.default_rng(2)
    b, h, w, c = 2, 16, 32, 64

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x, lk = r(b, h, w, c), r(b, h, w, c)
    par = ((rng.random((b, h, w, 3)) > 0.5) / 255.0).astype(np.float32)
    blk = dict(dyn_kernels=r(b, 3, 3, c, c, scale=0.03), dyn_biases=r(b, c, scale=0.1),
               par_kernel=r(c, 3, c, scale=0.03), conv1_kernel=r(3, 3, c, c, scale=0.03),
               conv1_bias=r(c, scale=0.1), gamma=rng.random((b, c)).astype(np.float32))
    is_key = np.array([1.0, 0.0], np.float32)
    out_pf, lk_pf = drt_stack_packed_from_pf(
        pack_pf(jnp.asarray(x), 8), jnp.asarray(par),
        [{k: jnp.asarray(v) for k, v in blk.items()}], h=h, w=w, th=8, unpack=False,
        key_select=(pack_pf(jnp.asarray(lk), 8), jnp.asarray(is_key)),
    )
    want_out, want_lk = np.asarray(unpack_pf(out_pf, h, w)), np.asarray(unpack_pf(lk_pf, h, w))
    args = [_t(a) for a in (x, par, blk["dyn_kernels"], blk["dyn_biases"], blk["gamma"],
                            blk["par_kernel"], blk["conv1_kernel"], blk["conv1_bias"])]
    for op in (K.PLAIN.drt_block_select, K.KERNELS.drt_block_select):
        out, new_lk = op(*args, _t(lk), _t(is_key))
        np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(new_lk.numpy(), want_lk, atol=1e-5, rtol=0)
        torch.testing.assert_close(new_lk[0], out[0], rtol=0, atol=0)
        torch.testing.assert_close(new_lk[1], _t(lk)[1], rtol=0, atol=0)


def test_drt_block_select_function_grads():
    """DRTBlockSelectFunction, with the plain version standing in for the
    launch, gives plain autograd's gradients for every input (none for the
    flag) through both outputs."""
    gen = torch.Generator().manual_seed(0)
    b, h, w = 2, 6, 10

    def t(*shape, scale=1.0, grad=True):
        return (torch.randn(shape, generator=gen) * scale).requires_grad_(grad)

    args = [t(b, h, w, 64), (torch.rand((b, h, w, 3), generator=gen) > 0.5).float(),
            t(b, 3, 3, 64, 64, scale=0.03), t(b, 64, scale=0.1), t(b, 64),
            t(64, 3, 64, scale=0.03), t(3, 3, 64, 64, scale=0.03), t(64, scale=0.1),
            t(b, h, w, 64), torch.tensor([1.0, 0.0])]
    wrt = [a for a in args if a.requires_grad]
    g_out = torch.randn((b, h, w, 64), generator=gen)
    g_lk = torch.randn((b, h, w, 64), generator=gen)

    def grads(fn):
        out, lk = fn(*args)
        return torch.autograd.grad((out, lk), wrt, (g_out, g_lk))

    got = grads(lambda *a: kd.DRTBlockSelectFunction.apply(kd.drt_block_select_plain, *a))
    for g, want in zip(got, grads(kd.drt_block_select_plain)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


# ---- the whole model ----------------------------------------------------------------------

PF = dict(mid_channels=64, num_blocks=2, num_experts=2)


def _inputs(rng, b, t, h, w, block_constant=(True, False)):
    """b clips; clip i has block-constant MVs (up to +-24 px) if
    ``block_constant[i]``, else those plus per-pixel noise."""
    mvs = np.concatenate([_block_flow(rng, b * t, h, w), _block_flow(rng, b * t, h, w)], -1)
    mvs = mvs.reshape(b, t, h, w, 4)
    for i in range(b):
        if not block_constant[i]:
            mvs[i] += rng.uniform(-3.0, 3.0, mvs[i].shape).astype(np.float32)
    return dict(
        lrs=rng.random((b, t, h, w, 3), np.float32),
        qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0], [66.0, 80.0, 66.0]], np.float32)[:b, :t],
        mvs=mvs,
        base_qps=np.full((b, t), 15.0 / 255.0, np.float32),
        par_map=(np.eye(3, dtype=np.float32)[rng.integers(0, 3, (b, t, h, w))] / 255.0),
    )


def _jax_apply(model, warp_impl, use_pallas):
    jm = JaxPnPVCVE(**PF, remat=False, use_pallas_kernels=use_pallas, warp_impl=warp_impl)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert_generator_state_dict(sd, num_blocks=PF["num_blocks"])
    fn = jax.jit(lambda p, x: jm.apply({"params": p}, **x))
    return lambda inp: np.asarray(fn(params, {k: jnp.asarray(v) for k, v in inp.items()}))


def test_model_pf_matches_jax():
    """The port's serving model (warp_impl='pf': K1b with the +-16 px clamp,
    K3s as the last block) equals JAX PnPVCVE(use_pallas_kernels=True,
    warp_impl='pf') within 1e-4: b=2, t=3, 16x32, MVs up to +-24 px, block
    constant in one clip and not in the other."""
    rng = np.random.default_rng(3)
    model = build_generator(dict(type="PnPVCVE", **PF, remat=False, use_pallas_kernels=True,
                                 warp_impl="pf"), device="cpu", seed=5)
    inp = _inputs(rng, 2, 3, 16, 32)
    with torch.inference_mode():
        got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
    np.testing.assert_allclose(got, _jax_apply(model, "pf", True)(inp), atol=1e-4, rtol=0)


def test_model_block8_matches_jax():
    """warp_impl='block8' (K1b unclamped; K1 where the padded size is not a
    multiple of 8) equals JAX's block8 model within 1e-4."""
    rng = np.random.default_rng(4)
    model = build_generator(dict(type="PnPVCVE", **PF, remat=False, warp_impl="block8"),
                            device="cpu", seed=6)
    apply = _jax_apply(model, "block8", False)
    for h, w in ((16, 32), (16, 36)):
        inp = _inputs(rng, 2, 3, h, w)
        with torch.inference_mode():
            got = model(**{k: _t(v) for k, v in inp.items()}).numpy()
        np.testing.assert_allclose(got, apply(inp), atol=1e-4, rtol=0)


@pytest.mark.parametrize("override,match", [
    (dict(use_pallas_kernels=False), "use_pallas_kernels"),
    (dict(mid_channels=8), "mid_channels"),
    (dict(), "h,w % 16"),
])
def test_model_pf_guards(override, match):
    """warp_impl='pf' refuses what JAX's refuses (tests/test_warp_pf.py:167-188),
    and a frame size that is not a multiple of 16."""
    cfg = dict(type="PnPVCVE", **{**PF, "num_blocks": 1}, use_pallas_kernels=True,
               warp_impl="pf")
    model = build_generator({**cfg, **override}, device="cpu")
    h, w = (16, 32) if override else (16, 40)
    inp = _inputs(np.random.default_rng(0), 1, 2, h, w)
    with pytest.raises(ValueError, match=match), torch.inference_mode():
        model(**{k: _t(v) for k, v in inp.items()})


def test_model_pf_through_kernel_wrappers(monkeypatch):
    """The flagship block count under 'pf' with every wrapper routed past
    its CPU check (the plain versions standing in for the launches): per
    frame 2 block warps, 2 input convs, 14 DRT blocks, 2 key-select blocks,
    1 head and no per-pixel warp, and the output equals the plain path's."""
    counts = dict.fromkeys(K.LAUNCHES, 0)

    def stand_in(name, plain):
        def run(*a):
            counts[name] += 1
            return plain(*a)
        return run

    monkeypatch.setattr(kw, "on_cpu", lambda x: False)
    monkeypatch.setattr(kd, "on_cpu", lambda x: False)
    monkeypatch.setattr(kw, "_launch", stand_in("warp", kw.flow_warp_plain))
    monkeypatch.setattr(kw, "_block_launch", stand_in("warp_block", kw.flow_warp_block_plain))
    monkeypatch.setattr(kd, "_input_conv_launch", stand_in("input_conv", kd.input_conv_plain))
    monkeypatch.setattr(kd, "_drt_block_launch", stand_in("drt_block", kd.drt_block_plain))
    monkeypatch.setattr(kd, "_drt_block_select_launch",
                        stand_in("drt_block_select", kd.drt_block_select_plain))
    monkeypatch.setattr(kd, "_head_launch", stand_in("head", kd.head_plain))
    model = build_generator(dict(type="PnPVCVE", mid_channels=64, num_blocks=8, num_experts=2,
                                 use_pallas_kernels=True, warp_impl="pf"), device="cpu", seed=1)
    t = 2
    inp = {k: _t(v) for k, v in _inputs(np.random.default_rng(5), 1, t, 16, 16).items()}
    with torch.inference_mode():
        got = model(**inp)
        model.ops = K.PLAIN
        want = model(**inp)
    assert counts == {"warp": 0, "warp_block": 2 * t, "input_conv": 2 * t, "drt_block": 14 * t,
                      "drt_block_select": 2 * t, "head": t, "conv3x3": 0}
    torch.testing.assert_close(got, want, rtol=0, atol=0)
