"""The model kernels' width rule (K1, K2-K4 take any width that is a
multiple of 8, K1b up to the widest block that fits in shared memory, K3s 64
only; K3 and K4 run as two launches above their one-launch width), on the
CPU: the argument checks each launch makes run here without a launch, on the
shapes the kernels and the model give them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pnp_vcve_torch import kernels as K
from pnp_vcve_torch.core.builder import build_generator
from pnp_vcve_torch.kernels import drt_stack as kd
from pnp_vcve_torch.kernels import launch as kl
from pnp_vcve_torch.kernels import warp as kw

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)


def _args(c, b=2, h=16, w=24):
    """One call's arguments of each model kernel at width c."""
    z = lambda *s: torch.zeros(s)  # noqa: E731
    x, flow, par = z(b, h, w, c), z(b, h, w, 2), z(b, h, w, 3)
    blk = (z(b, 3, 3, c, c), z(b, c), z(b, c), z(c, 3, c), z(3, 3, c, c), z(c))
    parts = [z(b, h, w, 3), x, x]
    ks = kd.part_kernels(z(3, 3, 3 + 2 * c, c), [3, c, c], b)
    return {
        "warp": (kw.warp_args, (x, flow)),
        "warp_block": (kw.warp_block_args, (x, flow)),
        "input_conv": (kd.input_conv_args, (parts, ks, z(c))),
        "drt_block": (kd.drt_block_args, (x, par, *blk)),
        "drt_block_select": (kd.drt_block_select_args, (x, par, *blk, x, z(b))),
        "head": (kd.head_args, (x, z(3, 3, c, c), z(c), z(3, 3, c, 3), z(3))),
    }


@pytest.mark.parametrize("c", [8, 24, 64, 128])
def test_argument_checks_take_every_width(c):
    """Each check passes at c in {8, 24, 64, 128} and hands the kernel its
    weights at that width; K3s's at 64 only, the pf path's width."""
    args = _args(c)
    fn, a = args.pop("drt_block_select")
    if c == 64:
        args["drt_block_select"] = (fn, a)
    else:
        with pytest.raises(ValueError, match=f"drt_block_select: width {c}; K3s takes 64 "
                                             f"channels only"):
            fn(*a)
    checked = {name: fn(*a) for name, (fn, a) in args.items()}
    assert checked["warp"] == checked["warp_block"] == c
    ks, bias, width = checked["input_conv"]
    assert width == c
    assert [k.shape for k in ks] == [(2, 2, 9, c, 8), (2, 2, 9, c, c), (2, 2, 9, c, c)]
    for name in ("drt_block", "drt_block_select")[:1 + (c == 64)]:
        w2, b2, g, pk, w1, b1 = checked[name]
        assert (w2.shape, b2.shape, g.shape, pk.shape, w1.shape, b1.shape) == (
            (2, 2, 9, c, c), (2, c), (2, c), (2, 3, c, c), (2, 9, c, c), (c,))
    assert [t.shape for t in checked["head"]] == [(2, 9, c, c), (c,), (9, c, 3), (3,)]


@pytest.mark.parametrize("name", ["warp", "warp_block", "input_conv", "drt_block",
                                  "drt_block_select", "head"])
def test_argument_checks_refuse_width_12(name):
    fn, a = _args(12)[name]
    with pytest.raises(ValueError, match=f"{name}: width 12 is not a multiple of 8"):
        fn(*a)


def test_width_limits_follow_shared_memory():
    """Each source's limit is the widest block its shared-memory formula
    fits in an H100's 227 KB: K1b's 9 x 9 window caps its width (712); K3
    keeps all c channels of h in the feature type (one launch up to 168
    float32 channels, 384 bfloat16) and K4 its hidden map in float32 with
    W_last beside two W_hr terms in both types (144), each running as two
    launches through a scratch above it;
    K1, K2 and K5 have no limit, K3s runs at 64 only. The numbers are those
    the sources static_assert against their formulas, and the formulas,
    transcribed here, fit at each limit and not 8 channels above it."""
    assert kl.MAX_WIDTH == {
        "warp": None, "warp_block": 712, "input_conv": None, "drt_block": None,
        "drt_block_select": 64, "head": None, "conv3x3": None}
    f32, bf16 = torch.float32, torch.bfloat16
    assert kl.ONE_LAUNCH_WIDTH == {("drt_block", f32): 168, ("drt_block", bf16): 384,
                                   ("head", f32): 144, ("head", bf16): 144}
    csrc = Path(kl.__file__).parent / "csrc"
    consts = {}
    for src in ("warp_block.cu", "drt_block.cu", "head.cu"):
        consts.update({k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                                          (csrc / src).read_text())})
    assert consts["WB_MAX_WIDTH"] == kl.MAX_WIDTH["warp_block"]
    assert consts["DB_ONE_LAUNCH_F32"] == kl.ONE_LAUNCH_WIDTH[("drt_block", f32)]
    assert consts["DB_ONE_LAUNCH_BF16"] == kl.ONE_LAUNCH_WIDTH[("drt_block", bf16)]
    assert consts["HD_ONE_LAUNCH_F32"] == kl.ONE_LAUNCH_WIDTH[("head", f32)]
    assert consts["HD_ONE_LAUNCH_BF16"] == kl.ONE_LAUNCH_WIDTH[("head", bf16)]
    text = (csrc / "drt_block.cu").read_text()
    for const, elt in (("DB_ONE_LAUNCH_F32", 4), ("DB_ONE_LAUNCH_BF16", 2)):
        assert f"static_assert(db_smem<FUSED>({const}, {elt}) <= SMEM_MAX" in text
    text = (csrc / "head.cu").read_text()
    for const, elt in (("HD_ONE_LAUNCH_F32", 4), ("HD_ONE_LAUNCH_BF16", 2)):
        assert f"static_assert(head_smem({const}, {elt}) <= SMEM_MAX" in text
    assert "static_assert(warp_block_smem(WB_MAX_WIDTH)" in (csrc / "warp_block.cu").read_text()

    def k3_smem(c, elt):  # drt_block.cu: db_smem<FUSED>, tc_conv.cuh's constants
        pitch, wtile = 144, 64 * 144
        kc, nw = (64, 1) if elt == 2 else (32, 2)
        nxb = 2 if -(-c // kc) > 1 else 1
        h_pitch = -(-c * elt // 32) * 32 + 16  # at c <= 64 h reuses the chunk buffers
        return (nxb * 12 * 20 * pitch + 2 * nw * wtile + (180 * h_pitch if c > 64 else 0)
                + 4 * 3 * 180)

    def k4_smem(c, elt):  # head.cu: head_smem; two weight tiles a step in both types
        kc = 64 if elt == 2 else 32
        x_bytes = (2 if -(-c // kc) > 1 else 1) * 12 * 20 * 144
        h_bytes = 4 * c * 180  # at c <= 64 one of the two over the other
        front = max(x_bytes, h_bytes) if c <= 64 else x_bytes + h_bytes
        return front + 2 * 2 * 64 * 144 + 16 * 9 * c  # W_last as float4

    for (name, dtype), top in kl.ONE_LAUNCH_WIDTH.items():
        smem = (lambda c: (k3_smem if name == "drt_block" else k4_smem)(c, dtype.itemsize))
        assert smem(top) <= kl.SMEM_MAX < smem(top + 8), (name, dtype)
        assert kl.launch_form(name, top, dtype) == 1 and kl.launch_form(name, top + 8, dtype) == 2
    kl.check_width("head", 192)
    kl.check_width("drt_block", 1024)
    with pytest.raises(ValueError, match="warp_block: width 720 is above 712, the widest block "
                                         "that fits in an H100 block's 232448 bytes of shared"):
        kl.check_width("warp_block", 720)


@pytest.mark.parametrize("warp_impl", ["padgather", "block8"])
@pytest.mark.parametrize("c", [8, 128])
def test_model_at_width_passes_the_checks(monkeypatch, c, warp_impl):
    """PnPVCVE at mid_channels 8 and 128 with every launch replaced by its
    argument check and then the plain version: each step's arguments pass,
    the counts are a pass's, and the output is the plain path's."""
    counts = dict.fromkeys(K.LAUNCHES, 0)

    def stand_in(name, check, plain):
        def run(*a):
            check(*a[:2] if name in ("warp", "warp_block") else a)
            counts[name] += 1
            return plain(*a)
        return run

    for mod in (kw, kd):
        monkeypatch.setattr(mod, "on_cpu", lambda x: False)
    monkeypatch.setattr(kw, "_launch", stand_in("warp", kw.warp_args, kw.flow_warp_plain))
    monkeypatch.setattr(kw, "_block_launch", stand_in("warp_block", kw.warp_block_args,
                                                      kw.flow_warp_block_plain))
    monkeypatch.setattr(kd, "_input_conv_launch", stand_in("input_conv", kd.input_conv_args,
                                                           kd.input_conv_plain))
    monkeypatch.setattr(kd, "_drt_block_launch", stand_in("drt_block", kd.drt_block_args,
                                                          kd.drt_block_plain))
    monkeypatch.setattr(kd, "_head_launch", stand_in("head", kd.head_args, kd.head_plain))
    model = build_generator(dict(type="PnPVCVE", mid_channels=c, num_blocks=2, num_experts=2,
                                 use_pallas_kernels=True, warp_impl=warp_impl), device="cpu",
                            seed=c)
    rng = np.random.default_rng(c)
    b, t, h, w = 1, 3, 16, 24
    inputs = dict(
        lrs=rng.random((b, t, h, w, 3), np.float32), qps=rng.random((b, t), np.float32),
        slices=np.array([[73.0, 66.0, 80.0]], np.float32),
        mvs=rng.uniform(-6, 6, (b, t, h, w, 4)).astype(np.float32),
        base_qps=np.full((b, t), 35 / 255.0, np.float32),
        par_map=((rng.random((b, t, h, w, 3)) > 0.5) / 255.0).astype(np.float32))
    inputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.inference_mode():
        got = model(**inputs)
        model.ops = K.PLAIN
        want = model(**inputs)
    k1 = "warp" if warp_impl == "padgather" else "warp_block"
    assert counts == {**dict.fromkeys(K.LAUNCHES, 0), k1: 2 * t, "input_conv": 2 * t,
                      "drt_block": 2 * 2 * t, "head": t}
    torch.testing.assert_close(got, want, rtol=0, atol=0)
