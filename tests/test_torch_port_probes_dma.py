"""The probe kernels that move data, K6 and K11-K13 (B10b), the port against
the JAX package's probe tools tools/warp_kernel_probe.py and
tools/dma_probe.py, on the CPU (the port runs its kernels' plain versions
here; the JAX Pallas kernels run in interpret mode).

Each JAX probe file is run as it is, its module constants shrunk with
monkeypatch (they are read at trace time) and its ``timeit`` cut to one call
(warp_kernel_probe, its ``stage`` swapped for a recorder of the outputs), or
its ``N`` cut to 2 (dma_probe, whose ``run`` and ``run_pipelined`` return
nothing: each step kernel is reached by wrapping the module's
``pl.pallas_call`` and applied once more to the seeded input). The port's
tools run with ``--device cpu`` at the same shapes: the same numpy seed
gives both the same inputs.

Tolerances: every stage bitwise. K6 (the floor's window copy, a doubling),
K12 (a float32 sum of two bf16 values, halved, one rounding) and K13 (copies)
are exact in any order. K11 (probe_select) is a fused multiply-add of two
live taps a pass, in the TPU kernel's order, as XLA compiles it; it is held
bitwise at two shapes. At these sizes an unfused sum rounds to the same
bf16 values as well, so the test holds the result, not the order.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import probes as P

from test_torch_port_probes import _bitwise, _interpret, _tool

# one intra-op thread a process: the test workers run side by side, and
# thread pools that each span every core slow small CPU ops many times over
torch.set_num_threads(1)

WKP_SHAPES = [((16, 256), 8), ((24, 384), 16)]  # ((H, W), C)
DMA_HW, DMA_LANES, DMA_N = (48, 48), 128, 2


# ---- tools/warp_kernel_probe.py: K6, K11, K12 --------------------------------------------------


@pytest.fixture(scope="module", params=WKP_SHAPES, ids=lambda s: f"{s[0][0]}x{s[0][1]}x{s[1]}")
def wkp_runs(request):
    (h, w), c = request.param
    jax_probe = _tool("warp_kernel_probe")
    outs = {}

    def record(name, fn):
        ms, out = fn()
        outs[name] = out
        return ms

    with pytest.MonkeyPatch.context() as mp, _interpret():
        for k, v in dict(H=h, W=w, C=c, NBY=h // 8, NBX=w // 8, WP=w + 64, HP=h + 40).items():
            mp.setattr(jax_probe, k, v)
        mp.setattr(jax_probe, "stage", record)
        mp.setattr(jax_probe, "timeit", lambda f, *a, n=30: (0.0, f(*a)))
        jax_probe.main()
    port = _tool("torch_warp_kernel_probe").main([
        "--device", "cpu", "--hw", str(h), str(w), "--channels", str(c), "--n", "1"])
    return outs, port


@pytest.mark.parametrize("name", ["band DMA floor", "dense select (35H+35V)",
                                  "per-block window DMAs (320/band)"])
def test_warp_kernel_probe_matches_jax(wkp_runs, name):
    """tools/torch_warp_kernel_probe.py on the CPU (K6's, K11's and K12's
    plain versions) against probe_floor, probe_select and probe_dma, the
    last in its block-major layout as it stands."""
    jax_outs, port = wkp_runs
    assert port[name]["out"] is not None
    _bitwise(port[name]["out"], jax_outs[name])


def test_gather2_takes_the_tpu_kernels_shift_range():
    """K11's plain version on shifts at and past the ends of the TPU's 35
    (k = -1: only the wx1 tap, at shift 0; k = 34: only wx0; beyond: none),
    against a dense masked sum written as the TPU kernel's loops."""
    rng = np.random.default_rng(3)
    nb, w, c, x0 = 2, 16, 8, 15
    xp = P.bf16_from_numpy(rng.standard_normal((1, 8 * nb + 40, w + 64, c)), "cpu")
    shidx = torch.from_numpy(rng.choice([-2, -1, 0, 17, 33, 34, 35], (nb, w)).astype(np.int32))
    dyidx = torch.from_numpy(rng.choice([-2, -1, 0, 9, 33, 34, 35], (nb, w)).astype(np.int32))
    wx0, wx1, wy0, wy1 = (torch.from_numpy(rng.random((nb, w)).astype(np.float32))
                          for _ in range(4))
    got = P.gather2(xp, shidx, wx0, wx1, dyidx, wy0, wy1, x0)
    xd = xp[0].double()
    want = torch.zeros((nb, 8, w, c), dtype=torch.float64)
    for ri in range(nb):
        band = xd[8 * ri:8 * ri + 48]
        hband = torch.zeros((48, w, c), dtype=torch.float64)
        for s in range(35):
            ws = (torch.where(shidx[ri] == s, wx0[ri], 0.0)
                  + torch.where(shidx[ri] == s - 1, wx1[ri], 0.0)).double()
            hband += band[:, s + x0:s + x0 + w] * ws[None, :, None]
        hband = hband.float().to(torch.bfloat16).double()
        for d in range(35):
            wd = (torch.where(dyidx[ri] == d, wy0[ri], 0.0)
                  + torch.where(dyidx[ri] == d - 1, wy1[ri], 0.0)).double()
            want[ri] += hband[d:d + 8] * wd[None, :, None]
    want = want.float().to(torch.bfloat16).reshape(1, 8 * nb, w, c)
    # the dense sum in float64 rounds once where the kernel rounds twice a
    # pass: equal to one bf16 ulp, and equal where a tap lies out of range
    diff = (got.float() - want.float()).abs()
    ulp = 2.0 ** (torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
    assert bool((diff <= ulp).all())
    dead = ((shidx < -1) | (shidx > 34))[:, None, :].expand(nb, 8, w).reshape(1, 8 * nb, w)
    assert not got[dead].any() and not want[dead].any()


def test_gather2_plain_fma_rounds_once():
    """K11's plain fused multiply-add rounds the exact ``a * w + acc`` once
    to float32, as the card's ``__fmaf_rn`` does, also where a float64 sum
    rounded again to float32 is one ulp off (terms far apart in exponent)."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    n = 400_000
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    w, acc = (torch.from_numpy((rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n))
                               .astype(np.float32)) for _ in range(2))
    got = P._fma(a, w, acc)
    twice = (a.double() * w.double() + acc.double()).float()
    off = (got != twice).nonzero().flatten().tolist()
    assert off  # the inputs reach the double rounding

    def nearest(x):  # float32 nearest to the rational x, ties to even
        f = np.float32(float(x))
        cands = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
        return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                         int(np.float32(v).view(np.uint32)) & 1))

    for i in off + list(range(200)):
        exact = Fraction(float(a[i])) * Fraction(float(w[i])) + Fraction(float(acc[i]))
        assert np.float32(got[i].item()) == nearest(exact), i


def test_bounds_count_the_distinct_pixels_the_tables_pick():
    """tools/torch_kernel_bounds.py's K11 and K12 input bytes are the
    distinct pixels their taps read, against a set of (row, column) pairs
    built from the plain versions' index rules, on the probe tool's seeded
    tables."""
    kb = _tool("torch_kernel_bounds")
    wkp = _tool("torch_warp_kernel_probe")
    (h, w), c = WKP_SHAPES[1]
    hp, wp, x0 = h + 40, w + 64, wkp.X0
    _, sy, sx, shidx, dyidx, *_ = wkp.draw_inputs(h, w, c, with_input=False)
    blocks = {(min(max(y, 0), hp - 9) + dy + r, min(max(x + 8 * dy, 0), wp - 8) + cc)
              for y, x in zip(sy.tolist(), sx.tolist()) for dy in (0, 1)
              for r in range(8) for cc in range(8)}
    nblk = len(sy)
    assert kb.block_windows_work(sy, sx, hp, wp, c)["bytes"] == (
        len(blocks) * c * 2 + nblk * (64 * c * 2 + 8))
    assert len(blocks) < 2 * 64 * nblk  # the windows overlap
    taps = {(8 * ri + d + j, x + k + x0 + t)
            for ri in range(h // 8) for x in range(w)
            for k, d in [(int(shidx[ri, x]), int(dyidx[ri, x]))] for j in range(9)
            for t in (0, 1) if -t <= k < 35 - t}  # a live weight: its shift within the 35
    assert kb.gather2_work(shidx, dyidx, hp, wp, c, x0)["bytes"] == (
        len(taps) * c * 2 + h * w * c * 2 + 6 * (h // 8) * w * 4)
    # the tables are the tool's: its input is the one the same draws give
    xp, *tables = wkp.draw_inputs(h, w, c)
    assert all(np.array_equal(t, u) for t, u in zip(tables, (sy, sx, shidx, dyidx)))


# ---- tools/dma_probe.py: K13 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def dma_runs():
    """Each step kernel of run (split 1, 2, 4 x write_out) and run_pipelined
    (write_out) applied to the seeded input, and the port's tool in both
    modes on the CPU."""
    import jax.numpy as jnp

    dma = _tool("dma_probe")
    hp, wp = DMA_HW
    steps, refs = [], {}
    real = dma.pl.pallas_call

    def recording_call(*a, **k):
        steps.append(real(*a, **k))
        return steps[-1]

    rng = np.random.default_rng(0)
    zpf = jnp.asarray(rng.standard_normal((1, hp, wp, DMA_LANES)).astype(np.float32),
                      jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp, _interpret():
        mp.setattr(dma, "HP", hp)
        mp.setattr(dma, "WP", wp)
        mp.setattr(dma, "N", DMA_N)
        mp.setattr(dma.pl, "pallas_call", recording_call)
        for split in (1, 2, 4):
            for write_out in (False, True):
                dma.run(split, write_out, 3)
                refs[f"split={split} out={int(write_out)} depth=3"] = steps[-1](zpf)
        for write_out in (False, True):
            dma.run_pipelined(write_out)
            refs[f"pipelined out={int(write_out)}"] = steps[-1](zpf)
    tool = _tool("torch_dma_probe")
    common = ["--device", "cpu", "--hw", str(hp), str(wp), "--n", "1", "--chain", str(DMA_N)]
    port = tool.main(common)
    port.update(tool.main(common + ["--mode", "pipelined"]))
    return refs, port


@pytest.mark.parametrize("label", [f"split={s} out={w} depth=3" for s in (1, 2, 4) for w in (0, 1)]
                         + ["pipelined out=0", "pipelined out=1"])
def test_dma_probe_matches_jax(dma_runs, label):
    """tools/torch_dma_probe.py on the CPU (K13's plain version) against
    run's and run_pipelined's step kernels: the array itself, or the last
    chunk's first row (1, 8, 128)."""
    refs, port = dma_runs
    assert port[label]["out"] is not None and port[label]["ms"] is not None
    _bitwise(port[label]["out"], refs[label])


def test_probe_wrappers_refuse_what_they_cannot_take_b10b():
    """Shape checks of K11-K13 that hold on every device."""
    xp = torch.zeros((1, 40, 80, 8), dtype=torch.bfloat16)
    tab_i = torch.zeros((1, 16), dtype=torch.int32)
    tab_f = torch.zeros((1, 16))
    with pytest.raises(ValueError, match="does not hold the taps"):
        P.gather2(xp, tab_i, tab_f, tab_f, tab_i, tab_f, tab_f, x0=40)
    with pytest.raises(ValueError, match="block_windows"):
        P.block_windows(xp, torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                        16, 12)
    with pytest.raises(ValueError, match="split"):
        P.ring_copy(torch.zeros((1, 16, 8, 8), dtype=torch.bfloat16), split=3)
    with pytest.raises(ValueError, match="multiple of 8"):
        P.stream_copy(torch.zeros((1, 12, 8, 8), dtype=torch.bfloat16))
