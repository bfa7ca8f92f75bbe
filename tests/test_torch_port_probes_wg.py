"""K7 (``mmsel_warp``, ``mmsel_h``; csrc/probe_mmsel.cu) and K10's bf16 form
(``tapconv``; csrc/probe_tapconv.cu) as persistent wgmma designs: what the
CPU can check of them, and on the card the kernels against their plain
versions.

On the CPU: the items each wrapper hands its kernel, as the kernel decodes
them (``probes.mmsel_items``, ``probes.tapconv_items``), at 132 and 7 SMs:
K7's (band, tile, row group, channel part) each exactly once at the
probe's 720p V mode, k_fori_dot's H mode at 128 and 64 lanes and ragged
shapes (one tile, dv < 40, 8 and 128 channels), the H mode's row groups
covering a band's 8 rows; K10's output (row, column, channel) each exactly
once at the probe's 16 x 320, at K5's 720p and at ragged sizes; the
blocks' counts within one of each other; a block's shared memory within
``SMEM_MAX``. The fused V pass's order: a replay that takes the H rows one
at a time and adds each into the output rows it reaches, d ascending,
equals ``mmsel_warp_plain`` bitwise. Then what the wrappers hand the C
entries.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_probes_wg.py``): each kernel against its plain
version with one counted launch, at the probes' shapes and ragged ones;
K7 by phase 3's bf16 bounds, an output also allowed one bf16 ulp of its
value, K10 bf16 within 1e-5 of max|ref|, K10 int8 bitwise (counted as
``tapconv_int8``; its design's own checks: test_torch_port_wg_k10k11.py).

The JAX parity of the plain versions is test_torch_port_probes.py's.
"""

import pytest
import torch

from pnp_vcve_torch.kernels import probes as P
from pnp_vcve_torch.kernels.launch import SMEM_MAX

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

# (nb, nt, c, dv, v_mode): the probe's 720p V mode; k_fori_dot at 128 and
# 64 lanes; one tile; a short V; 8 and 128 channels; 16 channels in H
MMSEL_SCHEDULES = {
    "probe_720p": (90, 10, 64, 40, True), "fori128": (8, 1, 128, 0, False),
    "fori64": (8, 1, 64, 0, False), "one_tile": (3, 1, 64, 40, True),
    "short_v": (3, 2, 16, 13, True), "c8": (2, 3, 8, 40, True), "c128": (4, 2, 128, 7, True),
    "h_c8": (3, 2, 8, 0, False), "h_c16_ragged": (3, 3, 16, 0, False),
}
# (rows, cols, cin, cout): the probe's k4 / k5; K5's 720p geometry; ragged
# (the last in 8-row items, neither side a multiple of the item's)
TAPCONV_SHAPES = {"probe": (16, 320, 128, 128), "k5_geometry": (720, 1280, 64, 64),
                  "ragged": (5, 18, 64, 24), "ragged_cin": (9, 33, 80, 136),
                  "ragged_large": (100, 600, 64, 64)}


@pytest.mark.parametrize("case", list(MMSEL_SCHEDULES))
@pytest.mark.parametrize("sms", [132, 7])
def test_mmsel_items_cover_each_part_once(sms, case):
    nb, nt, c, dv, v_mode = MMSEL_SCHEDULES[case]
    sc = P.mmsel_schedule(nb, nt, c, dv, v_mode, sms)
    blocks = P.mmsel_items(nb, nt, c, dv, v_mode, sms)
    assert len(blocks) == sc["grid"] == min(sms, sc["items"])
    counts = [len(b) for b in blocks]
    assert sum(counts) == sc["items"] and max(counts) - min(counts) <= 1
    assert sc["smem"] <= SMEM_MAX
    ncp = -(-c // P.MMSEL_CHANNELS)
    assert sc["ncp"] == ncp
    seen = {}
    for blk in blocks:
        for it in blk:
            seen[it] = seen.get(it, 0) + 1
    want = {(ri, tj, rg, cp) for ri in range(nb) for tj in range(nt) for rg in range(sc["nrg"])
            for cp in range(ncp)}
    assert set(seen) == want and set(seen.values()) == {1}
    if v_mode:  # a band's dv + 7 H rows in one item
        assert sc["nrg"] == 1 and sc["nrows"] == dv + P.BAND_ROWS - 1
    else:  # the row groups tile a band's 8 rows
        assert sc["rows_item"] * sc["nrg"] == P.BAND_ROWS == 8 and sc["nrows"] == sc["rows_item"]


def test_mmsel_h_mode_fills_the_card():
    """k_fori_dot's 8 bands: row groups of 2 rows (the kernel runs rows in
    pairs), 128 items at 128 lanes and 64 at 64, one wave on 132 SMs; at
    720p the V mode keeps whole bands."""
    assert P.mmsel_schedule(8, 1, 128, 0, False, 132)["items"] == 128
    assert P.mmsel_schedule(8, 1, 128, 0, False, 132)["rows_item"] == 2
    assert P.mmsel_schedule(8, 1, 64, 0, False, 132)["rows_item"] == 2
    assert P.mmsel_schedule(90, 10, 64, 40, True, 132)["items"] == 1800


def _replay_v(xp, s, vm):
    """The fused V pass as the kernel runs it: the H rows rounded to bf16
    one at a time, each added into every output row it reaches (d = r - i
    in [0, dv)), as a float64 sum of the exact product rounded to float32
    (the plain version's fused multiply-add), then dropped."""
    nb, dv = s.shape[0], vm.shape[2]
    nrows = dv + P.BAND_ROWS - 1
    hb = P._mmsel_hband(xp, s, nb, 0, nrows)  # (nb, nrows, 128 nt, c) bf16
    acc = [torch.zeros((nb,) + hb.shape[2:], dtype=torch.float32) for _ in range(P.BAND_ROWS)]
    for r in range(nrows):
        h = hb[:, r].double()
        for i in range(P.BAND_ROWS):
            d = r - i
            if 0 <= d < dv:
                acc[i] = (acc[i].double() + h * vm[:, :, d, None].double()).float()
    out = torch.stack(acc, 1).to(torch.bfloat16)
    return out.reshape(1, nb * P.BAND_ROWS, *hb.shape[2:])


@pytest.mark.parametrize("nb,nt,kw,c,dv", [(2, 2, 40, 8, 13), (3, 1, 184, 16, 40),
                                          (1, 2, 100, 8, 1)])
def test_fused_v_order_equals_the_plain_version_bitwise(nb, nt, kw, c, dv):
    gen = torch.Generator().manual_seed(nb + kw + dv)
    hs = P.BAND_ROWS * (nb - 1) + dv + P.BAND_ROWS - 1 + 3
    xp = torch.randn((1, hs, P.TILE * (nt - 1) + kw + 5, c), generator=gen).to(torch.bfloat16)
    s = (torch.randn((nb, nt, P.TILE, kw), generator=gen) * 0.1).to(torch.bfloat16)
    vm = torch.rand((nb, P.TILE * nt, dv), generator=gen)
    want = P.mmsel_warp_plain(xp, s, vm)
    got = _replay_v(xp, s, vm)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("case", list(TAPCONV_SHAPES))
@pytest.mark.parametrize("sms", [132, 7])
def test_tapconv_items_cover_each_output_once(sms, case):
    rows, cols, cin, cout = TAPCONV_SHAPES[case]
    sc = P.tapconv_schedule(rows, cols, cin, cout, sms)
    blocks = P.tapconv_items(rows, cols, cin, cout, sms)
    assert len(blocks) == sc["grid"] == min(sms, sc["items"])
    counts = [len(b) for b in blocks]
    assert sum(counts) == sc["items"] and max(counts) - min(counts) <= 1
    assert sc["smem"] <= SMEM_MAX and sc["chunks"] == -(-cin // 64)
    hit = torch.zeros((rows, cols, cout), dtype=torch.int32)
    for blk in blocks:
        for y0, x0, n0 in blk:
            assert y0 < rows and x0 < cols and n0 < cout  # no item wholly outside
            hit[y0:y0 + sc["tile_rows"], x0:x0 + P.TAPCONV_COLS, n0:n0 + P.TAPCONV_COUT] += 1
    assert int(hit.min()) == 1 and int(hit.max()) == 1


def test_tapconv_items_fill_the_card():
    """The probe's 16 x 320 x 128: 4-row items (80, where 8-row ones give
    40); K5's 720p: 8-row items (3600 on 132 blocks)."""
    probe = P.tapconv_schedule(16, 320, 128, 128, 132)
    assert (probe["nm"], probe["items"]) == (1, 80)
    k5 = P.tapconv_schedule(720, 1280, 64, 64, 132)
    assert (k5["nm"], k5["items"], k5["grid"]) == (2, 3600, 132)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors with 132 SMs, recording what
    they hand the C entries instead of calling them."""
    calls = []
    monkeypatch.setattr(P, "on_cpu", lambda x: False)
    monkeypatch.setattr(P, "sm_count", lambda dev: 132)
    monkeypatch.setattr(P, "_call", lambda name, entry, dev, *args: calls.append((entry, args)))
    return calls


def test_mmsel_hands_the_schedule_to_the_kernel(fake_card):
    nb, nt, kw, c, dv = 3, 2, 184, 16, 13
    xp = torch.zeros((1, 8 * (nb - 1) + dv + 7, 128 * (nt - 1) + kw, c), dtype=torch.bfloat16)
    s = torch.zeros((nb, nt, 128, kw), dtype=torch.bfloat16)
    vm = torch.zeros((nb, 128 * nt, dv))
    out = P.mmsel_warp(xp, s, vm)
    x = torch.zeros((1, 104, 320, 128), dtype=torch.bfloat16)
    P.mmsel_h(x, torch.zeros((1, 1, 128, 184), dtype=torch.bfloat16), 8, 16, 256)
    (e1, a1), (e2, a2) = fake_card
    sv = P.mmsel_schedule(nb, nt, c, dv, True, 132)
    sh = P.mmsel_schedule(8, 1, 128, 0, False, 132)
    assert e1 == e2 == "pnp_mmsel" and out.shape == (1, 8 * nb, 128 * nt, c)
    assert a1[4:] == (nb, nt, xp.shape[1], xp.shape[2], c, kw, nt * 128 * kw, 128 * kw, 0, dv,
                      128 * nt, 8, sv["grid"])
    assert a2[4:] == (8, 1, 104, 320, 128, 184, 0, 128 * 184, 16, 0, 256, sh["rows_item"],
                      sh["grid"])


def test_tapconv_hands_the_schedule_to_the_kernel(fake_card):
    band = torch.zeros((24, 656, 128), dtype=torch.bfloat16)
    P.tapconv(band, torch.zeros((3, 3, 128, 128), dtype=torch.bfloat16), 16, 320)
    P.tapconv(band.to(torch.int8), torch.zeros((3, 3, 128, 128), dtype=torch.int8), 16, 320,
              torch.ones(1))
    (e1, a1), (e2, a2) = fake_card
    sc = P.tapconv_schedule(16, 320, 128, 128, 132)
    sc8 = P.tapconv8_schedule(16, 320, 128, 128, 132)  # int8: its own wgmma design's
    assert e1 == e2 == "pnp_tapconv"
    assert a1[0] == 1 and a1[5:] == (24, 656, 128, 128, 16, 320, sc["nm"], sc["grid"])
    assert a2[0] == 2 and a2[5:] == (24, 656, 128, 128, 16, 320, sc8["nm"], sc8["grid"])


# ---- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    return torch.device("cuda")


def _one_launch(name, fn):
    P.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert P.LAUNCHES[name] == 1 and sum(P.LAUNCHES.values()) == 1
    return out


def _bf16_ulp(got, ref):
    """Phase 3's bf16 bounds (chip_smoke.py: _compare: max|diff| <= 0.02
    std(ref), mean|diff| <= 0.002 std(ref)), where an output may also be one
    bf16 ulp of its value off: the kernel and the plain version round float32
    sums of the same products, taken in other orders, and the two can
    straddle a rounding point."""
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    sd = float(ref.std()) or 1.0
    big = torch.maximum(got.abs(), ref.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)  # bf16: 8 significant bits
    diff = (got - ref).abs()
    worst = float((diff - torch.clamp_min(ulp, 0.02 * sd)).max())
    assert worst <= 0, (float(diff.max()), 0.02 * sd, worst)
    assert float(diff.mean()) <= 0.002 * sd, (float(diff.mean()), 0.002 * sd)


# (nb, nt, kw, c, dv, dense S): the probe's 720p (build_s's S); one tile; a
# short V over a depth no multiple of 8 (S staged by stores); 8 and 128
# channels
MMSEL_V_CASES = {"probe_720p": (90, 10, 184, 64, 40, False), "one_tile": (3, 1, 184, 64, 40, True),
                 "short_v_kw100": (3, 2, 100, 16, 13, True), "c8": (2, 3, 184, 8, 40, True),
                 "c128": (4, 2, 184, 128, 7, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MMSEL_V_CASES))
def test_mmsel_warp_kernel_wg(cuda, case):
    nb, nt, kw, c, dv, dense = MMSEL_V_CASES[case]
    gen = torch.Generator().manual_seed(31)
    xp = torch.randn((1, 8 * (nb - 1) + dv + 7 + 3, 128 * (nt - 1) + kw + 9, c),
                     generator=gen).to(cuda, torch.bfloat16)
    w = 128 * nt
    if dense:
        s = (torch.randn((nb, nt, 128, kw), generator=gen) * 0.1).to(cuda, torch.bfloat16)
    else:
        m0 = (torch.arange(w) + 32)[None] + torch.randint(-17, 18, (nb, w), generator=gen)
        s = P.build_s(m0.to(cuda), torch.rand((nb, w), generator=gen).to(cuda),
                      torch.rand((nb, w), generator=gen).to(cuda))
    vm = torch.rand((nb, w, dv), generator=gen).to(cuda)
    got = _one_launch("mmsel", lambda: P.mmsel_warp(xp, s, vm))
    _bf16_ulp(got, P.mmsel_warp_plain(xp, s, vm))


# (lanes, h, w, kw): k_fori_dot at 128 and 64 lanes; ragged (16 lanes, two
# tiles and 44 zero columns, a depth no multiple of 8)
MMSEL_H_CASES = {"fori128": (128, 64, 256, 184), "fori64": (64, 64, 256, 184),
                 "ragged": (16, 24, 300, 100)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MMSEL_H_CASES))
def test_mmsel_h_kernel_wg(cuda, case):
    lanes, h, w, kw = MMSEL_H_CASES[case]
    gen = torch.Generator().manual_seed(32)
    x = torch.randn((1, h + 40, w + 64, lanes), generator=gen).to(cuda, torch.bfloat16)
    nt = w // 128
    s = (torch.randn((1, nt, 128, kw), generator=gen) * 0.1).to(cuda, torch.bfloat16)
    got = _one_launch("mmsel", lambda: P.mmsel_h(x, s, h // 8, 16, w))
    assert not got[..., 128 * nt:, :].any()
    _bf16_ulp(got, P.mmsel_h_plain(x, s, h // 8, 16, w))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(TAPCONV_SHAPES))
def test_tapconv_kernel_wg(cuda, case, form):
    rows, cols, cin, cout = TAPCONV_SHAPES[case]
    if form == "int8" and cin % 32:
        cin = 96  # int8 takes cin % 32 == 0
    gen = torch.Generator().manual_seed(33)
    shape = (rows + 2 + 1, cols + 2 + 3, cin)
    if form == "bf16":
        band = torch.randn(shape, generator=gen).to(cuda, torch.bfloat16)
        w = (torch.randn((3, 3, cin, cout), generator=gen) * 0.05).to(cuda, torch.bfloat16)
        scale = None
    else:
        band = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(cuda)
        w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8).to(cuda)
        scale = torch.tensor([0.0123], device=cuda)
    got = _one_launch("tapconv" if form == "bf16" else "tapconv_int8",
                      lambda: P.tapconv(band, w, rows, cols, scale))
    ref = P.tapconv_plain(band, w, rows, cols, scale)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if form == "bf16":
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert torch.equal(got, ref)
