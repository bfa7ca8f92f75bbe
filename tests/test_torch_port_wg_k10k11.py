"""K10's int8 form on ``wgmma`` (``tapconv`` with int8 inputs;
csrc/probe_tapconv.cu: tapconv8_wg) and K11's design (``gather2``;
csrc/probe_gather.cu: gather2_kernel): what the CPU can check of them, and
on the card the kernels against their plain versions.

On the CPU: the items the int8 wrapper hands its kernel, as the kernel
decodes them (``probes.tapconv8_items``), at 132 and 7 SMs: each output
(row, column, channel) exactly once, the grid a multiple of the output
parts and every block's items in one part (its weights stay resident); the
schedule's choices (4- or 8-row items, the mma.sync design past cin 256);
the shared memory against the layout's arithmetic and the source's limits;
the resident weights' image (the kernel's byte permutes and 64-byte
swizzle, emulated) read back through the K-major descriptor's addressing
equal to the weights; the patch's swizzled pixel addressing the tensor
map's 64-byte swizzle. K11: every (band, column, vector) in exactly one
thread, a block's threads in one band. Then what the wrappers hand the C
entries, and what they refuse.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_wg_k10k11.py``): each kernel bitwise against its
plain version with one counted launch, at the probes' shapes, K5's 720p
geometry (K10) and edge shapes and tables.

The JAX parity of the plain versions is test_torch_port_probes.py's and
test_torch_port_probes_dma.py's.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import probes as P
from pnp_vcve_torch.kernels.launch import SMEM_MAX

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

# (rows, cols, cin, cout): the probe's k4; K5's 720p geometry; ragged rows
# and columns; cin 32 with cout 8; cin 96 (a chunk half past cin) with three
# output parts; cin 256 (four chunks: 4-row items only)
TAPCONV8_SHAPES = {"probe": (16, 320, 128, 128), "k5_geometry": (720, 1280, 64, 64),
                   "ragged": (5, 18, 64, 24), "cin32": (5, 18, 32, 8),
                   "cin96_cout136": (13, 45, 96, 136), "cin256": (37, 100, 256, 64),
                   "ragged_large": (100, 600, 64, 64)}


@pytest.mark.parametrize("case", list(TAPCONV8_SHAPES))
@pytest.mark.parametrize("sms", [132, 7])
def test_tapconv8_items_cover_each_output_once(sms, case):
    rows, cols, cin, cout = TAPCONV8_SHAPES[case]
    sc = P.tapconv8_schedule(rows, cols, cin, cout, sms)
    blocks = P.tapconv8_items(rows, cols, cin, cout, sms)
    assert sc["nm"] in (1, 2) and len(blocks) == sc["grid"] <= sc["items"]
    assert sc["grid"] % sc["ncp"] == 0 and sc["smem"] <= SMEM_MAX
    assert sc["chunks"] == -(-cin // 64)
    counts = [len(b) for b in blocks]
    assert sum(counts) == sc["items"] and max(counts) - min(counts) <= 1
    hit = torch.zeros((rows, cols, cout), dtype=torch.int32)
    for k, blk in enumerate(blocks):
        assert {n0 for _, _, n0 in blk} == {64 * (k % sc["ncp"])}  # one part: resident weights
        for y0, x0, n0 in blk:
            assert y0 < rows and x0 < cols and n0 < cout
            hit[y0:y0 + sc["tile_rows"], x0:x0 + P.TAPCONV_COLS, n0:n0 + P.TAPCONV_COUT] += 1
    assert int(hit.min()) == 1 and int(hit.max()) == 1


def test_tapconv8_schedule_choices():
    """The probe's 16 x 320 x 128: 80 four-row items on 80 blocks; K5's 720p:
    3600 eight-row items on 132; cin 256 fits only 4-row items; past cin
    256 the resident weights do not fit: nm 0, the mma.sync design; three
    output parts on 132 SMs: 132 blocks (a multiple of 3), on 100: 99."""
    assert [P.tapconv8_schedule(16, 320, 128, 128, 132)[k] for k in ("nm", "items", "grid")] == \
        [1, 80, 80]
    assert [P.tapconv8_schedule(720, 1280, 64, 64, 132)[k] for k in ("nm", "items", "grid")] == \
        [2, 3600, 132]
    assert P.tapconv8_schedule(720, 1280, 256, 64, 132)["nm"] == 1
    assert P.tapconv8_schedule(720, 1280, 192, 64, 132)["nm"] == 2
    assert P.tapconv8_schedule(64, 64, 288, 64, 132)["nm"] == 0
    assert P.tapconv8_schedule(720, 1280, 64, 136, 132)["grid"] == 132
    assert P.tapconv8_schedule(720, 1280, 64, 136, 100)["grid"] == 99


def test_tapconv8_smem_is_the_layouts():
    """1024 bytes of alignment slack, 9 taps x chunks tiles of 64 x 64 int8,
    two patch buffers of (4 nm + 2) x 34 pixels of 64 bytes (each rounded
    up to 1024), two consumer warpgroups' two float32 output boxes of 2 nm
    rows x 32 pixels x 32 channels, four 8-byte barriers; the source's
    static_assert limits (nm 1 to 4 chunks, nm 2 to 3) are where the sum
    meets SMEM_MAX; the probe's is what the C entry pnp_tapconv8_smem
    reports (phase 2 holds the two equal)."""
    for nm in (1, 2):
        for chunks in range(1, 6):
            patch = -(-(4 * nm + 2) * 34 * 64 // 1024) * 1024
            want = 1024 + 9 * chunks * 4096 + 2 * patch + 2 * 2 * (2 * nm * 32 * 128) + 32
            assert P.tapconv8_smem(nm, chunks) == want
    assert P.tapconv8_smem(1, 4) <= SMEM_MAX < P.tapconv8_smem(1, 5)
    assert P.tapconv8_smem(2, 3) <= SMEM_MAX < P.tapconv8_smem(2, 4)
    assert P.tapconv8_schedule(16, 320, 128, 128, 132)["smem"] == P.tapconv8_smem(1, 2) == 134176


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the 8 bytes y:x (x the low four)."""
    b = [(x >> 8 * i) & 255 for i in range(4)] + [(y >> 8 * i) & 255 for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _weight_image(w, co0):
    """The kernel's stage_weights on int8 ``w (3, 3, cin, cout)``: each unit
    of 4 input x 8 output channels loaded as four 8-byte rows (two
    little-endian words each), turned by the same byte permutes, stored at
    the 64-byte swizzled place."""
    cin, cout = w.shape[2], w.shape[3]
    nch = -(-cin // 64)
    wf = w.reshape(9, cin, cout).view(np.uint8)
    img = np.zeros(9 * nch * 4096, np.uint8)
    for u in range(9 * nch * 128):
        n, kq, tile = 8 * (u % 8), 4 * ((u // 8) % 16), u // 128
        tap, k = tile // nch, 64 * (tile % nch) + kq
        rows = [bytes(wf[tap, k + i, co0 + n:co0 + n + 8]) if k + i < cin and co0 + n < cout
                else bytes(8) for i in range(4)]
        col = []
        for h in range(2):
            x = [int.from_bytes(r[4 * h:4 * h + 4], "little") for r in rows]
            lo01, hi01 = _byte_perm(x[0], x[1], 0x5140), _byte_perm(x[0], x[1], 0x7362)
            lo23, hi23 = _byte_perm(x[2], x[3], 0x5140), _byte_perm(x[2], x[3], 0x7362)
            col += [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
                    _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
        for st in range(8):
            j = (st + n // 8) & 7
            row = n + j
            at = tile * 4096 + row * 64 + (((kq >> 4) ^ ((row >> 1) & 3)) << 4) + (kq & 15)
            img[at:at + 4] = np.frombuffer(col[j].to_bytes(4, "little"), np.uint8)
    return img


@pytest.mark.parametrize("cin,cout,co0", [(64, 64, 0), (96, 136, 128), (32, 24, 0),
                                          (128, 128, 64)])
def test_resident_weights_read_back_through_the_descriptor(cin, cout, co0):
    """B[k][n] of tap t, read where a K-major 64-byte swizzled descriptor
    finds it (tile (t, k // 64), row n at 64 n, k's 16-byte chunk j at j ^
    ((n / 2) % 4)), is w[t, k, co0 + n]; zeros past cin and cout."""
    rng = np.random.default_rng(cin + cout)
    w = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    img = _weight_image(w, co0).view(np.int8)
    nch = -(-cin // 64)
    for t in range(9):
        for k in range(64 * nch):
            for n in range(64):
                tile = t * nch + k // 64
                at = tile * 4096 + n * 64 + ((((k % 64) >> 4) ^ ((n >> 1) & 3)) << 4) + k % 16
                want = w.reshape(9, cin, cout)[t, k, co0 + n] if k < cin and co0 + n < cout else 0
                assert img[at] == want, (t, k, n)


def test_patch_addressing_is_the_tensor_maps_swizzle():
    """tapconv8_wg's xpiece: pixel q's 16-byte piece j at 64 q + 16 (j ^ ((q
    / 2) % 4)), where the tensor map's 64-byte swizzle puts it (tma.cuh:
    chunk j at j ^ ((a / 128) % 4) of a 1024-aligned buffer); ldmatrix's 8
    rows (8 consecutive pixels, one piece each) fall in 8 distinct 16-byte
    bank groups."""
    for q in range(340):
        for j in range(4):
            a = 64 * q + 16 * j
            assert 64 * q + 16 * (j ^ ((q >> 1) & 3)) == 64 * q + 16 * (j ^ ((a // 128) % 4))
    for q0 in range(0, 64):
        for j in range(4):
            banks = {(64 * q + 16 * (j ^ ((q >> 1) & 3))) % 128 // 16 for q in range(q0, q0 + 8)}
            assert len(banks) == 8


# (nb, w, c): the probe's 720p; ragged (a band's threads not a multiple of
# the block); 8 channels
GATHER_SHAPES = {"probe": (90, 1280, 64), "ragged": (3, 200, 24), "c8": (5, 77, 8)}


@pytest.mark.parametrize("case", list(GATHER_SHAPES))
def test_gather2_items_cover_each_column_once(case):
    nb, w, c = GATHER_SHAPES[case]
    blocks = P.gather2_items(nb, w, c)
    seen = [it for blk in blocks for it in blk]
    assert len(seen) == len(set(seen)) == nb * w * (c // 8)
    assert set(seen) == {(ri, x, v) for ri in range(nb) for x in range(w) for v in range(c // 8)}
    assert all(len(b) == P.GATHER_THREADS for b in blocks[:-1])
    if w * (c // 8) % P.GATHER_THREADS == 0:  # then a block's threads share one band
        assert all(len({ri for ri, _, _ in blk}) == 1 for blk in blocks)


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors with 132 SMs, recording what
    they hand the C entries instead of calling them."""
    calls = []
    monkeypatch.setattr(P, "on_cpu", lambda x: False)
    monkeypatch.setattr(P, "sm_count", lambda dev: 132)
    monkeypatch.setattr(P, "_call",
                        lambda name, entry, dev, *args: calls.append((name, entry, args)))
    return calls


def test_tapconv_int8_hands_its_schedule_to_the_kernel(fake_card):
    for cin, cout in ((128, 128), (320, 16)):
        band = torch.zeros((24, 656, cin), dtype=torch.int8)
        out = P.tapconv(band, torch.zeros((3, 3, cin, cout), dtype=torch.int8), 16, 320,
                        torch.ones(1))
        assert out.shape == (16, 320, cout) and out.dtype == torch.float32
    (n1, e1, a1), (n2, e2, a2) = fake_card
    sc = P.tapconv8_schedule(16, 320, 128, 128, 132)
    assert n1 == n2 == "tapconv_int8" and e1 == e2 == "pnp_tapconv"
    assert a1[0] == 2 and a1[5:] == (24, 656, 128, 128, 16, 320, sc["nm"], sc["grid"])
    assert a2[5:] == (24, 656, 320, 16, 16, 320, 0, 0)  # the mma.sync design


def test_gather2_hands_its_sizes_to_the_kernel(fake_card):
    nb, w, c, x0 = 2, 40, 16, 15
    xp = torch.zeros((1, 8 * nb + 34, w + x0 + 34, c), dtype=torch.bfloat16)
    ti, tf = torch.zeros((nb, w), dtype=torch.int32), torch.zeros((nb, w))
    out = P.gather2(xp, ti, tf, tf, ti, tf, tf, x0)
    ((name, entry, args),) = fake_card
    assert name == "gather2" and entry == "pnp_gather2" and out.shape == (1, 8 * nb, w, c)
    assert args[8:] == (nb, 8 * nb + 34, w + x0 + 34, w, c, x0)


def test_wrappers_refuse_what_the_kernels_cannot_take(fake_card):
    """int8 cin % 32, cout % 8, a missing or wrong scale; K11: channels % 8,
    x0 < 1, xp too small for the taps, tables of other shapes or types."""
    i8 = torch.int8
    with pytest.raises(ValueError, match="tapconv"):
        P.tapconv(torch.zeros((6, 20, 48), dtype=i8), torch.zeros((3, 3, 48, 16), dtype=i8), 4,
                  18, torch.ones(1))
    with pytest.raises(ValueError, match="tapconv"):
        P.tapconv(torch.zeros((6, 20, 64), dtype=i8), torch.zeros((3, 3, 64, 12), dtype=i8), 4,
                  18, torch.ones(1))
    with pytest.raises(ValueError, match="tapconv"):
        P.tapconv(torch.zeros((6, 20, 64), dtype=i8), torch.zeros((3, 3, 64, 16), dtype=i8), 4,
                  18)
    with pytest.raises(ValueError, match="tapconv"):
        P.tapconv(torch.zeros((6, 20, 64), dtype=i8), torch.zeros((3, 3, 64, 16), dtype=i8), 4,
                  18, torch.ones(2))
    nb, w, x0 = 2, 40, 15
    ti, tf = torch.zeros((nb, w), dtype=torch.int32), torch.zeros((nb, w))
    xp = torch.zeros((1, 8 * nb + 34, w + x0 + 34, 12), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gather2"):
        P.gather2(xp, ti, tf, tf, ti, tf, tf, x0)
    xp = torch.zeros((1, 8 * nb + 34, w + x0 + 34, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gather2"):
        P.gather2(xp, ti, tf, tf, ti, tf, tf, 0)
    with pytest.raises(ValueError, match="gather2"):
        P.gather2(xp[:, :-1], ti, tf, tf, ti, tf, tf, x0)
    with pytest.raises(ValueError, match="gather2"):
        P.gather2(xp, ti[:, :-1], tf, tf, ti, tf, tf, x0)
    with pytest.raises(TypeError, match="gather2"):
        P.gather2(xp, ti.float(), tf, tf, ti, tf, tf, x0)
    assert fake_card == []


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAPCONV8_SHAPES) + ["cin320"])
def test_tapconv_int8_kernel_wg(cuda, case):
    rows, cols, cin, cout = TAPCONV8_SHAPES.get(case, (6, 40, 320, 16))
    gen = torch.Generator().manual_seed(34)
    band = torch.randint(-127, 128, (rows + 5, cols + 7, cin), generator=gen,
                         dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8).to(cuda)
    scale = torch.tensor([0.0123], device=cuda)
    got = _one_launch("tapconv_int8", lambda: P.tapconv(band, w, rows, cols, scale))
    assert torch.equal(got, P.tapconv_plain(band, w, rows, cols, scale))


# (nb, w, c, x0, extra rows, extra columns): the probe's 720p; ragged; 8
# channels with x0 1 and xp as small as the wrapper takes
GATHER_CASES = {"probe": (90, 1280, 64, 15, 6, 15), "ragged": (3, 200, 24, 15, 6, 30),
                "c8_minimal": (5, 77, 8, 1, 0, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather2_kernel_new(cuda, case):
    """K11 bitwise to its plain version on shifts inside the TPU's 35, a few
    past both ends, and -1, 34 and 35 in every band."""
    nb, w, c, x0, ph, pw = GATHER_CASES[case]
    gen = torch.Generator().manual_seed(42)
    xp = torch.randn((1, 8 * nb + 34 + ph, w + x0 + 34 + pw, c), generator=gen).to(
        cuda, torch.bfloat16)
    tabs = []
    for _ in range(2):
        t = torch.randint(-2, 37, (nb, w), generator=gen, dtype=torch.int32)
        t[:, :3] = torch.tensor([-1, 34, 35], dtype=torch.int32)
        tabs.append(t.to(cuda))
    wts = [torch.rand((nb, w), generator=gen).to(cuda) for _ in range(4)]
    args = (xp, tabs[0], wts[0], wts[1], tabs[1], wts[2], wts[3], x0)
    got = _one_launch("gather2", lambda: P.gather2(*args))
    assert torch.equal(got.view(torch.int16), P.gather2_plain(*args).view(torch.int16))
