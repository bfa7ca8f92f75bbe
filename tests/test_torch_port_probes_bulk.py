"""K13 (``ring_copy``, ``stream_copy``; csrc/probe_ring.cu) as persistent
bulk-copy designs, and K6 (``window_copy``; csrc/probe_copy.cu): what the
CPU can check of them, and on the card the kernels against their plain
versions.

On the CPU: the work list ``ring_copy`` hands its kernel, as the kernel
decodes it (``probes.ring_items``), at 132 and 7 SMs, split 1 / 2 / 4,
depth 0 / 3 / 9 and 128 and 8 lanes, on the probe's (736, 656) array, on a
ragged (8, 9) one and on one wide row of chunks (8, 8192): every byte of
the array in exactly one item; every copy 16-byte aligned, a multiple of
16 bytes and within one stage; no item crossing a column segment; items in
chunk order; the blocks' counts within one of each other; a block's shared
memory within ``SMEM_MAX`` at every depth the wrapper takes. Then what the
wrappers hand the C entries, and the plain route on CPU tensors.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_probes_bulk.py``): ``ring_copy`` over split x depth
{0, 1, 3, 9} x write_out, ``stream_copy`` both ways and ``window_copy`` in
both forms, at the probes' shapes and ragged ones, each bitwise against its
plain version with one counted launch. The wide array at depth 1 without
write_out gives a block several items after the one holding the output
row, so the ring refills that item's stage while its store may still read
it unless every step closes a bulk group.

The JAX parity of the plain versions is test_torch_port_probes.py's and
test_torch_port_probes_dma.py's.
"""

import pytest
import torch

from pnp_vcve_torch.kernels import probes as P
from pnp_vcve_torch.kernels.launch import SMEM_MAX

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

RING_SHAPES = {"probe": (1, 736, 656, 128), "ragged": (1, 8, 9, 128), "wide": (1, 8, 8192, 128)}
# (nb, out_h, out_w, lanes, period): probe_floor128, probe_floor, k_dma 64 /
# 128, k_nodma, and ragged windows
WINDOW_CASES = {
    "probe_floor128": (1, 720, 640, 128, 0), "probe_floor": (1, 720, 1280, 64, 0),
    "k_dma64": (1, 64, 256, 64, 0), "k_dma128": (1, 64, 256, 128, 0),
    "k_nodma64": (1, 64, 256, 64, 8), "ragged": (2, 5, 3, 8, 0),
    "ragged_period": (2, 7, 3, 8, 3), "period_above_rows": (1, 5, 9, 16, 9),
}


def _with_lanes(shape, lanes):
    return shape[:3] + (lanes,)


@pytest.mark.parametrize("lanes", [128, 8])
@pytest.mark.parametrize("shape", list(RING_SHAPES))
@pytest.mark.parametrize("depth", [0, 3, 9])
@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("sms", [132, 7])
def test_ring_items_cover_each_byte_once(sms, split, depth, shape, lanes):
    shape = _with_lanes(RING_SHAPES[shape], lanes)
    _, hp, wp, _ = shape
    sc = P.ring_schedule(shape, split, depth, sms)
    blocks = P.ring_items(shape, split, depth, sms)
    assert len(blocks) == sc["grid"] == min(sms, sc["items"])
    counts = [len(b) for b in blocks]
    assert sum(counts) == sc["items"] and max(counts) - min(counts) <= 1
    assert sc["smem"] <= SMEM_MAX
    row_bytes = wp * lanes * 2
    seen = {}
    for blk in blocks:
        chunks = [it[0] for it in blk]
        assert chunks == sorted(chunks)  # each block walks the chunks in order
        for chunk, s, r, lo, hi in blk:
            assert lo % 16 == 0 and hi % 16 == 0 and 0 < hi - lo <= sc["stage_bytes"]
            seg_lo = 16 * (sc["nvec"] * s // split)
            seg_hi = 16 * (sc["nvec"] * (s + 1) // split)
            assert seg_lo <= lo and hi <= seg_hi  # within its column segment
            seen.setdefault((chunk, r), []).append((lo, hi))
    assert len(seen) == hp  # every row of every chunk
    for spans in seen.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == row_bytes
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # no gap, no overlap


def test_ring_items_keep_chunk_order_across_blocks():
    """Item i goes to block i % grid: at every step the blocks copy items
    of the same or neighbouring chunks, in chunk order, as the TPU's ring."""
    shape = RING_SHAPES["probe"]
    blocks = P.ring_items(shape, 4, 3, 132)
    flat = [blocks[i % len(blocks)][i // len(blocks)] for i in range(sum(map(len, blocks)))]
    assert [it[0] for it in flat] == sorted(it[0] for it in flat)


@pytest.mark.parametrize("depth", range(P.RING_MAX_DEPTH + 1))
def test_ring_stages_fit_at_every_depth(depth):
    stage = P.ring_stage_bytes(depth)
    assert stage % 128 == 0 and stage <= P.RING_STAGE_MAX
    assert P.RING_BAR_BYTES + (depth + 1) * stage <= SMEM_MAX
    # a full stage where depth + 1 of them fit; else the largest that fits
    assert stage == P.RING_STAGE_MAX or P.RING_BAR_BYTES + (depth + 1) * (stage + 128) > SMEM_MAX


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors with 132 SMs, recording what
    they hand the C entries instead of calling them."""
    calls = []
    monkeypatch.setattr(P, "on_cpu", lambda x: False)
    monkeypatch.setattr(P, "sm_count", lambda dev: 132)
    monkeypatch.setattr(P, "_call", lambda name, entry, dev, *args: calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("split,depth,write_out", [(1, 3, True), (4, 0, False), (2, 9, True)])
def test_ring_copy_hands_the_schedule_to_the_kernel(fake_card, split, depth, write_out):
    z = torch.zeros((1, 16, 24, 64), dtype=torch.bfloat16)
    out = P.ring_copy(z, split, write_out, depth)
    (entry, args), = fake_card
    sc = P.ring_schedule(z.shape, split, depth, 132)
    assert entry == "pnp_ring_copy"
    assert args[2:] == (16, 24, 64, split, depth, int(write_out), sc["grid"], sc["pieces"])
    assert out.shape == (z.shape if write_out else (1, 8, 64))


def test_stream_copy_and_window_copy_hand_their_arguments(fake_card):
    z = torch.zeros((1, 16, 24, 64), dtype=torch.bfloat16)
    P.stream_copy(z, False)
    src = torch.zeros((1, 40, 48, 16), dtype=torch.bfloat16)
    P.window_copy(src, 20, 30, 4, 6, 8)
    (e1, a1), (e2, a2) = fake_card
    assert e1 == "pnp_stream_copy" and a1[2:] == (16, 24, 64, 0, P.stream_grid(132))
    assert e2 == "pnp_window_copy" and a2[2:] == (1, 40, 48, 20, 30, 16, 4, 6, 8)


@pytest.mark.parametrize("write_out", [True, False])
def test_copies_take_the_plain_route_on_the_cpu(write_out):
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((1, 16, 9, 8), generator=gen).to(torch.bfloat16)
    want = P.ring_copy_plain(z, write_out)
    for got in (P.ring_copy(z, 4, write_out, 9), P.stream_copy(z, write_out)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    src = torch.randn((2, 12, 9, 8), generator=gen).to(torch.bfloat16)
    for period in (0, 3):
        assert torch.equal(P.window_copy(src, 7, 5, 2, 3, period),
                           P.window_copy_plain(src, 7, 5, 2, 3, period))


# ---- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the chip)")
    return torch.device("cuda")


def _z(shape, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)


def _one_launch(name, fn):
    P.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert P.LAUNCHES[name] == 1 and sum(P.LAUNCHES.values()) == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(RING_SHAPES))
@pytest.mark.parametrize("write_out", [True, False])
@pytest.mark.parametrize("depth", [0, 1, 3, 9])
@pytest.mark.parametrize("split", [1, 2, 4])
def test_ring_copy_kernel(cuda, split, depth, write_out, shape):
    z = _z(RING_SHAPES[shape], cuda, split + depth)
    got = _one_launch("ring_copy", lambda: P.ring_copy(z, split, write_out, depth))
    want = P.ring_copy_plain(z, write_out)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(RING_SHAPES))
@pytest.mark.parametrize("write_out", [True, False])
def test_stream_copy_kernel(cuda, write_out, shape):
    z = _z(RING_SHAPES[shape], cuda, 7)
    got = _one_launch("stream_copy", lambda: P.stream_copy(z, write_out))
    want = P.ring_copy_plain(z, write_out)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_copy_kernel(cuda, case):
    nb, ho, wo, lanes, period = WINDOW_CASES[case]
    rows_in = min(period, ho) if period else ho
    src = _z((nb, rows_in + 20, wo + 40, lanes), cuda, ho + wo)
    got = _one_launch("window_copy", lambda: P.window_copy(src, ho, wo, 16, 24, period))
    want = P.window_copy_plain(src, ho, wo, 16, 24, period)
    assert got.shape == want.shape and torch.equal(got, want)
