"""K8's int8 form on ``wgmma`` s8 (``matmul`` with int8 inputs;
csrc/probe_matmul.cu: matmul8_wg) and K9 as one cooperative launch that
reads its input once (``absmax_quantize``; absmax_quantize_kernel): what
the CPU can check of them, and on the card the kernels against their plain
versions.

On the CPU: K8 int8's 64 x 64 tiles (``probes.matmul_tiles``) cover each
output exactly once, and past the resident B's depth the mma.sync design's;
B's K-major image (the kernel's byte permutes and 128-byte swizzle,
emulated) reads back through the descriptor's addressing equal to B, each
byte stored once and a warp's stores on 32 banks; the product emulated
k-step by k-step through the swizzled A box and the image, and the
epilogue's boxes read back as the tensor map's swizzle lays them, give
``matmul_plain`` bitwise; the shared memory against the layout. K9's
schedule and walk (``probes.absmax_schedule``, ``absmax_walk``): each
vector in exactly one block, held on chip or read again, the re-read part
walked backwards in pass two; the max taken over bf16 bit patterns, folded
and applied as the kernel does, against ``absmax_quantize_plain`` bitwise.
Then what the wrappers hand the C entries, and what they refuse; and the
plain versions against JAX's k2 and k3 (``tools/int8_probe.py``, interpret
mode) at ragged shapes.

On the card (marker ``cuda``; ``python -m pytest -m cuda --noconftest
tests/test_torch_port_wg_k8k9.py``): each kernel bitwise against its plain
version with one counted launch, at the probes' shapes, K5's 720p geometry
(K9) and edge shapes and values, K9 also replayed in a CUDA graph.
"""

import numpy as np
import pytest
import torch

from pnp_vcve_torch.kernels import probes as P
from pnp_vcve_torch.kernels.launch import SMEM_MAX

# one intra-op thread a process: the test workers run side by side
torch.set_num_threads(1)

I8 = torch.int8
BOX = 64 * 128  # an 8 KB A box or B image chunk: 64 rows of 128 bytes

# (m, k, n): the probe's; the edge shapes of chip_smoke.py phase 12 (m 16,
# 48 and 4112; n 8, 72 and 136; k 32 to 288); a depth past the resident B
MATMUL8_SHAPES = {"probe": (4096, 128, 128), "m16_k32_n8": (16, 32, 8),
                  "m48_k96_n72": (48, 96, 72), "m4112_k288_n136": (4112, 288, 136),
                  "m80_k160_n24": (80, 160, 24), "past_maxk": (32, 2080, 16)}


@pytest.mark.parametrize("case", list(MATMUL8_SHAPES))
def test_k8_int8_tiles_cover_each_output_once(case):
    m, k, n = MATMUL8_SHAPES[case]
    tm, tn, kc = P.matmul_tile_shape(I8, k)
    assert (tm, tn, kc) == ((64, 64, 128) if k <= P.MATMUL8_MAXK else (128, 64, 128))
    tiles = P.matmul_tiles(m, n, k, I8)
    assert len(tiles) == -(-m // tm) * -(-n // tn)
    hit = np.zeros((m, n), np.int64)
    for (m0, n0), chunks in tiles:
        assert chunks == list(range(0, k, kc))
        hit[m0:m0 + tm, n0:n0 + tn] += 1
    assert (hit == 1).all()


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of
    the 8 bytes y:x (x the low four)."""
    b = [(x >> 8 * i) & 255 for i in range(4)] + [(y >> 8 * i) & 255 for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _b_image(b, n0):
    """The kernel's stage_b on int8 ``b (k, n)`` for columns n0 .. n0 + 63:
    each unit of 4 depth rows x 8 columns loaded as four 8-byte rows (two
    little-endian words each), turned by the same byte permutes, stored at
    the 128-byte swizzled place. Returns the image, how often each byte was
    stored and, per unit, the addresses of its eight stores in order."""
    k, n = b.shape
    nk = -(-k // 128)
    bu = b.view(np.uint8)
    img = np.zeros(nk * BOX, np.uint8)
    stores = np.zeros(nk * BOX, np.int64)
    where = []
    for u in range(nk * 32 * 8):
        cg, k0 = u % 8, 4 * (u // 8)
        kc, kb, c = k0 // 128, k0 % 128, n0 + 8 * cg
        rows = [bytes(bu[k0 + i, c:c + 8]) if k0 + i < k and c < n else bytes(8) for i in range(4)]
        col = []
        for h in range(2):
            x = [int.from_bytes(r[4 * h:4 * h + 4], "little") for r in rows]
            lo01, hi01 = _byte_perm(x[0], x[1], 0x5140), _byte_perm(x[0], x[1], 0x7362)
            lo23, hi23 = _byte_perm(x[2], x[3], 0x5140), _byte_perm(x[2], x[3], 0x7362)
            col += [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
                    _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
        at_u = []
        for st in range(8):
            j = (st + cg) & 7
            row = 8 * cg + j
            at = kc * BOX + row * 128 + (((kb >> 4) ^ j) << 4) + (kb & 15)
            img[at:at + 4] = np.frombuffer(col[j].to_bytes(4, "little"), np.uint8)
            stores[at:at + 4] += 1
            at_u.append(at)
        where.append(at_u)
    return img, stores, where


def _sw128(rows, nbytes):
    """Byte offsets of (row, byte) in a 1024-aligned 128-byte swizzled
    operand: 16-byte piece p of row r at p ^ (r % 8) (a tensor map's
    128-byte boxes; wgmma.cuh: desc_sw128)."""
    r = np.asarray(rows)[:, None]
    c = np.arange(nbytes)[None, :]
    return r * 128 + ((c >> 4) ^ (r % 8)) * 16 + c % 16


@pytest.mark.parametrize("k,n,n0", [(128, 128, 0), (96, 72, 64), (288, 136, 128), (32, 8, 0)])
def test_b_image_reads_back_through_the_descriptor(k, n, n0):
    """B[kk][j], read where a K-major 128-byte swizzled descriptor finds it
    (chunk kk // 128, row j at 128 j, kk's 16-byte piece p at p ^ (j % 8)),
    is b[kk, n0 + j], zeros past k and n; each byte stored once; at each of
    the eight store steps a warp's 32 units store to 32 distinct banks."""
    rng = np.random.default_rng(k + n + n0)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    img, stores, where = _b_image(b, n0)
    assert (stores == 1).all()
    nk = -(-k // 128)
    kk = np.arange(128 * nk)
    off = _sw128(np.arange(64), 128)  # (row j, depth byte within the chunk)
    got = img.view(np.int8)[(kk // 128)[None, :] * BOX + off[:, kk % 128]]
    want = np.zeros((64, 128 * nk), np.int8)
    cols = min(64, n - n0)
    want[:cols, :k] = b[:, n0:n0 + cols].T
    np.testing.assert_array_equal(got, want)
    for w0 in range(0, len(where), 32):
        for st in range(8):
            banks = {(where[u][st] // 4) % 32 for u in range(w0, min(w0 + 32, len(where)))}
            assert len(banks) == min(32, len(where) - w0)


def _emulate_k8_int8(a, b, scale):
    """matmul8_wg tile by tile: A's box (64 rows x 128 bytes, zeros past m
    and k) laid out by the tensor map's 128-byte swizzle, B's image from
    ``_b_image``, each k-step's 64 x 32 x 64 product read through the
    descriptors' addressing, exact int64 sums; the epilogue's two boxes
    written at the kernel's addresses (d[4 j + 2 hf + e] of lane (g, t) of
    warp w: row 16 w + g + 8 hf, column 8 j + 2 t + e) and read back as the
    tensor map's swizzle lays them, clipped at m and n."""
    (m, k), n = a.shape, b.shape[1]
    nk = -(-k // 128)
    out = np.zeros((m, n), np.float32 if scale is not None else np.int32)
    written = np.zeros((m, n), np.int64)
    off = _sw128(np.arange(64), 128)
    for m0 in range(0, m, 64):
        for n0 in range(0, n, 64):
            img = _b_image(b, n0)[0].view(np.int8)
            acc = np.zeros((64, 64), np.int64)
            for kc in range(nk):
                box = np.zeros(BOX, np.int8)
                sa = a[m0:m0 + 64, 128 * kc:128 * kc + 128]
                box[off[:sa.shape[0], :sa.shape[1]]] = sa
                for ks in range(4):
                    cols = np.arange(32 * ks, 32 * ks + 32)
                    at = box[off[:, cols]].astype(np.int64)                   # (64 rows, 32)
                    bt = img[kc * BOX + off[:, cols]].astype(np.int64)        # (64 columns, 32)
                    acc += at @ bt.T
            boxes = np.zeros(2 * 64 * 32, out.dtype)
            for w in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    for j in range(8):
                        for hf in range(2):
                            r = 16 * w + g + 8 * hf
                            piece = 2 * (j % 4) + t // 2
                            for e in range(2):
                                byte = (j // 4) * BOX + r * 128 + ((piece ^ (r % 8)) << 4) + \
                                    (t % 2) * 8 + 4 * e
                                v = acc[r, 8 * j + 2 * t + e]
                                boxes[byte // 4] = (np.float32(np.float32(v) * scale)
                                                    if scale is not None else v)
            for bx in range(2):  # the tensor store: box bx is columns 32 bx .. + 31
                tile = boxes[bx * 2048 + _sw128(np.arange(64), 128)[:, ::4] // 4]
                rows, cols = min(64, m - m0), max(0, min(32, n - n0 - 32 * bx))
                out[m0:m0 + rows, n0 + 32 * bx:n0 + 32 * bx + cols] = tile[:rows, :cols]
                written[m0:m0 + rows, n0 + 32 * bx:n0 + 32 * bx + cols] += 1
    return torch.from_numpy(out), written


@pytest.mark.parametrize("form", ["int32", "scaled"])
@pytest.mark.parametrize("shape", [(48, 96, 72), (16, 288, 8), (80, 160, 136)])
def test_k8_int8_emulated_kernel_computes_the_product(shape, form):
    m, k, n = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = np.float32(0.0123) if form == "scaled" else None
    got, written = _emulate_k8_int8(a, b, scale)
    assert (written == 1).all()
    want = P.matmul_plain(torch.from_numpy(a), torch.from_numpy(b),
                          None if scale is None else torch.tensor([scale]))
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_k8_int8_shared_memory_is_the_layouts():
    """The slack, A's ring of four 8 KB boxes, B's image (8 KB a 128-deep
    chunk), two 8 KB output boxes, eight barriers; it fits at the deepest
    resident B and the probe's block takes 58,432 bytes."""
    for k in (32, 128, 160, 288, 1024, P.MATMUL8_MAXK):
        assert P.matmul8_smem(k) == 1024 + 4 * BOX + -(-k // 128) * BOX + 2 * BOX + 64
    assert P.matmul8_smem(128) == 58432
    assert P.matmul8_smem(P.MATMUL8_MAXK) <= SMEM_MAX


# ---- K9 ---------------------------------------------------------------------------------

# values: 8; the probes' k3 (4096 x 128) and k4 (24 x 656 x 128); K5's 720p
# geometry (722 x 1282 x 64); 70,001 vectors (odd: no block's slice divides
# it); 3,000,001 vectors (every block re-reads, the last ends on an odd vector)
ABSMAX_SIZES = {"eight": 8, "k3": 4096 * 128, "k4": 24 * 656 * 128,
                "k5_geometry": 722 * 1282 * 64, "odd": 8 * 70_001, "reread": 8 * 3_000_001}


@pytest.mark.parametrize("case", list(ABSMAX_SIZES))
@pytest.mark.parametrize("sms,bps", [(132, 2), (132, 1), (7, 2)])
def test_absmax_schedule_is_one_resident_wave(case, sms, bps):
    """At most blocks_per_sm x the SMs, every block some vectors, per even;
    the card full wherever each block would still get AQ_MIN_VECS."""
    n = ABSMAX_SIZES[case]
    n16 = n // 8
    sc = P.absmax_schedule(n, sms, bps)
    grid, per = sc["grid"], sc["per"]
    assert sc["vectors"] == n16 and 1 <= grid <= sms * bps and per % 2 == 0
    assert per * (grid - 1) < n16 <= per * grid
    assert sc["held"] == min(per, P.AQ_HOLD)
    if n16 >= P.AQ_MIN_VECS * sms * bps:
        assert grid >= sms * bps - 1  # rounding per up to even may leave one block out


def test_absmax_schedule_at_the_probes():
    """On an H100 at two blocks an SM: k3's 65,536 vectors in 128 blocks of
    512, all held; k4's 251,904 in 264 of 956, all held; K5's 720p geometry
    in 264 of 28,050, 7,168 held and 20,882 read again."""
    got = {c: P.absmax_schedule(ABSMAX_SIZES[c], 132, 2) for c in ("k3", "k4", "k5_geometry")}
    assert [(g["grid"], g["per"], g["held"]) for g in got.values()] == [
        (128, 512, 512), (264, 956, 956), (264, 28050, 7168)]
    assert P.AQ_SMEM == 114688 and 2 * (P.AQ_SMEM + 1024 + 56 + 64) <= 233472


# (vectors, sms, blocks an SM): one vector; k3 (all held); a re-read part
# in four blocks, the last ending on an odd vector; one block re-reading
ABSMAX_WALKS = {"one": (1, 132, 2), "k3": (65536, 132, 2), "odd_reread": (70001, 2, 2),
                "one_block": (20000, 1, 1)}


@pytest.mark.parametrize("case", list(ABSMAX_WALKS))
def test_absmax_walk_reads_each_vector_once(case):
    n16, sms, bps = ABSMAX_WALKS[case]
    sc = P.absmax_schedule(8 * n16, sms, bps)
    blocks = P.absmax_walk(8 * n16, sc["grid"], sc["per"])
    assert len(blocks) == sc["grid"]
    seen = []
    for b, blk in enumerate(blocks):
        v0, end = blk["slice"]
        assert v0 == b * sc["per"] and end == min(v0 + sc["per"], n16) and end > v0
        held = [v for first, count in blk["held"] for v in range(first, first + count)]
        assert held == list(range(v0, v0 + min(end - v0, P.AQ_HOLD)))
        assert len(blk["held"]) <= 7 and all(c <= P.AQ_CHUNK for _, c in blk["held"])
        assert sorted(blk["pass1"]) == list(range(v0 + len(held), end))
        # pass two: the same iterations of AQ_STEP, last first, each as in pass one
        r0 = v0 + len(held)
        iters = {}
        for v in blk["pass1"]:
            iters.setdefault((v - r0) // P.AQ_STEP, []).append(v)
        assert list(iters) == sorted(iters)
        assert blk["pass2"] == [v for i in sorted(iters, reverse=True) for v in iters[i]]
        seen += held + blk["pass1"]
    assert sorted(seen) == list(range(n16)) and len(seen) == n16


def _emulate_k9(x, grid, per):
    """absmax_quantize_kernel's arithmetic over ``absmax_walk``: each block's
    max over the bit patterns of |x| (bf16 with the sign bit cleared), one
    partial a block, the fold, s = max(max, 1e-6) / 127 in float32, q =
    clip(rint(x / s)) with IEEE float32 division."""
    bits = x.view(torch.int16).numpy().view(np.uint16).reshape(-1, 8) & 0x7FFF
    parts = []
    for blk in P.absmax_walk(x.numel(), grid, per):
        vecs = [v for first, count in blk["held"] for v in range(first, first + count)]
        vecs += blk["pass1"]
        m = int(bits[vecs].max())
        parts.append(np.array([m << 16], np.uint32).view(np.float32)[0])
    s = np.float32(max(np.float32(max(parts)), np.float32(1e-6))) / np.float32(127)
    xf = x.float().numpy().reshape(-1)
    q = np.clip(np.rint(xf / s), -127, 127).astype(np.int8)
    return torch.from_numpy(q.reshape(x.shape)), torch.tensor([s], dtype=torch.float32)


def _absmax_inputs(kind, n, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "normal":
        return torch.randn(n, generator=gen).to(torch.bfloat16)
    if kind == "ties":  # s = 1 from the max 127: every x / s an integer or a tie
        x = (torch.randint(-253, 254, (n,), generator=gen) / 2.0).to(torch.bfloat16)
        x[0] = 127.0
        return x
    if kind == "zeros":
        return torch.zeros(n, dtype=torch.bfloat16)
    if kind == "negative_max_last":
        x = torch.randn(n, generator=gen).to(torch.bfloat16)
        x[-1] = -9.5
        return x
    # subnormal bf16 values beside normal ones, and negative zeros
    x = (torch.randn(n, generator=gen) * 1e-39).to(torch.bfloat16)
    x[::3] = -0.0
    x[1::7] = torch.randn(len(x[1::7]), generator=gen).to(torch.bfloat16) * 1e-3
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "negative_max_last", "subnormal"])
@pytest.mark.parametrize("n16,sms,bps", [(1, 132, 2), (70001, 2, 2), (3001, 7, 2)])
def test_absmax_emulated_kernel_is_the_plain_version(n16, sms, bps, kind):
    x = _absmax_inputs(kind, 8 * n16, n16 + sms)
    sc = P.absmax_schedule(x.numel(), sms, bps)
    q, s = _emulate_k9(x, sc["grid"], sc["per"])
    q_ref, s_ref = P.absmax_quantize_plain(x)
    assert torch.equal(s, s_ref) and torch.equal(q, q_ref)


# ---- the wrappers -------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card route on CPU tensors with 132 SMs and two K9
    blocks an SM, recording what they hand the C entries instead of calling
    them."""
    calls = []
    monkeypatch.setattr(P, "on_cpu", lambda x: False)
    monkeypatch.setattr(P, "sm_count", lambda dev: 132)
    monkeypatch.setattr(P, "_absmax_blocks_per_sm", lambda index: 2)
    monkeypatch.setattr(P, "_call",
                        lambda name, entry, dev, *args: calls.append((name, entry, args)))
    return calls


@pytest.mark.parametrize("scaled", [False, True])
def test_matmul_int8_hands_its_sizes_to_the_kernel(fake_card, scaled):
    a, b = torch.zeros((48, 96), dtype=I8), torch.zeros((96, 72), dtype=I8)
    scale = torch.ones(1) if scaled else None
    out = P.matmul(a, b, scale)
    ((name, entry, args),) = fake_card
    assert name == "matmul_int8" and entry == "pnp_matmul"
    assert args[0] == 2 and args[1] is a and args[2] is b and args[3] is scale
    assert args[4] is out and out.dtype == (torch.float32 if scaled else torch.int32)
    assert args[5:] == (48, 72, 96)


@pytest.mark.parametrize("case", ["k3", "k4", "odd", "eight"])
def test_absmax_quantize_hands_its_schedule_to_the_kernel(fake_card, case):
    n = ABSMAX_SIZES[case]
    x = torch.zeros(n, dtype=torch.bfloat16)
    q, s = P.absmax_quantize(x)
    ((name, entry, args),) = fake_card
    sc = P.absmax_schedule(n, 132, 2)
    assert name == "absmax_quantize" and entry == "pnp_absmax_quantize"
    gx, gn, parts, gq, gs, grid, per = args
    assert gx is x and gn == n and gq is q and gs is s and (grid, per) == (sc["grid"], sc["per"])
    assert parts.shape == (grid,) and parts.dtype == torch.float32
    assert q.shape == x.shape and q.dtype == I8 and s.shape == (1,) and s.dtype == torch.float32


def test_wrappers_refuse_what_the_kernels_cannot_take(fake_card):
    """int8: k % 32, m % 16, n % 8, mixed types, a scale of two values or
    of another type, a scale with bf16; K9: a count that is no multiple of
    8, float32, a strided view."""
    z = torch.zeros
    with pytest.raises(ValueError, match="matmul"):
        P.matmul(z((16, 48), dtype=I8), z((48, 16), dtype=I8))
    with pytest.raises(ValueError, match="matmul"):
        P.matmul(z((24, 32), dtype=I8), z((32, 16), dtype=I8))
    with pytest.raises(ValueError, match="matmul"):
        P.matmul(z((16, 32), dtype=I8), z((32, 12), dtype=I8))
    with pytest.raises(TypeError, match="matmul"):
        P.matmul(z((16, 32), dtype=I8), z((32, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="matmul"):
        P.matmul(z((16, 32), dtype=I8), z((32, 16), dtype=I8), torch.ones(2))
    with pytest.raises(TypeError, match="matmul"):
        P.matmul(z((16, 32), dtype=I8), z((32, 16), dtype=I8), torch.ones(1, dtype=torch.float64))
    with pytest.raises(ValueError, match="matmul"):
        P.matmul(z((16, 32), dtype=torch.bfloat16), z((32, 16), dtype=torch.bfloat16),
                 torch.ones(1))
    with pytest.raises(ValueError, match="absmax_quantize"):
        P.absmax_quantize(z(12, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="absmax_quantize"):
        P.absmax_quantize(z(16))
    with pytest.raises(ValueError, match="contiguous"):
        P.absmax_quantize(z((16, 16), dtype=torch.bfloat16).t())
    assert fake_card == []


# ---- the plain versions against JAX -----------------------------------------------------


@pytest.mark.parametrize("mkn", [(48, 96, 72), (16, 288, 8)])
def test_plain_versions_match_jax_k2_k3_at_ragged_shapes(monkeypatch, mkn):
    """tools/torch_int8_probe.py's k2 and k3 stages on the CPU (K8 int8's
    and K9's plain versions) against the JAX kernels of tools/int8_probe.py
    (interpret mode) on the same numpy inputs, bitwise, at shapes no 64 x 64
    tile or 128-byte chunk divides."""
    import importlib
    from pathlib import Path

    from jax.experimental.pallas import tpu as pltpu

    tools = str(Path(__file__).resolve().parents[1] / "tools")
    monkeypatch.setenv("PNP_COMPILE_CACHE", "0")  # a JAX probe's import turns one on
    monkeypatch.syspath_prepend(tools)
    jax_probe = importlib.import_module("int8_probe")
    port_probe = importlib.import_module("torch_int8_probe")
    m, k, n = mkn
    shapes = dict(M=m, K=k, N=n, BH=6, BW=20, C2=32, ROWS=4, COLS=18)
    outs = {}

    def record(name, fn):
        t, out = fn()
        outs[name] = out
        return t, out

    for key, v in shapes.items():
        monkeypatch.setattr(jax_probe, key, v)
    monkeypatch.setattr(jax_probe, "stage", record)
    monkeypatch.setattr(jax_probe, "timeit", lambda f, *a, n=100: (1.0, f(*a)))
    with pltpu.force_tpu_interpret_mode():
        jax_probe.main()
    port = port_probe.main(["--device", "cpu", "--mkn", str(m), str(k), str(n), "--band", "6",
                            "20", "32", "--out", "4", "18", "--n", "1"])
    for name in ("int8 matmul", "quantize-in-kernel + int8 matmul"):
        got, want = port[name]["out"].numpy(), np.asarray(outs[name])
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


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
@pytest.mark.parametrize("form", ["int32", "scaled"])
@pytest.mark.parametrize("case", list(MATMUL8_SHAPES))
def test_matmul_int8_kernel_wg(cuda, case, form):
    m, k, n = MATMUL8_SHAPES[case]
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=I8).to(cuda)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=I8).to(cuda)
    scale = torch.tensor([0.0123], device=cuda) if form == "scaled" else None
    got = _one_launch("matmul_int8", lambda: P.matmul(a, b, scale))
    want = P.matmul_plain(a, b, scale)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "negative_max_last", "subnormal"])
@pytest.mark.parametrize("case", list(ABSMAX_SIZES))
def test_absmax_quantize_kernel_one_launch(cuda, case, kind):
    x = _absmax_inputs(kind, ABSMAX_SIZES[case], 7).to(cuda)
    q, s = _one_launch("absmax_quantize", lambda: P.absmax_quantize(x))
    q_ref, s_ref = P.absmax_quantize_plain(x)
    assert torch.equal(s, s_ref) and torch.equal(q, q_ref)


@pytest.mark.cuda
def test_absmax_quantize_replays_in_a_cuda_graph(cuda):
    """The cooperative launch captured three times in one CUDA graph (as
    chip_smoke.py's device timing captures it), replayed: each q and s
    bitwise."""
    xs = [_absmax_inputs("normal", ABSMAX_SIZES["k4"], i).to(cuda) for i in range(3)]
    P.absmax_quantize(xs[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [P.absmax_quantize(x) for x in xs]
    graph.replay()
    torch.cuda.synchronize()
    for x, (q, s) in zip(xs, outs):
        q_ref, s_ref = P.absmax_quantize_plain(x)
        assert torch.equal(s, s_ref) and torch.equal(q, q_ref)
