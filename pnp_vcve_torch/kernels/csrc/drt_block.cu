// K3: one fused DRT block (channel_first, one_layer, with_se):
//   h   = relu(g[b] * (conv3x3(x; W2[b]) + b2[b]) + sum_r (x * par_r) @ PK_r)
//   out = x + conv3x3(h; W1) + b1
// with h zero outside the image (conv1's zero padding) and x * par_r
// rounded to the feature type. Out of place: the caller ping-pongs buffers
// because neighbouring tiles read x's halo.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: _drt_block_pf
// (:305, body _kernel_body :187). As there, h never leaves the chip in the
// one-launch form: stage 1 computes it on the output tile plus a 1-pixel
// halo into shared memory (the TPU kernel's VMEM `hmid`), held in the
// feature type as the TPU kernel holds it, and stage 2 convolves it with W1.
//
// K3s is the same kernel with the keyframe-carry select of the sweep folded
// into its epilogue (SELECT = true): it also writes
//   new_last_key = is_key[b] ? out : last_key
// from the stored (rounded) out pair. It replaces the TPU kernel
// drt_stack.py: _kernel_select (:278, launched at :351), the last block of a
// step on the 'pf' serving path, and runs at 64 channels only.
//
// Bound (c = 64, 720p): 158.5 GFLOP a frame, over 989 TFLOP/s of bf16
// tensor cores 0.160 ms, in 3xTF32 (three TF32 products over 495 TFLOP/s)
// 0.961 ms; its bytes 0.072 (bf16) / 0.144 ms (float32). The weights, read
// again by every tile from L2, and the halo that stage 1 computes twice are
// what a tile costs beyond that.
//
// Two designs, picked by the width (launch_drt_block; drt_stack.py says the
// same for the wrapper's weight layout):
//
// c = 64, every model path's width: drt_block_wg, wgmma on both stages.
//   - Tile: the output tile is 14 x 30 pixels (420 rows), stage 1's region
//     16 x 32 (512 rows, 1.22x the outputs; the mma.sync tile's 10 x 18
//     region padded to 192 rows was 1.5x), the staged x tile 18 x 34.
//     Stage 2's 420 rows run as 7 M-tiles of 64 (448 rows): 4 in warpgroup
//     0, 3 in warpgroup 1.
//   - Warps (wg_conv.cuh's roles, weight ring and A fragments, shared with
//     K2 and K4): two consumer warpgroups and one producer warpgroup, 384
//     threads, one block an SM. setmaxnreg gives the consumers 232
//     registers (128 float32 sums, two fragment buffers) and the producer
//     40. Persistent: grid = min(tiles, SMs), and block k walks tiles k,
//     k + grid, ... in (sample, tile row, tile column) order.
//   - Stage 1: warpgroup i owns region rows [256 i, 256 i + 256): four
//     m64n64 tiles. A (the x rows) comes from registers: ldmatrix at each
//     lane's pixel, a tap an address offset, the partition gate and the
//     3xTF32 split applied in registers as in tc_conv.cuh (gate_frag,
//     split_tf32). B (the weights) comes from the ring through
//     descriptors. bf16: m64n64k16, one product a k-step; float32: three
//     m64n64k8 tf32 products (lo*hi, hi*lo, hi*hi), as mma.sync's 3xTF32,
//     with no per-step split sum (none was needed at 64 channels). Each
//     stage streams its k-steps as commit groups of 4 (bf16) or 2
//     (float32) M-tiles through two fragment buffers, waiting only for the
//     group two back. After the nine W2 taps the sums become
//     g * (sums + b2); the three gated partition taps add on; relu, zero
//     outside the image, rounded to T into the h region.
//   - Stage 2: the output rows read the h region at each tap's offset; the
//     epilogue adds b1 and x (read from global memory, one M-tile's loads
//     in flight at a time) and, K3s, the select.
//   - Weights: the wrapper packs every tap (float32: each 32-channel
//     k-block of it, head and tail) into the 64 x 128-byte K-major,
//     128-byte-swizzled image wgmma reads (drt_stack.wg_image); one
//     producer thread moves each with one cp.async.bulk onto an mbarrier
//     ring of 4 stages (bf16 8 KB a tap, float32 16 KB a k-block), which
//     each consumer warp releases once its wgmma have completed. 21 bf16 /
//     42 float32 stages a tile: 3.3x fewer weight bytes an output pixel than
//     the 8 x 16 tile (420 outputs a tile against 128).
//   - x and the gates: producer warps 1-3 stage each tile's x (cp.async,
//     zero-filled outside the image, each pixel's 16-byte chunks
//     XOR-swizzled by the pixel so ldmatrix is conflict-free) and its
//     partition gates (3 x 512 float32), completing on the x barrier
//     (cp.async.mbarrier.arrive), as soon as the consumers release the
//     last tile's. bf16 keeps x and h apart: x for tile i + 1 lands while
//     stage 2 of tile i runs. Float32 puts h over x (157 + 131 KB do not
//     fit beside a ring), so x for tile i + 1 waits for stage 2 of tile i.
//   - Shared memory: bf16 183,888 bytes, float32 229,456 (wg_smem); no
//     spills (chip_smoke.py's build phase fails on any).
//
// Other widths (8, 24, the 128 of phase 5, the two-launch 216 and 392):
// drt_block_tc, an implicit GEMM on mma.sync (tc_conv.cuh; bf16, or
// 3xTF32 for float32 features). Stage 1's rows are the 180 pixels of the
// 8 x 16 output tile's 10 x 18 halo region (12 row tiles of 16, 3 a warp),
// its depth the nine taps of W2 over each input chunk, then three more
// "taps" at the centre pixel whose A fragments are scaled by the partition
// gate par_r in registers. The gain g applies between the two: after the
// last W2 step the sums become g * (sums + b2) in float32, as the TPU kernel
// applies it after its conv (drt_stack.py:226), and the gated steps add on.
// Stage 2's rows are the 128 output pixels (2 row tiles a warp) reading the
// h region directly. Each output group of 64 channels runs stage 1 over
// every input chunk (x chunks through a two-buffer ring, weights through a
// two-stage ring); the h region holds all c channels, as stage 2 of every
// group reads all of them. At c <= 64 (NARROW) there is one group and h
// overwrites the x chunk buffers once stage 1 is done. Float32 blocks above
// 64 channels sum each step apart (conv_step's SPLIT) on their long sums.
// It also runs at 64 channels through pnp_drt_block_mma_sync, the yardstick
// chip_smoke.py times the wgmma design against.
//
// Two-launch form. When the h region does not fit (c above the one-launch
// width: DB_ONE_LAUNCH_F32 / _BF16 below), the wrapper passes a scratch
// tensor for h: launch 1 (STAGE1) computes h on the output tile and writes
// it in the feature type, as the TPU kernel stores hmid; launch 2 (STAGE2)
// stages h's chunks back like x's and runs stage 2. Each block of either
// does one output group (grid z = samples x groups).
#include "tc_conv.cuh"
#include "wg_conv.cuh"


namespace pnp {
namespace tc {

enum Mode { FUSED = 0, STAGE1 = 1, STAGE2 = 2 };

template <int MODE>
struct DB {
  static constexpr int HALO = MODE == FUSED ? 1 : 0;             // stage-1 region's halo
  static constexpr int RH = TILE_H + 2 * HALO, RW = TILE_W + 2 * HALO, NR = RH * RW;
  static constexpr int XH = RH + 2, XW = RW + 2;                  // staged x tile (stage 1)
  static constexpr int HH = TILE_H + 2, HW = TILE_W + 2;          // h tile stage 2 reads
  // staged chunk tile: x for stage 1, h for STAGE2
  static constexpr int NA = MODE == STAGE2 ? HH * HW : XH * XW;
  static constexpr int MT1 = cdiv(NR, 16 * WM);                   // 3 (FUSED) or 2
};

// dynamic shared memory of one block: the chunk buffers (two when the width
// takes more than one chunk), the weight ring, the h region (FUSED; at
// c <= 64 it reuses the chunk buffers) and the stage-1 partition gates
template <int MODE>
__host__ __device__ constexpr size_t db_smem(int c, int elt) {
  const int kc = elt == 2 ? Operand<__nv_bfloat16>::KC : Operand<float>::KC;
  const int nw = elt == 2 ? Operand<__nv_bfloat16>::NW : Operand<float>::NW;
  const int nxb = cdiv(c, kc) > 1 ? 2 : 1;
  return (size_t)nxb * DB<MODE>::NA * PITCH + (size_t)2 * nw * WTILE +
         (MODE == FUSED && c > NB ? (size_t)DB<MODE>::NR * wide_pitch(c, elt) : 0) +
         (MODE == STAGE2 ? 0 : sizeof(float) * 3 * DB<MODE>::NR);
}
// NARROW (c <= 64, one output group): h overwrites the chunk buffers once
// stage 1 is done, which brings a float32 block to 106 KB, two an SM
static_assert(db_smem<FUSED>(NB, 4) <= SMEM_MAX / 2, "two narrow float32 blocks fit an SM");
static_assert(DB<FUSED>::NR * wide_pitch(NB, 4) <= 2 * DB<FUSED>::NA * PITCH &&
                  DB<FUSED>::NR * wide_pitch(Operand<float>::KC, 4) <= DB<FUSED>::NA * PITCH &&
                  DB<FUSED>::NR * wide_pitch(NB, 2) <= DB<FUSED>::NA * PITCH,
              "a narrow h region fits in the chunk buffers it overwrites");

// the widest one-launch block that fits, per feature type (launch.ONE_LAUNCH_WIDTH)
constexpr int DB_ONE_LAUNCH_F32 = 168;
constexpr int DB_ONE_LAUNCH_BF16 = 384;
static_assert(db_smem<FUSED>(DB_ONE_LAUNCH_F32, 4) <= SMEM_MAX &&
                  db_smem<FUSED>(DB_ONE_LAUNCH_F32 + PN, 4) > SMEM_MAX,
              "DB_ONE_LAUNCH_F32 is the widest one-launch block that fits");
static_assert(db_smem<FUSED>(DB_ONE_LAUNCH_BF16, 2) <= SMEM_MAX &&
                  db_smem<FUSED>(DB_ONE_LAUNCH_BF16 + PN, 2) > SMEM_MAX,
              "DB_ONE_LAUNCH_BF16 is the widest one-launch block that fits");

// Weights (the wrapper's layout): w2 (NW, b, 9, c, c), pk (NW, 3, c, c), w1
// (NW, 9, c, c), each tap transposed (out, in), NW = 2 for float32 (TF32
// head, tail); b2, g (b, c) and b1 (c,) float32. hbuf: STAGE1 writes h
// there, STAGE2 reads it.
template <typename T, int MODE, bool SELECT, bool NARROW>
__global__ void __launch_bounds__(NTHR, sizeof(T) == 2 || NARROW ? 2 : 1)
    drt_block_tc(const T* __restrict__ x, const T* __restrict__ par, const T* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ gain,
                 const T* __restrict__ pk, const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ last_key, const float* __restrict__ is_key, T* hbuf,
                 T* __restrict__ out, T* __restrict__ new_last_key, int bsz, int h, int w, int c) {
  using Op = Operand<T>;
  using G = DB<MODE>;
  constexpr int ELT = sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  const int nch = cdiv(c, Op::KC), ngr = cdiv(c, NB), nxb = nch > 1 ? 2 : 1;
  const int hp = wide_pitch(c, ELT);
  const int b = MODE == FUSED ? blockIdx.z : blockIdx.z / ngr;
  const int g_lo = MODE == FUSED ? 0 : blockIdx.z % ngr;
  const int g_hi = MODE == FUSED ? ngr : g_lo + 1;
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;

  uint8_t* xb = smem;                               // chunk buffers, NA rows each
  uint8_t* wb = xb + nxb * G::NA * PITCH;           // weight ring: 2 slots of NW tiles
  // FUSED: the h region, NR rows of hp bytes (NARROW: over the chunk buffers)
  uint8_t* hs = NARROW ? xb : wb + 2 * Op::NW * WTILE;
  float* gs = reinterpret_cast<float*>(wb + 2 * Op::NW * WTILE +
                                       (MODE == FUSED && !NARROW ? G::NR * hp : 0));  // 3 x NR

  const int S1g = MODE == STAGE2 ? 0 : 12 * nch;    // stage-1 steps a group
  const int S2g = MODE == STAGE1 ? 0 : 9 * nch;     // stage-2 steps a group
  const int S1 = (g_hi - g_lo) * S1g, S = S1 + (g_hi - g_lo) * S2g;
  const size_t w2_lo = (size_t)bsz * 9 * c * c, pk_lo = (size_t)3 * c * c,
               w1_lo = (size_t)9 * c * c;

  if (MODE != STAGE2) {
    for (int i = threadIdx.x; i < 3 * G::NR; i += NTHR) {
      const int r = i / G::NR, p = i % G::NR;
      const int y = y0 - G::HALO + p / G::RW, xx = x0 - G::HALO + p % G::RW;
      const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
      gs[i] = in ? to_f(par[(img + (size_t)y * w + xx) * 3 + r]) : 0.f;
    }
  }
  auto zero_h_pad = [&]() {  // h's channels past c up to whole k-steps are zeros
    const int pad0 = c * ELT, pad1 = hp - 16;
    for (int i = threadIdx.x; i < G::NR * (pad1 - pad0) / 16; i += NTHR) {
      const int p = i / ((pad1 - pad0) / 16), v = i % ((pad1 - pad0) / 16);
      *reinterpret_cast<uint4*>(hs + p * hp + pad0 + v * 16) = make_uint4(0, 0, 0, 0);
    }
  };
  if (MODE == FUSED && !NARROW) zero_h_pad();

  // step s: group gi, chunk ch, tap (0-8 conv taps; stage 1: 9-11 the
  // partition "taps" r = tap - 9)
  auto decode = [&](int s, int& gi, int& ch, int& tap) {
    if constexpr (MODE == STAGE2) {
      ch = tap = 0;
    } else if (s < S1) {
      gi = g_lo + s / S1g;
      const int r = s % S1g;
      if (r < 9 * nch) {
        ch = r / 9, tap = r % 9;
      } else {
        ch = (r - 9 * nch) / 3, tap = 9 + (r - 9 * nch) % 3;
      }
    }
    if constexpr (MODE != STAGE1) {
      if (s >= S1) {
        gi = g_lo + (s - S1) / S2g;
        const int r = (s - S1) % S2g;
        ch = r / 9, tap = r % 9;
      }
    }
  };
  ChunkRing ring;
  int xnext = 0;
  auto issue = [&](int s) {
    int gi, ch, tap;
    decode(s, gi, ch, tap);
    const int c0 = ch * Op::KC, kc = imin(Op::KC, c - c0), co0 = gi * NB;
    const int cw = imin(NB, c - co0);
    uint8_t* wd = wb + (s & 1) * Op::NW * WTILE;
    if (s < S1) {
      if (tap < 9)
        stage_w_step<T>(wd, w2 + ((size_t)b * 9 + tap) * c * c, w2_lo, c, c0, kc, co0, cw);
      else
        stage_w_step<T>(wd, pk + (size_t)(tap - 9) * c * c, pk_lo, c, c0, kc, co0, cw);
      xnext = ring.next(ch, [&](int o) {
        stage_chunk<T>(xb + o * G::NA * PITCH, x + img * c, c, c0, kc, h, w, y0 - G::HALO - 1,
                       x0 - G::HALO - 1, G::XH, G::XW);
      });
    } else {
      stage_w_step<T>(wd, w1 + (size_t)tap * c * c, w1_lo, c, c0, kc, co0, cw);
      if (MODE == STAGE2)
        xnext = ring.next(ch, [&](int o) {
          stage_chunk<T>(xb + o * G::NA * PITCH, hbuf + img * c, c, c0, kc, h, w, y0 - 1, x0 - 1,
                         G::HH, G::HW);
        });
    }
    cp_async_commit();
  };

  float gate[G::MT1][2] = {};
  float acc1[G::MT1][4][4];
  int arow1[G::MT1];
  const int lane = threadIdx.x % 32;
  issue(0);
  int s = 0;
  if constexpr (MODE != STAGE2) {
    // ---- stage 1: h on the region (FUSED: the tile and its halo)
    row_offsets<G::MT1>(arow1, G::NR, G::RW, G::XW, PITCH);
    zero_acc(acc1);
    for (; s < S1; ++s) {
      cp_async_wait_all();
      __syncthreads();  // step s's data is in; every warp is done with step s - 1
      ring.cur = xnext;
      if (s + 1 < S) issue(s + 1);
      int gi, ch, tap;
      decode(s, gi, ch, tap);
      const int kc = imin(Op::KC, c - ch * Op::KC), nks = cdiv(kc, Op::KSTEP_CH);
      const uint8_t* ab = xb + ring.cur * G::NA * PITCH;
      const uint8_t* wt = wb + (s & 1) * Op::NW * WTILE;
      if (tap < 9) {
        conv_step<T, G::MT1, false, !NARROW>(acc1, ab, arow1,
                                             ((tap / 3) * G::XW + tap % 3) * PITCH, wt, nks, gate);
      } else {
        const int wm = (threadIdx.x / 32) % WM;
#pragma unroll
        for (int m = 0; m < G::MT1; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = 16 * (G::MT1 * wm + m) + lane / 4 + 8 * hf;
            gate[m][hf] = p < G::NR ? gs[(tap - 9) * G::NR + p] : 0.f;
          }
        conv_step<T, G::MT1, true, !NARROW>(acc1, ab, arow1, (G::XW + 1) * PITCH, wt, nks, gate);
      }
      const int r = s % S1g, co0 = gi * NB;
      if (r == 9 * nch - 1) {  // the W2 taps are done: g * (sums + b2)
        for_each_pair<G::MT1>(acc1, [&](int, int col, float& v0, float& v1) {
          const int n = co0 + col;
          if (n >= c) return;
          v0 = (v0 + b2[(size_t)b * c + n]) * gain[(size_t)b * c + n];
          v1 = (v1 + b2[(size_t)b * c + n + 1]) * gain[(size_t)b * c + n + 1];
        });
      } else if (r == S1g - 1) {  // the group's h: relu, zero outside the image, as T
        if (NARROW) {  // every warp is done with the x tile h overwrites
          __syncthreads();
          zero_h_pad();
        }
        for_each_pair<G::MT1>(acc1, [&](int p, int col, float& v0, float& v1) {
          const int n = co0 + col;
          if (p >= G::NR || n >= c) return;
          const int y = y0 - G::HALO + p / G::RW, xx = x0 - G::HALO + p % G::RW;
          const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
          if (MODE == FUSED)
            store2(reinterpret_cast<T*>(hs + p * hp) + n, in ? fmaxf(v0, 0.f) : 0.f,
                   in ? fmaxf(v1, 0.f) : 0.f);
          else if (in)
            store2(hbuf + (img + (size_t)y * w + xx) * c + n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        });
        zero_acc(acc1);
      }
    }
  }
  if constexpr (MODE != STAGE1) {
    // ---- stage 2: conv1 over h, + b1 + x, on the output tile
    float acc2[MT_OUT][4][4];
    int arow2[MT_OUT];
    const int apitch = MODE == FUSED ? hp : PITCH;
    row_offsets<MT_OUT>(arow2, TILE_H * TILE_W, TILE_W, G::HW, apitch);
    zero_acc(acc2);
    const float nogate[MT_OUT][2] = {};
    const bool key = SELECT && is_key[b] > 0.5f;
    for (; s < S; ++s) {
      cp_async_wait_all();
      __syncthreads();  // step s's data (and, first, the whole h region) is in
      ring.cur = xnext;
      if (s + 1 < S) issue(s + 1);
      int gi, ch, tap;
      decode(s, gi, ch, tap);
      const int kc = imin(Op::KC, c - ch * Op::KC), nks = cdiv(kc, Op::KSTEP_CH);
      const uint8_t* ab = MODE == FUSED ? hs + ch * CHUNK_BYTES : xb + ring.cur * G::NA * PITCH;
      conv_step<T, MT_OUT, false, !NARROW>(acc2, ab, arow2,
                                           ((tap / 3) * G::HW + tap % 3) * apitch,
                                           wb + (s & 1) * Op::NW * WTILE, nks, nogate);
      if ((s - S1) % S2g != S2g - 1) continue;
      const int co0 = gi * NB;
      for_each_pair<MT_OUT>(acc2, [&](int p, int col, float& v0, float& v1) {
        const int n = co0 + col;
        const int y = y0 + p / TILE_W, xx = x0 + p % TILE_W;
        if (n >= c || y >= h || xx >= w) return;
        const size_t o = (img + (size_t)y * w + xx) * c + n;
        const float2 xv = load2(x + o);
        const float2 ov =
            rounded2(xv.x + (v0 + b1[n]), xv.y + (v1 + b1[n + 1]), T());
        store2(out + o, ov.x, ov.y);
        if (SELECT) {
          const float2 sv = key ? ov : load2(last_key + o);
          store2(new_last_key + o, sv.x, sv.y);
        }
      });
      zero_acc(acc2);
    }
  }
}

// ---- the wgmma design (c = 64) ----------------------------------------------------

// the tile; the block's roles (consumer and producer warpgroups, their
// registers) are wg_conv.cuh's
struct WGeo {
  static constexpr int C = wgc::C;                               // the one width it takes
  static constexpr int RH = 16, RW = wgc::RW, NR = RH * RW;      // stage-1 region: 512 rows
  static constexpr int TH = RH - 2, TW = RW - 2, NO = TH * TW;   // output tile: 420 rows
  static constexpr int XH = RH + 2, XW = wgc::XW, NX = XH * XW;  // staged x tile: 612 pixels
  static constexpr int MT = NR / 64 / wgc::NCW;                  // a warpgroup's M-tiles: 4
  static constexpr int MO = cdiv(NO, 64);                        // stage 2's M-tiles: 7
  static constexpr int KSTEPS = 128 / KSTEP_BYTES;               // wgmma k-steps a k-block: 4
};
static_assert(WGeo::NR == 64 * wgc::NCW * WGeo::MT, "stage 1's rows are whole M-tiles");
static_assert(WGeo::MO > WGeo::MT && WGeo::MO <= wgc::NCW * WGeo::MT,
              "stage 2's M-tiles: MT to warpgroup 0, the rest to warpgroup 1");

// per feature type: bytes of a pixel's 64 channels, 128-byte k-blocks a tap,
// weight terms (float32: the TF32 head and tail), ring stages, and whether h
// lies over the x tile
template <typename T> struct WGType;
template <> struct WGType<__nv_bfloat16> {
  static constexpr int PIXB = 128, KB = 1, NW = 1, NS = 4;
  static constexpr bool H_OVER_X = false;
};
template <> struct WGType<float> {
  static constexpr int PIXB = 256, KB = 2, NW = 2, NS = 4;
  static constexpr bool H_OVER_X = true;
};

// dynamic shared memory of a block: 1024 bytes to align the ring, the ring,
// the x tile, the h region (bf16), the gates and the barriers
template <typename T>
__host__ __device__ constexpr size_t wg_smem() {
  using P = WGType<T>;
  return 1024 + (size_t)P::NS * P::NW * wgc::BTILE + (size_t)WGeo::NX * P::PIXB +
         (P::H_OVER_X ? 0 : (size_t)WGeo::NR * P::PIXB) + sizeof(float) * 3 * WGeo::NR +
         sizeof(uint64_t) * (2 * P::NS + 2);
}
static_assert(wg_smem<float>() <= SMEM_MAX && wg_smem<__nv_bfloat16>() <= SMEM_MAX,
              "a wgmma block fits an SM's shared memory");
static_assert(WGeo::NR <= WGeo::NX, "h fits over the x tile");

// The pixel that A row-tile m of this lane reads at tap offset 0. Stage 1
// (OUT false): base is the lane's x-tile pixel in M-tile 0 (two region rows
// an M-tile). Stage 2 (OUT true): base is the lane's output row in M-tile 0,
// rows past NO read pixel 0 (computed and dropped), and row r reads h
// pixel (r / TW, r % TW).
template <bool OUT>
__device__ __forceinline__ int row_pixel(int base, int m) {
  if constexpr (!OUT) {
    return base + m * (64 / WGeo::RW) * WGeo::XW;
  } else {
    int r = base + 64 * m;
    r = r < WGeo::NO ? r : 0;
    return (r / WGeo::TW) * WGeo::RW + r % WGeo::TW;
  }
}

// One ring stage: one 128-byte k-block (kb) of one tap for a warpgroup's NM
// M-tiles, KSTEPS k-steps, A rows at pixels row_pixel(base, m) + off of buf
// (OUT: stage 2's rows, else stage 1's), B the stage's weight tiles (the
// TF32 tail BTILE after the head). GATED: each A fragment scaled by its
// rows' gates (the partition taps). The stage runs as a stream of commit
// groups, one a k-step and M-tile group (wgc::WGGroup), through two fragment
// buffers: each group loads its A while the one before multiplies and
// waits (wait<1>) only until the group two back, which read the buffer it
// overwrites, is done; the stage ends with every group complete, so its
// weights may be released.
template <typename T, int NM, bool GATED, bool OUT>
__device__ __forceinline__ void wg_stage(float (&acc)[WGeo::MT][32], const uint8_t* buf,
                                         int base, int off, int kb, const uint8_t* stage,
                                         const float (&gate)[WGeo::MT][2]) {
  using P = WGType<T>;
  constexpr int MG = wgc::WGGroup<T>::MG, NG = cdiv(NM, MG);
  const int half = (threadIdx.x % 32) / 16;
  int q[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) q[m] = row_pixel<OUT>(base, m) + off;
  const uint64_t dh = wg::desc_sw128(stage);
  wgc::AFrag<T, MG> f[2];
#pragma unroll
  for (int u = 0; u < WGeo::KSTEPS * NG; ++u) {
    const int ks = u / NG, m0 = (u % NG) * MG;
    wgc::AFrag<T, MG>& cur = f[u % 2];
    if (u >= 2) {  // the group two back has read this buffer
      wg::wait<1>();
      cur.hold();
    }
    const int ch = kb * 8 + 2 * ks + half;
    const uint64_t d0 = wg::desc_add(dh, ks * KSTEP_BYTES);
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      const int m = m0 + k;
      if (m >= NM) break;
      uint32_t af[4];
      ldmatrix_x4(af, wgc::xpiece<P::PIXB>(buf, q[m], ch));
      if constexpr (GATED) gate_frag(af, gate[m], T());
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cur.a[k][r] = af[r];
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(af[r], cur.hi[k][r], cur.lo[k][r]);
      }
    }
    cur.hold();
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
    wg::fence();
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      const int m = m0 + k;
      if (m >= NM) break;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        wg::mma_bf16(acc[m], cur.a[k], d0);
      } else {
        const uint64_t d1 = wg::desc_add(d0, wgc::BTILE);  // the weights' TF32 tail
        wg::mma_tf32(acc[m], cur.lo[k], d0);  // the small terms first, as mma.sync's kstep
        wg::mma_tf32(acc[m], cur.hi[k], d1);
        wg::mma_tf32(acc[m], cur.hi[k], d0);
      }
    }
    wg::commit();
  }
  wg::wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
  f[0].hold();
  f[1].hold();
}

// Weights (the wrapper's images, drt_stack.wg_image): w2 (b, 9, KB, NW, 64,
// 128 bytes), pk (3, KB, NW, 64, 128 bytes), w1 (9, KB, NW, 64, 128 bytes),
// each (KB, NW) group one ring stage; b2, g (b, 64) and b1 (64,) float32.
template <typename T, bool SELECT>
__global__ void __launch_bounds__(wgc::NTHR, 1)
    drt_block_wg(const T* __restrict__ x, const T* __restrict__ par, const T* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ gain,
                 const T* __restrict__ pk, const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ last_key, const float* __restrict__ is_key,
                 T* __restrict__ out, T* __restrict__ new_last_key, int bsz, int h, int w) {
  using G = WGeo;
  using P = WGType<T>;
  using wgc::NCONS;
  using wgc::NXLOAD;
  constexpr int ELT = sizeof(T), STAGE = P::NW * wgc::BTILE;
  constexpr int NST = 21 * P::KB;    // ring stages a tile: W2 9, PK 3, W1 9 taps
  constexpr int NCH = P::PIXB / 16;  // 16-byte chunks of a pixel
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = wgc::align1024(smem_raw);
  uint8_t* xs = ringb + P::NS * STAGE;
  uint8_t* hs = P::H_OVER_X ? xs : xs + G::NX * P::PIXB;
  float* gs = reinterpret_cast<float*>(P::H_OVER_X ? xs + G::NX * P::PIXB : hs + G::NR * P::PIXB);
  uint64_t* full = reinterpret_cast<uint64_t*>(gs + 3 * G::NR);
  uint64_t* empty = full + P::NS;
  uint64_t* xfull = empty + P::NS;
  uint64_t* xempty = xfull + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::NS; ++s) {
      wg::mbar_init(&full[s], 1);                // the producer's arrive with its bytes
      wg::mbar_init(&empty[s], NCONS / 32);   // each consumer warp
    }
    wg::mbar_init(xfull, 2 * NXLOAD);  // each x thread: its cp.async, then its gates
    wg::mbar_init(xempty, NCONS / 32);
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int ntx = cdiv(w, G::TW), nty = cdiv(h, G::TH), per = ntx * nty, ntiles = bsz * per;
  const int lane = threadIdx.x % 32;
  // the warpgroup, warp-uniform as the compiler sees it (wgmma must not sit
  // in a path it takes as divergent)
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  wgc::WRing<P::NS, STAGE> ring{ringb, full, empty};

  if (wgi == wgc::NCW) {
    // ---- the producer warpgroup: warp 0 the weight ring (one thread),
    // warps 1-3 the x tiles and the gates
    wg::setmaxnreg_dec<wgc::REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid < 32) {
      if (ptid == 0) {
        const size_t selems = STAGE / ELT;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          const int b = t / per;
          for (int s = 0; s < NST; ++s)
            ring.put(s < 9 * P::KB    ? w2 + ((size_t)b * 9 * P::KB + s) * selems
                     : s < 12 * P::KB ? pk + (size_t)(s - 9 * P::KB) * selems
                                      : w1 + (size_t)(s - 12 * P::KB) * selems,
                     STAGE);
        }
        ring.drain();
      }
      return;
    }
    // tile i's x and gates once the consumers are done with tile i - 1's
    // (bf16: its stage 1; float32, h over x: its stage 2)
    int i = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      if (i > 0) wg::mbar_wait(xempty, (i - 1) & 1);
      // recomputed each tile: nothing per thread is kept across the tile loop
      const int xt = wg::opaque(ptid - 32);
      const int b = t / per, y0 = (t % per) / ntx * G::TH, x0 = t % ntx * G::TW;
      const T* xb = x + (size_t)b * h * w * G::C;
      for (int k = xt; k < G::NX * NCH; k += NXLOAD) {
        const int q = k / NCH, ch = k % NCH, qy = q / G::XW;
        const int y = y0 - 2 + qy, xx = x0 - 2 + (q - qy * G::XW);
        const bool ok = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
        cp_async16(wgc::xpiece<P::PIXB>(xs, q, ch),
                   xb + (ok ? (y * w + xx) * G::C + ch * (16 / ELT) : 0), ok);
      }
      wg::cp_async_mbar_arrive(xfull);
      const T* pb = par + (size_t)b * h * w * 3;
      for (int p = xt; p < G::NR; p += NXLOAD) {
        const int y = y0 - 1 + p / G::RW, xx = x0 - 1 + p % G::RW;
        const bool in = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
        const T* pp = pb + (in ? y * w + xx : 0) * 3;
#pragma unroll
        for (int r = 0; r < 3; ++r) gs[r * G::NR + p] = in ? to_f(pp[r]) : 0.f;
      }
      wg::mbar_arrive(xfull);
    }
    cp_async_wait_all();  // the last tile's copies have landed
    return;
  }

  // ---- the consumer warpgroups. Tile coordinates and lane-derived indices
  // are recomputed where needed from opaque copies (wg::opaque), so the
  // compiler keeps no per-tile constants live across the k-loops, whose
  // sums and A fragments take most of the registers.
  wg::setmaxnreg_inc<wgc::REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  float acc[G::MT][32];
  int i = 0;
  const float nogate[G::MT][2] = {};
  int t_cur = blockIdx.x;  // the tile
  // stage 2 and its epilogue for this warpgroup's NM M-tiles from mt2
  auto stage2 = [&](auto nm_c, int mt2) {
    constexpr int NM = decltype(nm_c)::value;
    wgc::zero(acc);
    const int base = 64 * mt2 + 16 * warp + lane % 16;  // row_pixel<true>'s
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll 1
      for (int kb = 0; kb < P::KB; ++kb)
        ring.take([&](const uint8_t* st) {
          wg_stage<T, NM, false, true>(acc, hs, base, (tap / 3) * G::RW + tap % 3, kb, st,
                                       nogate);
        });
    if (P::H_OVER_X) {  // h (over x) and the gates may take the next tile's
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(xempty);
    }
    // out = x + (sums + b1); K3s: new_last_key = is_key ? out : last_key
    const int tt = wg::opaque(t_cur), ln = wg::opaque(lane);
    const int b = tt / per, y0 = (tt % per) / ntx * G::TH, x0 = tt % ntx * G::TW;
    const size_t img = (size_t)b * h * w;
    const int g = ln / 4, t4 = ln % 4;
    const bool key = SELECT && is_key[b] > 0.5f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      // one M-tile's loads in flight at a time: the sums hold the registers
      asm volatile("" ::: "memory");
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * (mt2 + m) + 16 * warp + g + 8 * hf, n = 8 * j + 2 * t4;
          const int y = y0 + r / G::TW, xx = x0 + r % G::TW;
          if (r >= G::NO || y >= h || xx >= w) continue;
          const size_t o = (img + (size_t)y * w + xx) * G::C + n;
          const float2 xv = load2(x + o);
          const float2 ov = rounded2(xv.x + (acc[m][4 * j + 2 * hf] + b1[n]),
                                     xv.y + (acc[m][4 * j + 2 * hf + 1] + b1[n + 1]), T());
          store2(out + o, ov.x, ov.y);
          if (SELECT) {
            const float2 sv = key ? ov : load2(last_key + o);
            store2(new_last_key + o, sv.x, sv.y);
          }
        }
    }
  };
  for (; t_cur < ntiles; t_cur += gridDim.x, ++i) {
    const int mt1 = G::MT * wgi;  // this warpgroup's first M-tile
    // ---- stage 1: region row p = 64 (mt1 + m) + 16 warp + lane % 16 reads
    // x-tile pixel (p / RW + dy, p % RW + dx) at tap (dy, dx)
    {
      const int p0 = 64 * mt1 + 16 * warp + lane % 16;
      const int base = (p0 / G::RW) * G::XW + p0 % G::RW;  // row_pixel<false>'s
      wgc::zero(acc);
      wg::mbar_wait(xfull, i & 1);
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll 1
        for (int kb = 0; kb < P::KB; ++kb)
          ring.take([&](const uint8_t* st) {
            wg_stage<T, G::MT, false, false>(acc, xs, base, (tap / 3) * G::XW + tap % 3, kb, st,
                                             nogate);
          });
      // the W2 taps are done: g * (sums + b2)
      const int b = wg::opaque(t_cur) / per, t4 = wg::opaque(lane) % 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float c0 = b2[b * G::C + n], c1 = b2[b * G::C + n + 1];
        const float g0 = gain[b * G::C + n], g1 = gain[b * G::C + n + 1];
#pragma unroll
        for (int m = 0; m < G::MT; ++m) {
          acc[m][4 * j] = (acc[m][4 * j] + c0) * g0;
          acc[m][4 * j + 1] = (acc[m][4 * j + 1] + c1) * g1;
          acc[m][4 * j + 2] = (acc[m][4 * j + 2] + c0) * g0;
          acc[m][4 * j + 3] = (acc[m][4 * j + 3] + c1) * g1;
        }
      }
      // the partition taps at the centre pixel, A gated by par_r of its rows
      for (int r = 0; r < 3; ++r) {
        float gate[G::MT][2];
        const int gr = 64 * mt1 + 16 * warp + wg::opaque(lane) / 4;
#pragma unroll
        for (int m = 0; m < G::MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) gate[m][hf] = gs[r * G::NR + gr + 64 * m + 8 * hf];
#pragma unroll 1
        for (int kb = 0; kb < P::KB; ++kb)
          ring.take([&](const uint8_t* st) {
            wg_stage<T, G::MT, true, false>(acc, xs, wg::opaque(base), G::XW + 1, kb, st, gate);
          });
      }
    }
    if (!P::H_OVER_X) {  // x (and the gates) may take the next tile's
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(xempty);
    }
    // every consumer is done with x and (bf16) with the last tile's h
    wg::named_sync(1, NCONS);
    // h: relu, zero outside the image, as T
    {
      const int tt = wg::opaque(t_cur), ln = wg::opaque(lane);
      const int y0 = (tt % per) / ntx * G::TH, x0 = tt % ntx * G::TW;
      const int g = ln / 4, t4 = ln % 4;
#pragma unroll
      for (int m = 0; m < G::MT; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = 64 * (mt1 + m) + 16 * warp + g + 8 * hf, n = 8 * j + 2 * t4;
            const int y = y0 - 1 + p / G::RW, xx = x0 - 1 + p % G::RW;
            const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
            T* dst = reinterpret_cast<T*>(hs + p * P::PIXB +
                                          ((((n * ELT) >> 4) ^ (p & 7)) << 4) + ((n * ELT) & 15));
            store2(dst, in ? fmaxf(acc[m][4 * j + 2 * hf], 0.f) : 0.f,
                   in ? fmaxf(acc[m][4 * j + 2 * hf + 1], 0.f) : 0.f);
          }
    }
    wg::named_sync(1, NCONS);  // h is whole
    // ---- stage 2: M-tiles [0, MT) in warpgroup 0, [MT, MO) in warpgroup 1
    if (wgi == 0)
      stage2(std::integral_constant<int, G::MT>(), 0);
    else
      stage2(std::integral_constant<int, G::MO - G::MT>(), G::MT);
  }
}

// The tile walk of drt_block_wg (drt_stack.wg_tile_walk mirrors it): tiles
// of the batch and the persistent grid that walks them.
__host__ __device__ constexpr int wg_tiles(int b, int h, int w) {
  return b * cdiv(h, WGeo::TH) * cdiv(w, WGeo::TW);
}

template <typename T, bool SELECT>
cudaError_t launch_drt_block_wg(const T* x, const T* par, const T* w2, const float* b2,
                                const float* g, const T* pk, const T* w1, const float* b1,
                                const T* last_key, const float* is_key, T* out, T* new_last_key,
                                int b, int h, int w, int c, cudaStream_t stream) {
  // the producer addresses a sample's pixels with 32-bit offsets
  if (c != WGeo::C || (long long)h * w * WGeo::C >= (1LL << 31)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = drt_block_wg<T, SELECT>;
  const size_t smem = wg_smem<T>();
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = wgc::sm_count(sms)) != cudaSuccess) return e;
  const int grid = imin(wg_tiles(b, h, w), sms);
  k<<<grid, wgc::NTHR, smem, stream>>>(x, par, w2, b2, g, pk, w1, b1, last_key, is_key, out,
                                        new_last_key, b, h, w);
  return cudaGetLastError();
}

// the mma.sync design at any width c % 8 == 0 (one launch up to the widest
// block that fits, else two through hbuf); K3s at 64 channels only
template <typename T, bool SELECT>
cudaError_t launch_drt_block_mma(const T* xt, const T* pt, const T* w2t, const float* b2f,
                                 const float* gf, const T* pkt, const T* w1t, const float* b1f,
                                 const T* lk, const float* kf, T* hb, T* o, T* nlk, int b, int h,
                                 int w, int c, cudaStream_t stream) {
  constexpr int ELT = sizeof(T);
  const int one = ELT == 2 ? DB_ONE_LAUNCH_BF16 : DB_ONE_LAUNCH_F32;
  if (c < PN || c % PN || (SELECT && c != NB) || (c > one) != (hb != nullptr))
    return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const dim3 tiles((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, 1);
  if (c <= one) {
    auto k = drt_block_tc<T, FUSED, SELECT, true>;  // K3s: 64 channels, narrow
    if constexpr (!SELECT) {
      if (c > NB) k = drt_block_tc<T, FUSED, false, false>;
    }
    const size_t smem = db_smem<FUSED>(c, ELT);
    cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return e;
    k<<<dim3(tiles.x, tiles.y, b), NTHR, smem, stream>>>(xt, pt, w2t, b2f, gf, pkt, w1t, b1f, lk,
                                                          kf, nullptr, o, nlk, b, h, w, c);
    return cudaGetLastError();
  }
  const dim3 grid(tiles.x, tiles.y, b * cdiv(c, NB));
  auto k1 = drt_block_tc<T, STAGE1, false, false>;
  size_t smem = db_smem<STAGE1>(c, ELT);
  cudaError_t e = allow_smem(k1, smem);
  if (e != cudaSuccess) return e;
  k1<<<grid, NTHR, smem, stream>>>(xt, pt, w2t, b2f, gf, pkt, w1t, b1f, nullptr, nullptr, hb,
                                   nullptr, nullptr, b, h, w, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto k2 = drt_block_tc<T, STAGE2, false, false>;
  smem = db_smem<STAGE2>(c, ELT);
  if ((e = allow_smem(k2, smem)) != cudaSuccess) return e;
  k2<<<grid, NTHR, smem, stream>>>(xt, pt, w2t, b2f, gf, pkt, w1t, b1f, nullptr, nullptr, hb, o,
                                   nullptr, b, h, w, c);
  return cudaGetLastError();
}

// design: 0 by the width (the wgmma design at 64 channels, mma.sync at any
// other), 1 mma.sync at any width (the yardstick)
template <typename T, bool SELECT>
cudaError_t launch_drt_block(int design, const void* x, const void* par, const void* w2,
                             const void* b2, const void* g, const void* pk, const void* w1,
                             const void* b1, const void* last_key, const void* is_key, void* hbuf,
                             void* out, void* new_last_key, int b, int h, int w, int c,
                             cudaStream_t stream) {
  const auto* xt = static_cast<const T*>(x);
  const auto* pt = static_cast<const T*>(par);
  const auto* w2t = static_cast<const T*>(w2);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* gf = static_cast<const float*>(g);
  const auto* pkt = static_cast<const T*>(pk);
  const auto* w1t = static_cast<const T*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* lk = static_cast<const T*>(last_key);
  const auto* kf = static_cast<const float*>(is_key);
  auto* o = static_cast<T*>(out);
  auto* nlk = static_cast<T*>(new_last_key);
  if (design == 0 && c == WGeo::C)
    return hbuf != nullptr ? cudaErrorInvalidValue
                           : launch_drt_block_wg<T, SELECT>(xt, pt, w2t, b2f, gf, pkt, w1t, b1f,
                                                            lk, kf, o, nlk, b, h, w, c, stream);
  if (design != 0 && design != 1) return cudaErrorInvalidValue;
  return launch_drt_block_mma<T, SELECT>(xt, pt, w2t, b2f, gf, pkt, w1t, b1f, lk, kf,
                                         static_cast<T*>(hbuf), o, nlk, b, h, w, c, stream);
}

template <bool SELECT>
int drt_block_entry(int design, int dtype, const void* x, const void* par, const void* w2,
                    const void* b2, const void* g, const void* pk, const void* w1, const void* b1,
                    const void* last_key, const void* is_key, void* hbuf, void* out,
                    void* new_last_key, int b, int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_drt_block<float, SELECT>(design, x, par, w2, b2, g, pk, w1, b1, last_key,
                                                is_key, hbuf, out, new_last_key, b, h, w, c, s);
  if (dtype == 1)
    return (int)launch_drt_block<__nv_bfloat16, SELECT>(design, x, par, w2, b2, g, pk, w1, b1,
                                                        last_key, is_key, hbuf, out,
                                                        new_last_key, b, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x, out: (b, h, w, c), c a multiple of 8;
// par: (b, h, w, 3); b2, g: (b, c) and b1: (c,) float32. The taps in x's
// type, NW = 2 for float32 (the TF32 head and tail of tf32_split), 1 for
// bfloat16: at c = 64 (the wgmma design) drt_stack.wg_image's shared-memory
// images w2 (b, 9, KB, NW, 64, 128 bytes), pk (3, ...), w1 (9, ...); at any
// other width w2: (NW, b, 9, c, c), pk: (NW, 3, c, c), w1: (NW, 9, c, c),
// each tap transposed (out, in). hbuf: null for the one-launch form; above
// the one-launch width a (b, h, w, c) scratch of x's type for h (two
// launches).
extern "C" int pnp_drt_block(int dtype, const void* x, const void* par, const void* w2,
                             const void* b2, const void* g, const void* pk, const void* w1,
                             const void* b1, void* hbuf, void* out, int b, int h, int w, int c,
                             void* stream) {
  return pnp::tc::drt_block_entry<false>(0, dtype, x, par, w2, b2, g, pk, w1, b1, nullptr,
                                         nullptr, hbuf, out, nullptr, b, h, w, c, stream);
}

// K3s: pnp_drt_block's arguments (one launch, no hbuf, c = 64) plus
// last_key (b, h, w, c) of x's type and is_key (b,) float32 0/1; writes out
// and new_last_key = where(is_key, out, last_key), neither aliasing an input.
extern "C" int pnp_drt_block_select(int dtype, const void* x, const void* par, const void* w2,
                                    const void* b2, const void* g, const void* pk,
                                    const void* w1, const void* b1, const void* last_key,
                                    const void* is_key, void* out, void* new_last_key, int b,
                                    int h, int w, int c, void* stream) {
  return pnp::tc::drt_block_entry<true>(0, dtype, x, par, w2, b2, g, pk, w1, b1, last_key,
                                        is_key, nullptr, out, new_last_key, b, h, w, c, stream);
}

// The mma.sync design at 64 channels too, in the (NW, ..., c, c) layout:
// pnp_drt_block_select's arguments and `select` (0: K3, last_key, is_key
// and new_last_key unused; 1: K3s). chip_smoke.py times it beside the
// wgmma design as the yardstick; no model path calls it.
extern "C" int pnp_drt_block_mma_sync(int select, int dtype, const void* x, const void* par,
                                      const void* w2, const void* b2, const void* g,
                                      const void* pk, const void* w1, const void* b1,
                                      const void* last_key, const void* is_key, void* out,
                                      void* new_last_key, int b, int h, int w, int c,
                                      void* stream) {
  if (select)
    return pnp::tc::drt_block_entry<true>(1, dtype, x, par, w2, b2, g, pk, w1, b1, last_key,
                                          is_key, nullptr, out, new_last_key, b, h, w, c, stream);
  return pnp::tc::drt_block_entry<false>(1, dtype, x, par, w2, b2, g, pk, w1, b1, nullptr,
                                         nullptr, nullptr, out, nullptr, b, h, w, c, stream);
}

// dynamic shared memory of a one-launch block at width c (dtype 0 float32,
// 1 bfloat16) in the design the width takes, for the build report and
// chip_smoke.py's check of launch.ONE_LAUNCH_WIDTH
extern "C" int pnp_drt_block_smem(int c, int dtype) {
  if (c == pnp::tc::WGeo::C)
    return (int)(dtype == 1 ? pnp::tc::wg_smem<__nv_bfloat16>() : pnp::tc::wg_smem<float>());
  return (int)pnp::tc::db_smem<pnp::tc::FUSED>(c, dtype == 1 ? 2 : 4);
}
