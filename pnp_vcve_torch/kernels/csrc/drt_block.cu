// K3: one fused DRT block (channel_first, one_layer, with_se):
//   h   = relu(g[b] * (conv3x3(x; W2[b]) + b2[b]) + sum_r (x * par_r) @ PK_r)
//   out = x + conv3x3(h; W1) + b1
// with h zero outside the image (conv1's zero padding) and x * par_r
// rounded to the feature type. Out of place: the caller ping-pongs buffers
// because neighbouring tiles read x's halo.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: _drt_block_pf
// (:305, body _kernel_body :187). As there, h never leaves the chip in the
// one-launch form: stage 1 computes it on the 8 x 16 output tile plus a
// 1-pixel halo (10 x 18) into shared memory (the TPU kernel's VMEM `hmid`),
// held in the feature type as the TPU kernel holds it, and stage 2
// convolves it with W1.
//
// K3s is the same kernel with the keyframe-carry select of the sweep folded
// into its epilogue (SELECT = true): it also writes
//   new_last_key = is_key[b] ? out : last_key
// from the stored (rounded) out pair. It replaces the TPU kernel
// drt_stack.py: _kernel_select (:278, launched at :351), the last block of a
// step on the 'pf' serving path, and runs at 64 channels only.
//
// Design (tc_conv.cuh): both stages are implicit GEMMs on the tensor cores
// (mma.sync; bf16, or 3xTF32 for float32 features). Stage 1's rows are the
// 180 pixels of the halo region (12 row tiles of 16, 3 a warp), its depth
// the nine taps of W2 over each input chunk, then three more "taps" at the
// centre pixel whose A fragments are scaled by the partition gate par_r in
// registers (the partition side path). The gain g applies between the two:
// after the last W2 step the sums become g * (sums + b2) in float32, as the
// TPU kernel applies it after its conv (drt_stack.py:226), and the gated
// steps add on. Stage 2's rows are the 128 output pixels (2 row tiles a
// warp) reading the h region directly. Each output group of 64 channels
// runs stage 1 over every input chunk (x chunks through a two-buffer ring,
// weights through a two-stage ring); the h region holds all c channels, as
// stage 2 of every group reads all of them. At c <= 64 (NARROW, the
// flagship's width) there is one group and h overwrites the x chunk
// buffers once stage 1 is done: a float32 block then needs 106 KB, and two
// run on an SM. Float32 blocks above 64 channels sum each step apart
// (conv_step's SPLIT) on their long sums; the narrow ones keep the
// registers for their second block (their error on an H100: ~1.4e-5 std).
//
// Two-launch form. When the h region does not fit (c above the one-launch
// width: DB_ONE_LAUNCH_F32 / _BF16 below), the wrapper passes a scratch
// tensor for h: launch 1 (STAGE1) computes h on the output tile and writes
// it in the feature type, as the TPU kernel stores hmid; launch 2 (STAGE2)
// stages h's chunks back like x's and runs stage 2. Each block of either
// does one output group (grid z = samples x groups).
//
// Bound (c = 64, 720p): 158.5 GFLOP a frame, over 989 TFLOP/s of bf16
// tensor cores 0.160 ms, in 3xTF32 (three TF32 products over 495 TFLOP/s)
// 0.961 ms; its bytes 0.072 (bf16) / 0.144 ms (float32). Stage 1 runs 12 row
// tiles (192 rows) for the 128 output pixels, 1.5x, which adds 29% to the
// block's mma. mma.sync is the first step; wgmma (A from registers, B
// through shared-memory descriptors) with TMA staging is the next.
#include "tc_conv.cuh"

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

template <typename T, bool SELECT>
cudaError_t launch_drt_block(const void* x, const void* par, const void* w2, const void* b2,
                             const void* g, const void* pk, const void* w1, const void* b1,
                             const void* last_key, const void* is_key, void* hbuf, void* out,
                             void* new_last_key, int b, int h, int w, int c,
                             cudaStream_t stream) {
  constexpr int ELT = sizeof(T);
  // one launch up to the widest block that fits, else two through hbuf;
  // K3s runs at 64 channels only, the pf path's width
  const int one = ELT == 2 ? DB_ONE_LAUNCH_BF16 : DB_ONE_LAUNCH_F32;
  if (c < PN || c % PN || (SELECT && c != NB) || (c > one) != (hbuf != nullptr))
    return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
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
  auto* hb = static_cast<T*>(hbuf);
  auto* o = static_cast<T*>(out);
  auto* nlk = static_cast<T*>(new_last_key);
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

template <bool SELECT>
int drt_block_entry(int dtype, const void* x, const void* par, const void* w2, const void* b2,
                    const void* g, const void* pk, const void* w1, const void* b1,
                    const void* last_key, const void* is_key, void* hbuf, void* out,
                    void* new_last_key, int b, int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_drt_block<float, SELECT>(x, par, w2, b2, g, pk, w1, b1, last_key, is_key,
                                                hbuf, out, new_last_key, b, h, w, c, s);
  if (dtype == 1)
    return (int)launch_drt_block<__nv_bfloat16, SELECT>(x, par, w2, b2, g, pk, w1, b1, last_key,
                                                        is_key, hbuf, out, new_last_key, b, h, w,
                                                        c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x, out: (b, h, w, c), c a multiple of 8;
// par: (b, h, w, 3); w2: (NW, b, 9, c, c), pk: (NW, 3, c, c), w1: (NW, 9, c,
// c) in x's type, each tap transposed (out, in), NW = 2 for float32 (the
// TF32 head and tail of tf32_split), 1 for bfloat16; b2, g: (b, c) and b1:
// (c,) float32. hbuf: null for the one-launch form; above the one-launch
// width a (b, h, w, c) scratch of x's type for h (two launches).
extern "C" int pnp_drt_block(int dtype, const void* x, const void* par, const void* w2,
                             const void* b2, const void* g, const void* pk, const void* w1,
                             const void* b1, void* hbuf, void* out, int b, int h, int w, int c,
                             void* stream) {
  return pnp::tc::drt_block_entry<false>(dtype, x, par, w2, b2, g, pk, w1, b1, nullptr, nullptr,
                                         hbuf, out, nullptr, b, h, w, c, stream);
}

// K3s: pnp_drt_block's arguments (one launch, no hbuf) plus last_key (b, h,
// w, c) of x's type and is_key (b,) float32 0/1; writes out and
// new_last_key = where(is_key, out, last_key), neither aliasing an input.
extern "C" int pnp_drt_block_select(int dtype, const void* x, const void* par, const void* w2,
                                    const void* b2, const void* g, const void* pk,
                                    const void* w1, const void* b1, const void* last_key,
                                    const void* is_key, void* out, void* new_last_key, int b,
                                    int h, int w, int c, void* stream) {
  return pnp::tc::drt_block_entry<true>(dtype, x, par, w2, b2, g, pk, w1, b1, last_key, is_key,
                                        nullptr, out, new_last_key, b, h, w, c, stream);
}

// dynamic shared memory of a one-launch block at width c (dtype 0 float32,
// 1 bfloat16), for the build report and chip_smoke.py's check of
// launch.ONE_LAUNCH_WIDTH
extern "C" int pnp_drt_block_smem(int c, int dtype) {
  return (int)pnp::tc::db_smem<pnp::tc::FUSED>(c, dtype == 1 ? 2 : 4);
}
