// K2: the BAE input conv, out = lrelu_0.1(sum_p conv3x3_same(part_p; K_p[b]) + bias),
// written as a dense NHWC (b, h, w, c) tensor.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: input_conv_pf
// (:649, pallas_call :750, body _input_conv_kernel :467). Like it, the
// concat of the parts is never built: each part is staged and convolved
// with its own per-sample kernel slice. The parts are, in concat order, the
// 3-channel lr frame and one to three c-channel features (key warp,
// neighbour, and in the forward sweep the backward feature). The align_key
// select arrives folded into the kernel slices by the wrapper (K_kw + g K_nb
// and (1 - g) K_nb), so no select runs here.
//
// Bound (c = 64, 720p): 139 (backward, 3 parts) / 207 (forward, 4 parts)
// GFLOP a frame: 0.141 / 0.209 ms on bf16 tensor cores at 989 TFLOP/s,
// 0.843 / 1.255 ms in 3xTF32 (three TF32 products at 495 TFLOP/s); the
// parts' bytes 0.107 / 0.143 (bf16) and 0.215 / 0.285 ms (float32).
//
// Two designs, picked by the width (launch_input_conv; launch.kernel_design
// says the same for the wrapper's weight layout):
//
// c = 64, every model path's width: input_conv_wg, wgmma (wg_conv.cuh).
//   - Tile: no second stage, so the output tile is the GEMM's rows: bf16 16
//     x 32 pixels (512 rows: 4 M-tiles a consumer warpgroup), float32 8 x 32
//     (256 rows: 2 M-tiles a warpgroup, for the split sum below); the staged
//     chunk tile is 18 x 34 / 10 x 34 pixels of 128 bytes.
//   - Depth: the chunks of a tile in concat order, each chunk's nine taps a
//     ring stage each: the lr frame (one k-step: 3 channels zero-padded to
//     32 bytes, staged with scalar loads; its weights a 64 x 32-byte tile,
//     32-byte swizzled, so it costs one k-step and not four), then each
//     part's chunks (bf16 one of 64 channels, float32 two of 32). Stages a
//     tile: bf16 27 / 36, float32 45 / 63 (3 / 4 parts).
//   - Weights: the wrapper's images (drt_stack.wg_image: each part's per
//     sample taps as the K-major swizzled tiles wgmma reads); ring of 4
//     stages, bf16 8 KB, float32 16 KB (TF32 head and tail) each. 4x (bf16)
//     / 2x (float32) fewer weight bytes an output pixel than the 8 x 16
//     mma.sync tile.
//   - Float32 split: the tensor cores' float32 accumulation truncates, and
//     over K2's long sums (up to 1755 terms a pixel) its bias reached
//     1.1-1.5e-4 of the output std on an H100 (the mma.sync design's SPLIT,
//     tc_conv.cuh). So each ring stage (one tap of one chunk: 4 k-steps x 3
//     products) sums into zeroed registers and is added to the running sum
//     on the CUDA cores, the mma.sync design's granularity. Two sets of 2
//     M-tiles x 32 sums fit a consumer's registers beside two fragment
//     buffers; two sets of 4 would not. bf16 keeps one set of sums.
//   - Epilogue: + bias, leaky ReLU in float32, stored from registers while
//     the producer stages the next tile's first chunks.
//   - Shared memory: bf16 190,560 bytes, float32 153,696 (ic_wg_smem).
//
// Other widths (8, 24, the 128 of phase 5): input_conv_tc, conv_tc's loop
// (tc_conv.cuh): an implicit GEMM on mma.sync whose rows are the 128 pixels
// of an 8 x 16 output tile and whose columns are a group of 64 output
// channels (grid z: samples x groups), its depth every part's nine taps
// over the part's input chunks, the lr frame staged with scalar loads
// zero-padded to one mma k-step; chunks through two buffers, weight taps
// through a two-stage ring, each loaded with cp.async while the previous
// step computes; in 3xTF32 each step sums apart (conv_step's SPLIT). It
// also runs at 64 channels through pnp_input_conv_mma_sync, the yardstick
// chip_smoke.py times the wgmma design against.
#include "tc_conv.cuh"
#include "wg_conv.cuh"

namespace pnp {
namespace tc {

constexpr int IC_NLR = 3;  // lr channels

// Weights (the wrapper's layout): wlr (NW, b, 9, c, KP) with KP = one
// k-step of channels (16 bf16, 8 float), the lr part's taps transposed and
// zero-padded past 3 input channels; wk (NW, b, 9, c, c) for each wide part,
// transposed; NW = 2 for float32 (TF32 head, tail). bias (c,) float32.
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    input_conv_tc(const T* __restrict__ lr, const T* __restrict__ p0, const T* __restrict__ p1,
                  const T* __restrict__ p2, const T* __restrict__ wlr, const T* __restrict__ w0,
                  const T* __restrict__ w1, const T* __restrict__ w2,
                  const float* __restrict__ bias, T* __restrict__ out, int bsz, int h, int w,
                  int nwide, int c) {
  using Op = Operand<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ngr = cdiv(c, NB), b = blockIdx.z / ngr, g = blockIdx.z % ngr;
  const size_t img = (size_t)b * h * w;
  const ConvIn<T> in[4] = {
      {lr, wlr, IC_NLR, Op::KSTEP_CH}, {p0, w0, c, c}, {p1, w1, c, c}, {p2, w2, c, c}};
  conv_tc<T, 0, Op::NW, true>(
      in, 1 + nwide, true, bsz, b, h, w, c, g, g + 1, smem, smem + 2 * Region<0>::NA * PITCH,
      [&](int co0, auto& acc) {
        for_each_out_pair(acc, co0, c, h, w, [&](size_t px, int n, float v0, float v1) {
          store2(out + (img + px) * c + n, lrelu(v0 + bias[n]), lrelu(v1 + bias[n + 1]));
        });
      });
}

// ---- the wgmma design (c = 64) ----------------------------------------------------

// per feature type: output tile rows (x 32 columns), a consumer
// warpgroup's M-tiles, 128-byte chunks of a 64-channel part, weight terms,
// ring stages, and whether each stage sums apart
template <typename T> struct ICType;
template <> struct ICType<__nv_bfloat16> {
  static constexpr int TH = 16, MT = 4, KB = 1, NW = 1, NS = 4;
  static constexpr bool SPLIT = false;
};
template <> struct ICType<float> {
  static constexpr int TH = 8, MT = 2, KB = 2, NW = 2, NS = 4;
  static constexpr bool SPLIT = true;
};
template <typename T>
struct ICGeo : ICType<T> {
  using P = ICType<T>;
  static constexpr int TW = wgc::RW;                   // output tile columns
  static constexpr int NO = P::TH * TW;                // output rows of a tile
  static constexpr int XH = P::TH + 2, NX = XH * wgc::XW;  // staged chunk tile
  static constexpr int STAGE = P::NW * wgc::BTILE;     // a ring stage
  static constexpr int LRSTAGE = P::NW * wgc::LRTILE;  // the lr part's stage
  static_assert(NO == 64 * wgc::NCW * P::MT, "the output tile is whole M-tiles");
};

// dynamic shared memory of a block: 1024 bytes to align the ring, the ring,
// two chunk buffers and the barriers
template <typename T>
__host__ __device__ constexpr size_t ic_wg_smem() {
  using G = ICGeo<T>;
  return 1024 + (size_t)G::NS * G::STAGE + (size_t)2 * G::NX * wgc::CHB +
         sizeof(uint64_t) * (2 * G::NS + 4);
}
static_assert(ic_wg_smem<float>() <= SMEM_MAX && ic_wg_smem<__nv_bfloat16>() <= SMEM_MAX,
              "a wgmma input-conv block fits an SM's shared memory");

// Weights (the wrapper's images, drt_stack.wg_image): wlr (b, 9, 1, NW, 64,
// 32 bytes), 32-byte swizzled; wk (b, 9, KB, NW, 64, 128 bytes) for each
// wide part, 128-byte swizzled; each (tap[, k-block]) one ring stage; bias
// (64,) float32.
template <typename T>
__global__ void __launch_bounds__(wgc::NTHR, 1)
    input_conv_wg(const T* __restrict__ lr, const T* __restrict__ p0, const T* __restrict__ p1,
                  const T* __restrict__ p2, const T* __restrict__ wlr, const T* __restrict__ w0,
                  const T* __restrict__ w1, const T* __restrict__ w2,
                  const float* __restrict__ bias, T* __restrict__ out, int bsz, int h, int w,
                  int nwide) {
  using G = ICGeo<T>;
  using namespace wgc;
  constexpr int ELT = sizeof(T), TH = G::TH, MT = G::MT, KB = G::KB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = align1024(smem_raw);
  uint8_t* xs = ringb + G::NS * G::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 2 * G::NX * CHB);
  uint64_t* empty = full + G::NS;
  uint64_t* xfull = empty + G::NS;  // two
  uint64_t* xempty = xfull + 2;     // two
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NS; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&xfull[k], NXLOAD);
      wg::mbar_init(&xempty[k], NCONS / 32);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int ntx = cdiv(w, G::TW), nty = cdiv(h, TH), per = ntx * nty, ntiles = bsz * per;
  const int nch = 1 + nwide * KB;  // chunks a tile: the lr frame, then each part's
  const int lane = threadIdx.x % 32;
  // the warpgroup, warp-uniform as the compiler sees it
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  WRing<G::NS, G::STAGE> ring{ringb, full, empty};
  XRing<G::NX * CHB> xr{xs, xfull, xempty};

  if (wgi == NCW) {
    // ---- the producer warpgroup: warp 0 the weight ring (one thread),
    // warps 1-3 the chunks
    wg::setmaxnreg_dec<REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid < 32) {
      if (ptid == 0) {
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          const size_t b = t / per;
          for (int tap = 0; tap < 9; ++tap)
            ring.put(wlr + (b * 9 + tap) * (G::LRSTAGE / ELT), G::LRSTAGE);
          for (int p = 0; p < nwide; ++p) {
            const T* wp = p == 0 ? w0 : p == 1 ? w1 : w2;
            for (int kb = 0; kb < KB; ++kb)
              for (int tap = 0; tap < 9; ++tap)
                ring.put(wp + ((b * 9 + tap) * KB + kb) * (G::STAGE / ELT), G::STAGE);
          }
        }
        ring.drain();
      }
      return;
    }
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      for (int ci = 0; ci < nch; ++ci, ++xr.g) {
        uint8_t* dst = xr.claim();
        // recomputed each chunk: nothing per thread is kept across the loop
        const int xt = wg::opaque(ptid - 32), tt = wg::opaque(t);
        const int b = tt / per, y0 = (tt % per) / ntx * TH - 1, x0 = tt % ntx * G::TW - 1;
        if (ci == 0) {
          // the lr frame: 3 channels a pixel, zero-padded to 32 bytes
          const T* src = lr + (size_t)b * h * w * IC_NLR;
          for (int q = xt; q < G::NX; q += NXLOAD) {
            const int qy = q / XW, y = y0 + qy, xx = x0 + (q - qy * XW);
            uint4 v = make_uint4(0, 0, 0, 0);
            if ((unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w) {
              T* e = reinterpret_cast<T*>(&v);
              const T* s = src + (y * w + xx) * IC_NLR;
#pragma unroll
              for (int k = 0; k < IC_NLR; ++k) e[k] = s[k];
            }
            *reinterpret_cast<uint4*>(xpiece(dst, q, 0)) = v;
            *reinterpret_cast<uint4*>(xpiece(dst, q, 1)) = make_uint4(0, 0, 0, 0);
          }
          wg::mbar_arrive(&xr.full[xr.g & 1]);
        } else {
          const int p = (ci - 1) / KB, kb = (ci - 1) % KB;
          const T* src = (p == 0 ? p0 : p == 1 ? p1 : p2) + (size_t)b * h * w * C;
          stage_chunk_wg<T>(dst, src, kb * (CHB / ELT), h, w, y0, x0, XW, G::NX, xt,
                            &xr.full[xr.g & 1]);
        }
      }
    }
    cp_async_wait_all();  // the last chunk's copies have landed
    return;
  }

  // ---- the consumer warpgroups (tile coordinates recomputed from opaque
  // copies where needed: the sums and fragments hold the registers)
  wg::setmaxnreg_inc<REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  float acc[MT][32];
  float part[G::SPLIT ? MT : 1][32];
  // one ring stage of one tap; float32 sums it apart, then adds it on
  auto step = [&](auto ks_c, auto sw32_c, const uint8_t* xb, int base, int tap) {
    constexpr int KS = decltype(ks_c)::value;
    constexpr bool SW32 = decltype(sw32_c)::value;
    const int off = (tap / 3) * XW + tap % 3;
    ring.take([&](const uint8_t* st) {
      if constexpr (G::SPLIT) {
        zero(part);
        conv_stage<T, MT, WGGroup<T>::MG, KS, G::NW, SW32>(part, xb, base, off, st);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int k = 0; k < 32; ++k) acc[m][k] += part[m][k];
      } else {
        conv_stage<T, MT, WGGroup<T>::MG, KS, G::NW, SW32>(acc, xb, base, off, st);
      }
    });
  };
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // row p = 64 (MT wgi + m) + 16 warp + lane % 16 of the tile reads
    // chunk-tile pixel (p / 32 + dy, p % 32 + dx) at tap (dy, dx)
    const int p0 = 64 * MT * wgi + 16 * warp + lane % 16;
    const int base = (p0 / G::TW) * XW + p0 % G::TW;
    zero(acc);
    {  // the lr frame: one k-step a tap
      const uint8_t* xb = xr.wait();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        step(std::integral_constant<int, 1>(), std::true_type(), xb, wg::opaque(base), tap);
      xr.release();
      ++xr.g;
    }
    for (int ci = 1; ci < nch; ++ci, ++xr.g) {
      const uint8_t* xb = xr.wait();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        step(std::integral_constant<int, 4>(), std::false_type(), xb, wg::opaque(base), tap);
      xr.release();
    }
    // out = lrelu(sums + bias), as T
    const int tt = wg::opaque(t), ln = wg::opaque(lane);
    const int b = tt / per, y0 = (tt % per) / ntx * TH, x0 = tt % ntx * G::TW;
    const size_t img = (size_t)b * h * w;
    const int gq = ln / 4, t4 = ln % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float c0 = bias[n], c1 = bias[n + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * (MT * wgi + m) + 16 * warp + gq + 8 * hf;
          const int y = y0 + r / G::TW, xx = x0 + r % G::TW;
          if (y >= h || xx >= w) continue;
          store2(out + (img + (size_t)y * w + xx) * C + n, lrelu(acc[m][4 * j + 2 * hf] + c0),
                 lrelu(acc[m][4 * j + 2 * hf + 1] + c1));
        }
    }
  }
}

// tiles of the wgmma design's walk (drt_stack.wg_tile_walk with IC_TILE
// mirrors it)
template <typename T>
__host__ __device__ constexpr int ic_wg_tiles(int b, int h, int w) {
  return b * cdiv(h, ICGeo<T>::TH) * cdiv(w, ICGeo<T>::TW);
}

template <typename T>
cudaError_t launch_input_conv_wg(const T* lr, const T* p0, const T* p1, const T* p2,
                                 const T* wlr, const T* w0, const T* w1, const T* w2,
                                 const float* bias, T* out, int b, int h, int w, int nwide,
                                 cudaStream_t stream) {
  // the producer addresses a sample's pixels with 32-bit offsets
  if ((long long)h * w * wgc::C >= (1LL << 31)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = input_conv_wg<T>;
  const size_t smem = ic_wg_smem<T>();
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = wgc::sm_count(sms)) != cudaSuccess) return e;
  const int grid = imin(ic_wg_tiles<T>(b, h, w), sms);
  k<<<grid, wgc::NTHR, smem, stream>>>(lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b, h, w,
                                       nwide);
  return cudaGetLastError();
}

// design: 0 by the width (the wgmma design at 64 channels, conv_tc at any
// other), 1 conv_tc at any width (the yardstick)
template <typename T>
cudaError_t launch_input_conv(int design, const void* lr, const void* p0, const void* p1,
                              const void* p2, const void* wlr, const void* w0, const void* w1,
                              const void* w2, const void* bias, void* out, int b, int h, int w,
                              int nwide, int c, cudaStream_t stream) {
  if (c < PN || c % PN || nwide < 1 || nwide > 3 || (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  const auto* lrt = static_cast<const T*>(lr);
  const auto* p0t = static_cast<const T*>(p0);
  const auto* p1t = static_cast<const T*>(p1);
  const auto* p2t = static_cast<const T*>(p2);
  const auto* wlrt = static_cast<const T*>(wlr);
  const auto* w0t = static_cast<const T*>(w0);
  const auto* w1t = static_cast<const T*>(w1);
  const auto* w2t = static_cast<const T*>(w2);
  const auto* bf = static_cast<const float*>(bias);
  auto* o = static_cast<T*>(out);
  if (design == 0 && c == wgc::C)
    return launch_input_conv_wg<T>(lrt, p0t, p1t, p2t, wlrt, w0t, w1t, w2t, bf, o, b, h, w, nwide,
                                   stream);
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = input_conv_tc<T>;
  const size_t smem = conv_tc_smem(Operand<T>::NW);
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, b * cdiv(c, NB));
  k<<<grid, NTHR, smem, stream>>>(lrt, p0t, p1t, p2t, wlrt, w0t, w1t, w2t, bf, o, b, h, w, nwide,
                                  c);
  return cudaGetLastError();
}

int input_conv_entry(int design, int dtype, const void* lr, const void* p0, const void* p1,
                     const void* p2, const void* wlr, const void* w0, const void* w1,
                     const void* w2, const void* bias, void* out, int b, int h, int w, int nwide,
                     int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_input_conv<float>(design, lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b,
                                         h, w, nwide, c, s);
  if (dtype == 1)
    return (int)launch_input_conv<__nv_bfloat16>(design, lr, p0, p1, p2, wlr, w0, w1, w2, bias,
                                                 out, b, h, w, nwide, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. lr: (b, h, w, 3); p0..p2: (b, h, w, c), the
// first nwide (1..3) used, c a multiple of 8; bias: (c,) float32; out: (b,
// h, w, c). The per-sample kernels in the features' type, NW = 2 for
// float32 (tf32_split's head and tail), 1 for bfloat16: at c = 64 (the
// wgmma design) drt_stack.wg_image's shared-memory images wlr (b, 9, 1, NW,
// 64, 32 bytes) of the lr part zero-padded to one k-step, w0..w2 (b, 9, KB,
// NW, 64, 128 bytes); at any other width wlr: (NW, b, 9, c, KP) zero-padded
// to KP = 16 (bfloat16) or 8 (float32) input channels and w0..w2: (NW, b,
// 9, c, c), each tap transposed (out, in).
extern "C" int pnp_input_conv(int dtype, const void* lr, const void* p0, const void* p1,
                              const void* p2, const void* wlr, const void* w0, const void* w1,
                              const void* w2, const void* bias, void* out, int b, int h, int w,
                              int nwide, int c, void* stream) {
  return pnp::tc::input_conv_entry(0, dtype, lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b, h, w,
                                   nwide, c, stream);
}

// The mma.sync design (conv_tc) at 64 channels too, with pnp_input_conv's
// arguments in the (NW, b, 9, c, ...) layout. chip_smoke.py times it
// beside the wgmma design as the yardstick; no model path calls it.
extern "C" int pnp_input_conv_mma_sync(int dtype, const void* lr, const void* p0, const void* p1,
                                       const void* p2, const void* wlr, const void* w0,
                                       const void* w1, const void* w2, const void* bias,
                                       void* out, int b, int h, int w, int nwide, int c,
                                       void* stream) {
  return pnp::tc::input_conv_entry(1, dtype, lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b, h, w,
                                   nwide, c, stream);
}

// dynamic shared memory of one block at width c (dtype 0 float32, 1
// bfloat16) in the design the width takes, for the build report
extern "C" int pnp_input_conv_smem(int c, int dtype) {
  if (c == pnp::tc::wgc::C)
    return (int)(dtype == 1 ? pnp::tc::ic_wg_smem<__nv_bfloat16>() : pnp::tc::ic_wg_smem<float>());
  return (int)pnp::tc::conv_tc_smem(dtype == 1 ? 1 : 2);
}
