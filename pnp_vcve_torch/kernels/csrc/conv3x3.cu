// K5: a 'same' 3x3 convolution with per-sample kernels, biases and gains,
//   out[b] = g[b] * (conv3x3(x[b]; W[b]) + bias[b])
// x (b, h, w, c_in) NHWC in float or __nv_bfloat16, out (b, h, w, c_out) in
// x's type; sums in float32, the bias and the gain applied to them in
// float32, one rounding to x's type, no activation.
//
// Replaces three TPU kernels that compute this one function in three
// layouts: pnp_vcve_tpu/kernels/conv_block.py: conv3x3_pallas (:86), and
// conv_packed.py: conv3x3_packed (:48) and conv3x3_packed_v2 (:118), the
// last two on the pixel-pair layout. As there, the input is read from device
// memory once per output tile and the per-sample kernel stays on the chip.
// The gain is that of ops/dynamic_conv.py: dynamic_conv2d(..., gamma=), after
// the bias, as JAX applies it; it is not folded into the weights, which are
// rounded as the plain version rounds them (bfloat16 weights for bfloat16
// features).
//
// Bound (64 -> 64, 720p): 67.9 GFLOP a frame, 0.069 ms on the bf16 tensor
// cores at 989 TFLOP/s, 0.412 ms in 3xTF32 (three TF32 products at 495
// TFLOP/s); the features' bytes 0.14 ms (float32) / 0.07 ms (bf16).
//
// Two designs, picked by the widths (launch_conv3x3; launch.kernel_design
// says the same for the wrapper's weight layout):
//
// 64 -> 64, the width of every model path (the unfused DRT block forms'
// two convs, models/bae.py): conv3x3_wg, wgmma (wg_conv.cuh), K2's
// input_conv_wg with one 64-channel part, no lr part and this epilogue.
//   - Block: two consumer warpgroups and a producer warpgroup (setmaxnreg
//     232 / 40), one block an SM, persistent over output tiles of 32
//     columns in (sample, tile row, tile column) order (drt_stack.
//     wg_tile_walk with K5_TILE): bf16 16 rows (512 GEMM rows, 4 M-tiles of
//     64 a warpgroup), float32 12 (3 M-tiles a warpgroup, below).
//   - Weights: the wrapper's per-sample images (drt_stack.wg_image: each
//     tap as the K-major, 128-byte swizzled 64 x 128-byte tiles wgmma
//     reads; float32 two 32-channel k-blocks a tap, each its TF32 head and
//     tail), one cp.async.bulk a (k-block, tap) onto a ring of 4 stages
//     (bf16 8 KB, float32 16 KB).
//   - Input: each chunk of 128 bytes a pixel (bf16 the 64 channels,
//     float32 32 of them) of the (rows + 2) x 34 tile, zeros outside the
//     image, pixel-swizzled, into two chunk buffers, so the next tile's
//     chunks land while this one multiplies. Float32 stages a chunk as one
//     tensor-map box from one producer thread (as K10's tapconv_wg), bf16
//     by producer warps 1-3's cp.async: each the faster of the two for its
//     type on the card (PERF.md); pnp_conv3x3_wg_alt_staging runs the other
//     one, for chip_smoke.py to time them against each other.
//   - Products: a chunk's nine taps run as one stream of wgmma commit groups
//     (chunk_taps below: a k-step and a group of M-tiles each, bf16 all
//     four of a warpgroup, float32 one; A by ldmatrix at the tap's offset,
//     B through the stage's descriptor) through two
//     fragment buffers, each group waiting only for the one two back; a
//     tap's weight stage is released while the next tap's products run, so
//     the tensor cores are not drained at every tap (K2's conv_stage drains
//     them). bf16 m64n64k16; float32 3xTF32, three m64n64k8 products a
//     k-step (lo*hi, hi*lo, hi*hi) into one set of float32 sums: K5's 576
//     terms, like K3's stage 1 at 64 channels, need no per-stage split sum
//     (K2's 1755 did): one set of 96 float32 sums a thread.
//   - Epilogue: g * (sums + bias) in float32, rounded to T, stored from
//     registers while the producer stages the next tile's chunks.
//   - Shared memory: bf16 191,584 bytes, float32 189,536 (cv_wg_smem).
//
// Any other (c_in, c_out): conv3x3_tc, K2's mma.sync GEMM loop (conv_tc,
// tc_conv.cuh) with one input and an epilogue of bias and gain: an implicit
// GEMM (bf16, or 3xTF32 for float32 features, each step summed apart: the
// sums reach 9 x 195 terms at the model's widest input conv) over an 8 x 16
// output tile by a group of 64 output channels; grid z runs over samples x
// groups. Any c_in: an input whose pixels are not 16-byte aligned (c_in % 8
// != 0) is staged with scalar loads, its weight rows zero-padded to whole
// 16-byte vectors; a last group narrower than 64 (c_out % 64) stages its
// weights zero-padded and stores nothing past its width. It also runs at 64
// -> 64 through pnp_conv3x3_mma_sync, the yardstick chip_smoke.py times the
// wgmma design against.
#include "tc_conv.cuh"
#include "wg_conv.cuh"

namespace pnp {
namespace tc {

// a weight row's length: c_in padded to whole 16-byte vectors (8 channels)
__host__ __device__ constexpr int cv_wc(int cin) { return cdiv(cin, 8) * 8; }

// wk (NW, b, 9, cout, cv_wc(cin)) per-sample taps transposed (out, in),
// NW = 2 for float32 (TF32 head, tail); bias and gain (b, cout) float32.
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    conv3x3_tc(const T* __restrict__ x, const T* __restrict__ wk, const float* __restrict__ bias,
               const float* __restrict__ gain, T* __restrict__ out, int bsz, int h, int w,
               int cin, int cout) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ngr = cdiv(cout, NB), b = blockIdx.z / ngr, g = blockIdx.z % ngr;
  const size_t img = (size_t)b * h * w;
  const float* bb = bias + (size_t)b * cout;
  const float* gb = gain + (size_t)b * cout;
  const ConvIn<T> in[1] = {{x, wk, cin, cv_wc(cin)}};
  conv_tc<T, 0, Operand<T>::NW, true>(
      in, 1, true, bsz, b, h, w, cout, g, g + 1, smem, smem + 2 * Region<0>::NA * PITCH,
      [&](int co0, auto& acc) {
        for_each_out_pair(acc, co0, cout, h, w, [&](size_t px, int n, float v0, float v1) {
          store2(out + (img + px) * cout + n, gb[n] * (v0 + bb[n]),
                 gb[n + 1] * (v1 + bb[n + 1]));
        });
      });
}

// ---- the wgmma design (64 -> 64) ---------------------------------------------------

// per feature type: output tile rows (x 32 columns; drt_stack.K5_TILE), a
// consumer warpgroup's M-tiles, M-tiles a commit group, 128-byte chunks of
// the 64 input channels (k-blocks) and weight terms. Float32 takes 12 rows
// and one M-tile a group: its two fragment buffers of TF32 heads and tails
// stay live across the tap loop, and beside 128 sums (16 rows) they spilled.
template <typename T> struct CVType;
template <> struct CVType<__nv_bfloat16> {
  static constexpr int TH = 16, MT = 4, MG = 4, KB = 1, NW = 1;
};
template <> struct CVType<float> {
  static constexpr int TH = 12, MT = 3, MG = 1, KB = 2, NW = 2;
};
template <typename T>
struct CVGeo : CVType<T> {
  static constexpr int TH = CVType<T>::TH, MT = CVType<T>::MT;
  static constexpr int TW = wgc::RW, NS = 4;           // output tile columns; ring stages
  static constexpr int NX = (TH + 2) * wgc::XW;        // staged chunk tile
  // a chunk buffer, 1024-aligned: the tensor map's 128-byte swizzle is
  // taken on the address, xpiece's on the pixel
  static constexpr int XB = (NX * wgc::CHB + 1023) / 1024 * 1024;
  static constexpr int STAGE = CVType<T>::NW * wgc::BTILE;  // a ring stage
  static_assert(TH * TW == 64 * wgc::NCW * MT, "the output tile is whole M-tiles");
};

// dynamic shared memory of a block: 1024 bytes to align the ring, the ring,
// two chunk buffers and the barriers
template <typename T>
__host__ __device__ constexpr size_t cv_wg_smem() {
  using G = CVGeo<T>;
  return 1024 + (size_t)G::NS * G::STAGE + (size_t)2 * G::XB +
         sizeof(uint64_t) * (2 * G::NS + 4);
}
static_assert(cv_wg_smem<float>() <= SMEM_MAX && cv_wg_smem<__nv_bfloat16>() <= SMEM_MAX,
              "a wgmma K5 block fits an SM's shared memory");

template <int N, int I = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>());
    static_for<N, I + 1>(f);
  }
}

// The nine taps of one chunk xb for a warpgroup's NM M-tiles (rows at
// pixels base + 2 XW m + the tap's offset) as one stream of commit groups,
// a k-step and MG M-tiles each (NU a tap), through two fragment buffers:
// each group loads its A while the one before multiplies and waits only
// for the group two back, which read the buffer it overwrites. Tap t's
// weight stage (waited for at wr) is released once its last group
// has completed, while tap t + 1's products run (one ring position for
// both: the release is two stages back). Tap 0 is peeled, so no wgmma sits
// behind a runtime condition. Ends with every group complete.
template <typename T, int NM, int MG, typename Ring>
__device__ __forceinline__ void chunk_taps(float (&acc)[NM][32], const uint8_t* xb, int base,
                                           Ring& wr) {
  using wgc::XW;
  constexpr int NG = cdiv(NM, MG), NU = 4 * NG;
  static_assert(NU % 2 == 0, "a tap's groups alternate the buffers evenly");
  const int half = (threadIdx.x % 32) / 16;
  wgc::AFrag<T, MG> f[2];
  auto group = [&](const uint8_t* st, int off, auto u_c) {
    constexpr int U = decltype(u_c)::value, KS = U / NG, M0 = (U % NG) * MG;
    wgc::AFrag<T, MG>& cur = f[U % 2];
    const uint64_t d0 = wg::desc_add(wg::desc_sw128(st), KS * KSTEP_BYTES);
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      if (M0 + k >= NM) break;
      const uint8_t* at = wgc::xpiece(xb, base + 2 * XW * (M0 + k) + off, 2 * KS + half);
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        ldmatrix_x4(cur.a[k], at);
      } else {  // split in place: no registers beyond the fragments
        ldmatrix_x4(cur.hi[k], at);
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(cur.hi[k][r], cur.hi[k][r], cur.lo[k][r]);
      }
    }
    cur.hold();
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
    wg::fence();
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      if (M0 + k >= NM) break;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        wg::mma_bf16(acc[M0 + k], cur.a[k], d0);
      } else {
        const uint64_t d1 = wg::desc_add(d0, wgc::BTILE);  // the weights' TF32 tail
        wg::mma_tf32(acc[M0 + k], cur.lo[k], d0);  // the small terms first
        wg::mma_tf32(acc[M0 + k], cur.hi[k], d1);
        wg::mma_tf32(acc[M0 + k], cur.hi[k], d0);
      }
    }
    wg::commit();
  };
  auto step = [&](auto u_c) {  // the group two back, which read this buffer, is done
    wg::wait<1>();
    f[decltype(u_c)::value % 2].hold();
  };
  {
    const uint8_t* st = wr.wait();
    static_for<NU>([&](auto u) {
      if constexpr (decltype(u)::value >= 2) step(u);
      group(st, 0, u);
    });
  }
#pragma unroll 1
  for (int tap = 1; tap < 9; ++tap) {
    const int off = (tap / 3) * XW + tap % 3;
    const uint8_t* st = wr.wait();
    static_for<NU>([&](auto u) {
      step(u);
      if constexpr (decltype(u)::value == 1) wr.release_back(2);  // tap - 1's last group is done
      group(st, off, u);
    });
  }
  wg::wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
  f[0].hold();
  f[1].hold();
  wr.release_back(1);
}

// Weights (the wrapper's images, drt_stack.wg_image): wk (b, 9, KB, NW, 64,
// 128 bytes), 128-byte swizzled, each (tap, k-block) one ring stage; bias
// and gain (b, 64) float32. TX: the chunks by tensor-map boxes (tm_x: x as
// (64, w, h, b) in boxes of 128 bytes x 34 x (rows + 2) x 1, 128-byte
// swizzled, zeros outside the image), else by producer warps 1-3's cp.async.
template <typename T, bool TX>
__global__ void __launch_bounds__(wgc::NTHR, 1)
    conv3x3_wg(const __grid_constant__ CUtensorMap tm_x, const T* __restrict__ x,
               const T* __restrict__ wk, const float* __restrict__ bias,
               const float* __restrict__ gain, T* __restrict__ out, int bsz, int h, int w) {
  using G = CVGeo<T>;
  using namespace wgc;
  constexpr int ELT = sizeof(T), TH = G::TH, MT = G::MT, KB = G::KB;
  using Ring = WRing<G::NS, G::STAGE>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = align1024(smem_raw);
  uint8_t* xs = ringb + G::NS * G::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 2 * G::XB);
  uint64_t* empty = full + G::NS;
  uint64_t* xfull = empty + G::NS;  // two
  uint64_t* xempty = xfull + 2;     // two
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NS; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&xfull[k], TX ? 1 : NXLOAD);
      wg::mbar_init(&xempty[k], NCONS / 32);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int ntx = cdiv(w, G::TW), nty = cdiv(h, TH), per = ntx * nty, ntiles = bsz * per;
  const int lane = threadIdx.x % 32;
  // the warpgroup, warp-uniform as the compiler sees it
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  Ring ring{ringb, full, empty};
  XRing<G::XB> xr{xs, xfull, xempty};

  if (wgi == NCW) {
    // ---- the producer warpgroup: warp 0 the weight ring (one thread),
    // warps 1-3 the chunks
    wg::setmaxnreg_dec<REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid < 32) {
      if (ptid == 0) {
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          const size_t b = t / per;
          for (int kb = 0; kb < KB; ++kb)
            for (int tap = 0; tap < 9; ++tap)
              ring.put(wk + ((b * 9 + tap) * KB + kb) * (G::STAGE / ELT), G::STAGE);
        }
        ring.drain();
      }
      return;
    }
    if constexpr (TX) {  // one thread: a box a chunk
      if (ptid == 32) {
        tma::prefetch(&tm_x);
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          const int b = t / per, y0 = (t % per) / ntx * TH - 1, x0 = t % ntx * G::TW - 1;
          for (int kb = 0; kb < KB; ++kb, ++xr.g) {
            uint8_t* dst = xr.claim();
            wg::mbar_arrive_tx(&xr.full[xr.g & 1], G::NX * CHB);
            tma::load_4d(dst, &tm_x, kb * (CHB / ELT), x0, y0, b, &xr.full[xr.g & 1]);
          }
        }
      }
      return;
    }
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      for (int kb = 0; kb < KB; ++kb, ++xr.g) {
        uint8_t* dst = xr.claim();
        // recomputed each chunk: nothing per thread is kept across the loop
        const int xt = wg::opaque(ptid - 32), tt = wg::opaque(t);
        const int b = tt / per, y0 = (tt % per) / ntx * TH - 1, x0 = tt % ntx * G::TW - 1;
        stage_chunk_wg<T>(dst, x + (size_t)b * h * w * C, kb * (CHB / ELT), h, w, y0, x0, XW,
                          G::NX, xt, &xr.full[xr.g & 1]);
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
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // row p = 64 (MT wgi + m) + 16 warp + lane % 16 of the tile reads
    // chunk-tile pixel (p / 32 + dy, p % 32 + dx) at tap (dy, dx)
    const int p0 = 64 * MT * wgi + 16 * warp + lane % 16;
    const int base = (p0 / G::TW) * XW + p0 % G::TW;
    zero(acc);
    for (int kb = 0; kb < KB; ++kb, ++xr.g) {
      chunk_taps<T, MT, G::MG>(acc, xr.wait(), wg::opaque(base), ring);
      xr.release();
    }
    // out = gain * (sums + bias), as T
    const int tt = wg::opaque(t), ln = wg::opaque(lane);
    const int b = tt / per, y0 = (tt % per) / ntx * TH, x0 = tt % ntx * G::TW;
    const size_t img = (size_t)b * h * w;
    const float* bb = bias + (size_t)b * C;
    const float* gb = gain + (size_t)b * C;
    const int gq = ln / 4, t4 = ln % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const float b0 = bb[n], b1 = bb[n + 1], g0 = gb[n], g1 = gb[n + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 64 * (MT * wgi + m) + 16 * warp + gq + 8 * hf;
          const int y = y0 + r / G::TW, xx = x0 + r % G::TW;
          if (y >= h || xx >= w) continue;
          store2(out + (img + (size_t)y * w + xx) * C + n, g0 * (acc[m][4 * j + 2 * hf] + b0),
                 g1 * (acc[m][4 * j + 2 * hf + 1] + b1));
        }
    }
  }
}

// tiles of the wgmma design's walk (drt_stack.wg_tile_walk with K5_TILE
// mirrors it)
template <typename T>
__host__ __device__ constexpr int cv_wg_tiles(int b, int h, int w) {
  return b * cdiv(h, CVGeo<T>::TH) * cdiv(w, CVGeo<T>::TW);
}

template <typename T, bool TX>
cudaError_t launch_conv3x3_wg(const T* x, const T* wk, const float* bias, const float* gain,
                              T* out, int b, int h, int w, cudaStream_t stream) {
  // the producer addresses a sample's pixels with 32-bit offsets
  if ((long long)h * w * wgc::C >= (1LL << 31)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  CUtensorMap tm_x{};
  cudaError_t e;
  if (TX) {
    constexpr int ELT = sizeof(T);
    const uint64_t dims[4] = {(uint64_t)wgc::C, (uint64_t)w, (uint64_t)h, (uint64_t)b};
    const uint64_t str[3] = {(uint64_t)wgc::C * ELT, (uint64_t)w * wgc::C * ELT,
                             (uint64_t)h * w * wgc::C * ELT};
    const uint32_t box[4] = {wgc::CHB / ELT, wgc::XW, CVGeo<T>::TH + 2, 1};
    const auto type =
        ELT == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    e = tma::encode(&tm_x, type, x, 4, dims, str, box, 128);
    if (e != cudaSuccess) return e;
  }
  auto k = conv3x3_wg<T, TX>;
  const size_t smem = cv_wg_smem<T>();
  e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = wgc::sm_count(sms)) != cudaSuccess) return e;
  const int grid = imin(cv_wg_tiles<T>(b, h, w), sms);
  k<<<grid, wgc::NTHR, smem, stream>>>(tm_x, x, wk, bias, gain, out, b, h, w);
  return cudaGetLastError();
}

// design: 0 by the widths (the wgmma design at 64 -> 64, its chunks by
// tensor-map boxes in float32 and by cp.async in bf16; conv_tc at any other
// pair), 1 conv_tc at any widths (the yardstick), 2 the wgmma design with
// the other staging of its chunks (64 -> 64 only)
template <typename T>
cudaError_t launch_conv3x3(int design, const void* x, const void* wk, const void* bias,
                           const void* gain, void* out, int b, int h, int w, int cin, int cout,
                           cudaStream_t stream) {
  if (cin < 1 || cout < PN || cout % PN || design < 0 || design > 2)
    return cudaErrorInvalidValue;
  const bool square = cin == wgc::C && cout == wgc::C;
  if (design == 2 && !square) return cudaErrorInvalidValue;
  // the chunks by tensor-map boxes: float32's staging, and bf16's other one
  const bool boxes = std::is_same<T, float>::value == (design == 0);
  if (design != 1 && square)
    return (boxes ? launch_conv3x3_wg<T, true> : launch_conv3x3_wg<T, false>)(
        static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<const float*>(bias),
        static_cast<const float*>(gain), static_cast<T*>(out), b, h, w, stream);
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = conv3x3_tc<T>;
  const size_t smem = conv_tc_smem(Operand<T>::NW);
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, b * cdiv(cout, NB));
  k<<<grid, NTHR, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(wk),
                                  static_cast<const float*>(bias), static_cast<const float*>(gain),
                                  static_cast<T*>(out), b, h, w, cin, cout);
  return cudaGetLastError();
}

int conv3x3_entry(int design, int dtype, const void* x, const void* wk, const void* bias,
                  const void* gain, void* out, int b, int h, int w, int cin, int cout,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_conv3x3<float>(design, x, wk, bias, gain, out, b, h, w, cin, cout, s);
  if (dtype == 1)
    return (int)launch_conv3x3<__nv_bfloat16>(design, x, wk, bias, gain, out, b, h, w, cin,
                                              cout, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, cin), any cin >= 1; bias,
// gain: (b, cout) float32; out: (b, h, w, cout) = gain * (conv + bias);
// cout a multiple of 8. The per-sample taps in x's type, NW = 2 for float32
// (tf32_split's head and tail), 1 for bfloat16: at 64 -> 64 (the wgmma
// design) drt_stack.wg_image's shared-memory images wk (b, 9, KB, NW, 64,
// 128 bytes); at any other pair wk: (NW, b, 9, cout, wc), each tap
// transposed (out, in), wc = cin rounded up to a multiple of 8 (zeros past
// cin).
extern "C" int pnp_conv3x3(int dtype, const void* x, const void* wk, const void* bias,
                           const void* gain, void* out, int b, int h, int w, int cin, int cout,
                           void* stream) {
  return pnp::tc::conv3x3_entry(0, dtype, x, wk, bias, gain, out, b, h, w, cin, cout, stream);
}

// The mma.sync design (conv_tc) at 64 -> 64 too, with pnp_conv3x3's
// arguments in the (NW, b, 9, cout, wc) layout. chip_smoke.py times it
// beside the wgmma design as the yardstick; no model path calls it.
extern "C" int pnp_conv3x3_mma_sync(int dtype, const void* x, const void* wk, const void* bias,
                                    const void* gain, void* out, int b, int h, int w, int cin,
                                    int cout, void* stream) {
  return pnp::tc::conv3x3_entry(1, dtype, x, wk, bias, gain, out, b, h, w, cin, cout, stream);
}

// The wgmma design at 64 -> 64 with the other staging of its chunks (bf16
// by tensor-map boxes, float32 by cp.async), with pnp_conv3x3's arguments:
// chip_smoke.py times the two against each other; no model path calls it.
extern "C" int pnp_conv3x3_wg_alt_staging(int dtype, const void* x, const void* wk,
                                          const void* bias, const void* gain, void* out, int b,
                                          int h, int w, int cin, int cout, void* stream) {
  return pnp::tc::conv3x3_entry(2, dtype, x, wk, bias, gain, out, b, h, w, cin, cout, stream);
}

// dynamic shared memory of one block at width c (dtype 0 float32, 1
// bfloat16) in the design c -> c takes, for the build report
extern "C" int pnp_conv3x3_smem(int c, int dtype) {
  if (c == pnp::tc::wgc::C)
    return (int)(dtype == 1 ? pnp::tc::cv_wg_smem<__nv_bfloat16>()
                            : pnp::tc::cv_wg_smem<float>());
  return (int)pnp::tc::conv_tc_smem(dtype == 1 ? 1 : 2);
}
