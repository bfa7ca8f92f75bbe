// K4: the reconstruction head, y = conv3x3(lrelu_0.1(conv3x3(x; W_hr) + b_hr); W_last) + b_last,
// c -> c -> 3 channels. The caller adds lr.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: head_pf (:1058,
// kernel _head_kernel :977). Same two-stage structure as the DRT block (K3):
// stage 1 computes the c-channel hidden map on the output tile plus a
// 1-pixel halo into shared memory, zeroed outside the image (conv_last's
// zero padding), and stage 2 reduces it to 3 channels without it leaving
// the chip.
//
// Design. Stage 1 is K2's GEMM loop (tc_conv.cuh: conv_tc) over the 10 x 18
// halo region: an implicit GEMM on the tensor cores (mma.sync) whose 180
// rows are padded to 12 row tiles (3 a warp), whose columns are the output
// groups of 64 hidden channels (the block runs every group: stage 2 reads
// all of them) and whose depth is W_hr's nine taps over x's input chunks,
// through the cp.async rings; its epilogue adds b_hr, applies the leaky ReLU
// and writes the hidden map, float32, channel-major, zero outside the image.
// At c <= 64 (NARROW, the flagship's width) the hidden map overwrites the x
// chunk buffers once stage 1 is done, and two blocks run on an SM. Stage 2,
// c -> 3, is 1/21 of the work and runs on the CUDA cores: each output pixel's
// channels are split between two threads, one LDS.128 of W_last (padded to
// four floats) a channel, and their halves are joined through shared memory.
//
// Types. float32 features run 3xTF32 (W_hr split by the wrapper's
// tf32_split). In bfloat16, W_hr arrives as two bf16 terms, hi + lo (the
// wrapper's bf16_split), and each k-step takes both products: x is bf16
// already, so the products keep W_hr to ~16 bits. With one bf16 term the
// head's mean error against float32 is 0.85-0.99 of its parity bound (0.002
// std; the output's own bf16 rounding is ~0.57 of it) in an emulation of
// this arithmetic (tests/test_torch_port_tc_head.py), as the bf16 hidden
// map's was before it. The hidden map stays float32 in both types for the
// same reason; W_last, the biases and stage 2 are float32.
//
// Two-launch form. Above the one-launch width (HD_ONE_LAUNCH_*) the hidden map
// does not fit: the wrapper passes a float32 (b, h, w, c) scratch and the
// head runs as two launches, head_hidden_tc (conv_tc over the output tile,
// one output group a block, the same epilogue into the scratch) and
// head_last_kernel (stage 2 over the scratch, staged back in chunks of 64
// channels with W_last's rows for them).
//
// Bound (c = 64, 720p): 71.1 GFLOP a frame, 0.072 ms on the bf16 tensor
// cores, 0.431 ms in 3xTF32; its bytes 0.07-0.15 ms. Stage 1 runs 12 row
// tiles (192 rows) for the 128 output pixels, 1.5x; the bf16 route takes
// two products a multiply-add of stage 1.
#include "tc_conv.cuh"

namespace pnp {
namespace tc {

constexpr int HD_CO = 3;   // output channels
constexpr int HD_NW = 2;   // W_hr's tiles a step: TF32 head and tail, or bf16 hi and lo
using HR = Region<1>;      // stage 1: the 10 x 18 hidden region
constexpr int HD_PIX = TILE_H * TILE_W;  // output pixels of a block (stage 2: two threads each)
static_assert(NTHR == 2 * HD_PIX, "stage 2 splits each pixel's channels between two threads");

// dynamic shared memory of a one-launch block at width c (elt: the feature
// type's bytes): the x chunk buffers (two where c takes more than one
// chunk) and the float32 hidden map (NARROW: one over the other), the weight
// ring and W_last as (9, c) float4
__host__ __device__ constexpr size_t head_smem(int c, int elt) {
  const int kc = elt == 2 ? Operand<__nv_bfloat16>::KC : Operand<float>::KC;
  const size_t xbytes = (size_t)(cdiv(c, kc) > 1 ? 2 : 1) * HR::NA * PITCH;
  const size_t hbytes = sizeof(float) * c * HR::NR;
  return (c <= NB ? (xbytes > hbytes ? xbytes : hbytes) : xbytes + hbytes) +
         (size_t)2 * HD_NW * WTILE + sizeof(float4) * 9 * c;
}
static_assert(head_smem(NB, 4) <= SMEM_MAX / 2 && head_smem(NB, 2) <= SMEM_MAX / 2,
              "two narrow blocks fit an SM");
// the widest one-launch block that fits, per feature type (launch.ONE_LAUNCH_WIDTH)
constexpr int HD_ONE_LAUNCH_F32 = 144;
constexpr int HD_ONE_LAUNCH_BF16 = 144;
static_assert(head_smem(HD_ONE_LAUNCH_F32, 4) <= SMEM_MAX &&
                  head_smem(HD_ONE_LAUNCH_F32 + PN, 4) > SMEM_MAX,
              "HD_ONE_LAUNCH_F32 is the widest one-launch block that fits");
static_assert(head_smem(HD_ONE_LAUNCH_BF16, 2) <= SMEM_MAX &&
                  head_smem(HD_ONE_LAUNCH_BF16 + PN, 2) > SMEM_MAX,
              "HD_ONE_LAUNCH_BF16 is the widest one-launch block that fits");
// the two-launch form: launch 1 as K5 (two chunk buffers, the weight ring);
// launch 2 a hidden chunk, W_last's rows for it and the halves' sums
constexpr size_t HH_SMEM = conv_tc_smem(HD_NW);
constexpr size_t HL_SMEM = sizeof(float) * NB * HR::NR + sizeof(float4) * 9 * NB +
                           sizeof(float) * HD_CO * HD_PIX;

// W_last (9 c, 3) float32 into wl as (9 c) float4, the fourth lane zero
__device__ __forceinline__ void stage_wlast(float4* wl, const float* wlast, int rows) {
  for (int i = threadIdx.x; i < rows; i += NTHR)
    wl[i] = make_float4(wlast[3 * i], wlast[3 * i + 1], wlast[3 * i + 2], 0.f);
}

// Stage 2's part of this thread: output pixel p = t % 128 of the tile, the
// half j = t / 128 of the kc channels of a channel-major hidden chunk hs
// (HR::NR pixels a channel), wl its W_last rows (9, kc) as float4.
__device__ __forceinline__ void last_sums(float (&o)[HD_CO], const float* hs, const float4* wl,
                                          int kc) {
  const int p = threadIdx.x % HD_PIX, half = kc / 2, c0 = threadIdx.x / HD_PIX * half;
  const int base = (p / TILE_W) * HR::RW + p % TILE_W;
  for (int tap = 0; tap < 9; ++tap) {
    const float* row = hs + base + (tap / 3) * HR::RW + tap % 3;
    const float4* wt = wl + tap * kc;
#pragma unroll 4
    for (int ci = c0; ci < c0 + half; ++ci) {
      const float v = row[ci * HR::NR];
      const float4 q = wt[ci];
      o[0] = fmaf(v, q.x, o[0]);
      o[1] = fmaf(v, q.y, o[1]);
      o[2] = fmaf(v, q.z, o[2]);
    }
  }
}

// The two halves of each pixel's sums joined through red (3 x 128 floats),
// + b_last, stored as T by the first half's threads.
template <typename T>
__device__ __forceinline__ void last_store(const float (&o)[HD_CO], float* red,
                                           const float* blast, T* out, int h, int w, int y0,
                                           int x0, size_t img) {
  const int p = threadIdx.x % HD_PIX;
  if (threadIdx.x >= HD_PIX)
#pragma unroll
    for (int k = 0; k < HD_CO; ++k) red[k * HD_PIX + p] = o[k];
  __syncthreads();
  const int y = y0 + p / TILE_W, xx = x0 + p % TILE_W;
  if (threadIdx.x >= HD_PIX || y >= h || xx >= w) return;
  T* dst = out + (img + (size_t)y * w + xx) * HD_CO;
#pragma unroll
  for (int k = 0; k < HD_CO; ++k) dst[k] = from_f<T>(o[k] + red[k * HD_PIX + p] + blast[k]);
}

// Weights (the wrapper's layout): whr (2, 9, c, c) in x's type, each tap
// transposed (out, in), the two terms of each weight; bhr (c,), wlast (9,
// c, 3), blast (3,) float32.
template <typename T, bool NARROW>
__global__ void __launch_bounds__(NTHR, NARROW ? 2 : 1)
    head_tc(const T* __restrict__ x, const T* __restrict__ whr, const float* __restrict__ bhr,
            const float* __restrict__ wlast, const float* __restrict__ blast, T* __restrict__ out,
            int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  const size_t xbytes = (size_t)(cdiv(c, Operand<T>::KC) > 1 ? 2 : 1) * HR::NA * PITCH;
  const size_t hbytes = sizeof(float) * c * HR::NR;
  uint8_t* xb = smem;  // x chunk buffers
  float* hs = reinterpret_cast<float*>(NARROW ? smem : smem + xbytes);  // c x NR hidden map
  uint8_t* wb = smem + (NARROW ? (xbytes > hbytes ? xbytes : hbytes) : xbytes + hbytes);
  float4* wl = reinterpret_cast<float4*>(wb + 2 * HD_NW * WTILE);  // W_last (9, c)

  const int b = blockIdx.z, y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;
  stage_wlast(wl, wlast, 9 * c);  // published by the first step's __syncthreads
  const ConvIn<T> in[1] = {{x, whr, c, c}};
  // ---- stage 1: the hidden map on the tile and its halo, every group
  conv_tc<T, 1, HD_NW, !NARROW>(
      in, 1, false, 1, b, h, w, c, 0, cdiv(c, NB), xb, wb, [&](int co0, auto& acc) {
        if (NARROW) __syncthreads();  // every warp is done with the x tile h overwrites
        for_each_pair<HR::MT>(acc, [&](int p, int col, float& v0, float& v1) {
          const int n = co0 + col;
          if (p >= HR::NR || n >= c) return;
          const int y = y0 - 1 + p / HR::RW, xx = x0 - 1 + p % HR::RW;
          const bool inside = y >= 0 && y < h && xx >= 0 && xx < w;
          hs[n * HR::NR + p] = inside ? lrelu(v0 + bhr[n]) : 0.f;
          hs[(n + 1) * HR::NR + p] = inside ? lrelu(v1 + bhr[n + 1]) : 0.f;
        });
      });
  __syncthreads();
  // ---- stage 2: c -> 3 on the CUDA cores (the weight ring holds the halves' sums)
  float o[HD_CO] = {0.f, 0.f, 0.f};
  last_sums(o, hs, wl, c);
  last_store<T>(o, reinterpret_cast<float*>(wb), blast, out, h, w, y0, x0, img);
}

// Launch 1 of the two-launch form: hbuf = lrelu_0.1(conv3x3(x; W_hr) + b_hr)
// on the output tile, float32, one output group a block (grid z: samples x
// groups).
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    head_hidden_tc(const T* __restrict__ x, const T* __restrict__ whr,
                   const float* __restrict__ bhr, float* __restrict__ hbuf, int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ngr = cdiv(c, NB), b = blockIdx.z / ngr, g = blockIdx.z % ngr;
  const size_t img = (size_t)b * h * w;
  const ConvIn<T> in[1] = {{x, whr, c, c}};
  conv_tc<T, 0, HD_NW, true>(
      in, 1, false, 1, b, h, w, c, g, g + 1, smem, smem + 2 * Region<0>::NA * PITCH,
      [&](int co0, auto& acc) {
        for_each_out_pair(acc, co0, c, h, w, [&](size_t px, int n, float v0, float v1) {
          store2(hbuf + (img + px) * c + n, lrelu(v0 + bhr[n]), lrelu(v1 + bhr[n + 1]));
        });
      });
}

// Launch 2: out = conv3x3(hbuf; W_last) + b_last, stage 2 over the hidden
// map staged in chunks of 64 channels (zeros outside the image: conv_last's
// padding) with W_last's rows for the chunk.
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    head_last_kernel(const float* __restrict__ hbuf, const float* __restrict__ wlast,
                     const float* __restrict__ blast, T* __restrict__ out, int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* hs = reinterpret_cast<float*>(smem);              // NB x NR hidden chunk
  float4* wl = reinterpret_cast<float4*>(hs + NB * HR::NR);  // (9, NB) rows of W_last
  float* red = reinterpret_cast<float*>(wl + 9 * NB);       // the halves' sums
  const int b = blockIdx.z, y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;
  float o[HD_CO] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += NB) {
    const int kc = imin(NB, c - c0);
    __syncthreads();  // every thread is done with the previous chunk
    // 8 channels of a pixel a thread (two float4 loads), consecutive
    // threads on consecutive pixels: the channel-major stores do not conflict
    for (int i = threadIdx.x; i < HR::NR * (kc / PN); i += NTHR) {
      const int p = i % HR::NR, v = i / HR::NR;
      const int y = y0 - 1 + p / HR::RW, xx = x0 - 1 + p % HR::RW;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a;
      if (y >= 0 && y < h && xx >= 0 && xx < w) {
        const float4* src =
            reinterpret_cast<const float4*>(hbuf + (img + (size_t)y * w + xx) * c + c0 + v * PN);
        a = src[0];
        d = src[1];
      }
      const float vals[PN] = {a.x, a.y, a.z, a.w, d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < PN; ++k) hs[(v * PN + k) * HR::NR + p] = vals[k];
    }
    for (int i = threadIdx.x; i < 9 * kc; i += NTHR) {
      const float* src = wlast + ((size_t)(i / kc) * c + c0 + i % kc) * HD_CO;
      wl[i] = make_float4(src[0], src[1], src[2], 0.f);
    }
    __syncthreads();
    last_sums(o, hs, wl, kc);
  }
  last_store<T>(o, red, blast, out, h, w, y0, x0, img);
}

template <typename T>
cudaError_t launch_head(const void* x, const void* whr, const void* bhr, const void* wlast,
                        const void* blast, void* hbuf, void* out, int b, int h, int w, int c,
                        cudaStream_t stream) {
  constexpr int ELT = sizeof(T);
  // one launch up to the widest block that fits, two through hbuf above it
  const int one = ELT == 2 ? HD_ONE_LAUNCH_BF16 : HD_ONE_LAUNCH_F32;
  if (c < PN || c % PN || (c > one) != (hbuf != nullptr)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const dim3 tiles((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, 1);
  const auto* xt = static_cast<const T*>(x);
  const auto* whrt = static_cast<const T*>(whr);
  const auto* bhrf = static_cast<const float*>(bhr);
  const auto* wlf = static_cast<const float*>(wlast);
  const auto* blf = static_cast<const float*>(blast);
  auto* o = static_cast<T*>(out);
  cudaError_t e;
  if (hbuf == nullptr) {
    const size_t smem = head_smem(c, ELT);
    auto k = c <= NB ? head_tc<T, true> : head_tc<T, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
    k<<<dim3(tiles.x, tiles.y, b), NTHR, smem, stream>>>(xt, whrt, bhrf, wlf, blf, o, h, w, c);
    return cudaGetLastError();
  }
  auto* hb = static_cast<float*>(hbuf);
  if ((e = allow_smem(head_hidden_tc<T>, HH_SMEM)) != cudaSuccess) return e;
  head_hidden_tc<T><<<dim3(tiles.x, tiles.y, b * cdiv(c, NB)), NTHR, HH_SMEM, stream>>>(
      xt, whrt, bhrf, hb, h, w, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(head_last_kernel<T>, HL_SMEM)) != cudaSuccess) return e;
  head_last_kernel<T><<<dim3(tiles.x, tiles.y, b), NTHR, HL_SMEM, stream>>>(hb, wlf, blf, o, h,
                                                                           w, c);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, c), c a multiple of 8;
// whr: (2, 9, c, c) in x's type, each tap transposed (out, in): tf32_split's
// head and tail (float32) or bf16_split's hi and lo (bfloat16); bhr: (c,);
// wlast: (9, c, 3); blast: (3,) float32; hbuf: null for the one-launch form,
// above the one-launch width a float32 (b, h, w, c) scratch (two launches);
// out: (b, h, w, 3).
extern "C" int pnp_head(int dtype, const void* x, const void* whr, const void* bhr,
                        const void* wlast, const void* blast, void* hbuf, void* out, int b,
                        int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::tc::launch_head<float>(x, whr, bhr, wlast, blast, hbuf, out, b, h, w, c, s);
  if (dtype == 1)
    return (int)pnp::tc::launch_head<__nv_bfloat16>(x, whr, bhr, wlast, blast, hbuf, out, b, h,
                                                    w, c, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of a one-launch block at width c (dtype 0 float32,
// 1 bfloat16), for the build report and chip_smoke.py's check of
// launch.ONE_LAUNCH_WIDTH
extern "C" int pnp_head_smem(int c, int dtype) {
  return (int)pnp::tc::head_smem(c, dtype == 1 ? 2 : 4);
}
