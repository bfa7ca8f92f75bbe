// K4: the reconstruction head, y = conv3x3(lrelu_0.1(conv3x3(x; W_hr) + b_hr); W_last) + b_last,
// 64 -> 64 -> 3 channels. The caller adds lr.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: head_pf (:1058,
// kernel _head_kernel :977). Same two-stage structure as the DRT block (K3):
// stage 1 computes the 64-channel hidden map on the output tile plus a
// 1-pixel halo into shared memory, zeroed outside the image (conv_last's
// zero padding), and stage 2 reduces it to 3 channels without it leaving
// the chip.
//
// Bound: CUDA-core float32 FMAs, ~71 GFLOP per 720p frame, nearly all in
// stage 1 (recomputed on the 10 x 18 halo region of each 8 x 16 tile).
// Stage 2 is 1/21 of the work: one thread per output pixel, all nine taps
// of W_last (6.9 KB) held in shared memory.
#include "common.cuh"

namespace pnp {

constexpr int HD_HR = TH + 2, HD_HC = TW + 2, HD_NH = HD_HR * HD_HC;  // hidden region 10 x 18
constexpr int HD_XR = TH + 4, HD_XC = TW + 4, HD_NX = HD_XR * HD_XC;  // x tile 12 x 20
constexpr int HD_PM = (HD_NH + PG - 1) / PG;                          // 6 pixels per thread
constexpr int HD_CO = 3;                                              // output channels
constexpr size_t HD_SMEM = sizeof(float) * (C * HD_NX + C * C + 9 * C * HD_CO);

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    head_kernel(const T* __restrict__ x, const float* __restrict__ whr,
                const float* __restrict__ bhr, const float* __restrict__ wlast,
                const float* __restrict__ blast, T* __restrict__ out, int h, int w) {
  extern __shared__ float smem[];
  float* xs = smem;            // C x HD_NX input tile; C x HD_NH hidden map after stage 1
  float* ws = xs + C * HD_NX;  // one tap of W_hr
  float* wl = ws + C * C;      // W_last (9, C, 3)

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG, pg = threadIdx.x / CG;
  const size_t img = (size_t)b * h * w;

  load_tile<T>(xs, HD_NX, x + img * C, h, w, y0 - 2, x0 - 2, HD_XR, HD_XC);
  copy_weights(wl, wlast, 9 * C * HD_CO);
  int base1[HD_PM];
  tile_bases<HD_PM>(base1, HD_NH, HD_HC, HD_XC);
  float acc[HD_PM][PN];
  zero(acc);
  conv3x3<HD_PM>(acc, xs, HD_NX, HD_XC, base1, whr, ws, C, tn);

  float bv[PN];
#pragma unroll
  for (int n = 0; n < PN; ++n) bv[n] = bhr[tn * PN + n];
  __syncthreads();  // every thread is done reading x before the hidden map overwrites it
#pragma unroll
  for (int j = 0; j < HD_PM; ++j) {
    const int p = pg + PG * j;
    if (p >= HD_NH) continue;
    const int y = y0 - 1 + p / HD_HC, xx = x0 - 1 + p % HD_HC;
    const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
#pragma unroll
    for (int n = 0; n < PN; ++n) {
      const float v = acc[j][n] + bv[n];
      xs[(tn * PN + n) * HD_NH + p] = in ? round_to<T>(v >= 0.f ? v : 0.1f * v) : 0.f;
    }
  }
  __syncthreads();

  // ---- stage 2: one thread per output pixel
  const int p = threadIdx.x;
  if (p >= TH * TW) return;
  const int y = y0 + p / TW, xx = x0 + p % TW;
  if (y >= h || xx >= w) return;
  const int base = (p / TW) * HD_HC + p % TW;
  float o[HD_CO] = {blast[0], blast[1], blast[2]};
  for (int tap = 0; tap < 9; ++tap) {
    const float* row = xs + base + (tap / 3) * HD_HC + tap % 3;
    const float* wt = wl + tap * C * HD_CO;
#pragma unroll 8
    for (int ci = 0; ci < C; ++ci) {
      const float v = row[ci * HD_NH];
#pragma unroll
      for (int k = 0; k < HD_CO; ++k) o[k] = fmaf(v, wt[ci * HD_CO + k], o[k]);
    }
  }
  T* dst = out + (img + (size_t)y * w + xx) * HD_CO;
#pragma unroll
  for (int k = 0; k < HD_CO; ++k) dst[k] = from_f<T>(o[k]);
}

template <typename T>
cudaError_t launch_head(const void* x, const void* whr, const void* bhr, const void* wlast,
                        const void* blast, void* out, int b, int h, int w, cudaStream_t stream) {
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = head_kernel<T>;
  cudaError_t e = allow_smem(k, HD_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  k<<<grid, NT, HD_SMEM, stream>>>(static_cast<const T*>(x), static_cast<const float*>(whr),
                                   static_cast<const float*>(bhr),
                                   static_cast<const float*>(wlast),
                                   static_cast<const float*>(blast), static_cast<T*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, 64); whr: (9, 64, 64);
// bhr: (64,); wlast: (9, 64, 3); blast: (3,), weights float32; out: (b, h, w, 3).
extern "C" int pnp_head(int dtype, const void* x, const void* whr, const void* bhr,
                        const void* wlast, const void* blast, void* out, int b, int h, int w,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pnp::launch_head<float>(x, whr, bhr, wlast, blast, out, b, h, w, s);
  if (dtype == 1)
    return (int)pnp::launch_head<__nv_bfloat16>(x, whr, bhr, wlast, blast, out, b, h, w, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block, for the build report
extern "C" int pnp_head_smem() { return (int)pnp::HD_SMEM; }
