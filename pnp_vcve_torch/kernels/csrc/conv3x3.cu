// K5: a 'same' 3x3 convolution with per-sample kernels and biases,
//   out[b] = conv3x3(x[b]; W[b]) + bias[b]
// x (b, h, w, c_in) NHWC in float or __nv_bfloat16; W (b, 9, c_in, c_out) and
// bias (b, c_out) float32; out (b, h, w, c_out) in x's type. Sums in float32,
// one rounding to x's type, no activation.
//
// Replaces three TPU kernels that compute this one function in three
// layouts: pnp_vcve_tpu/kernels/conv_block.py: conv3x3_pallas (:86), and
// conv_packed.py: conv3x3_packed (:48) and conv3x3_packed_v2 (:118), the
// last two on the pixel-pair layout. As there, the input is read from device
// memory once per output tile and the per-sample kernel stays on the chip.
// The callers fold a per-sample gain into W and b (kernels/conv_block.py).
//
// Layout: a block computes an 8 x 16 pixel tile by one group of up to 64
// output channels with common.cuh's thread layout (4 pixels x 8 channels per
// thread); grid z runs over samples x output groups. The last group may be
// narrower (c_out % 64, a multiple of 8): its weights are staged zero-padded
// to 64 columns and the threads past its width store nothing, so the thread
// layout, and the 4 pixels each thread owns, stay those of K2-K4 at every
// width. The input channels run in chunks of up to 64: a chunk's 10 x 18
// tile is staged in shared memory (16-byte loads where c_in % 8 == 0, one
// value at a time otherwise, as for the 3-channel frame), then its nine taps'
// weights stream through 16 KB one tap at a time.
//
// Bound: CUDA-core float32 FMAs. At the model's 64 -> 64 a 720p frame needs
// 67.9 GFLOP (1.014 ms at 67 TFLOP/s) against 0.47 GB of features (0.14 ms
// at 3.35 TB/s). 61 KB of shared memory per block: two blocks fit on an SM.
#include "common.cuh"

namespace pnp {

constexpr int CV_IR = TH + 2, CV_IC = TW + 2, CV_NI = CV_IR * CV_IC;  // input tile 10 x 18
constexpr int CV_PM = TH * TW / PG;                                   // 4 pixels per thread
constexpr size_t CV_SMEM = sizeof(float) * (C * CV_NI + C * C);

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ wk,
                   const float* __restrict__ bias, T* __restrict__ out, int h, int w, int cin,
                   int cout, int ngroups) {
  extern __shared__ float smem[];
  float* xs = smem;            // C x CV_NI staged input chunk
  float* ws = xs + C * CV_NI;  // one tap of one chunk's weights, 64 columns

  const int b = blockIdx.z / ngroups, co0 = (blockIdx.z % ngroups) * C;
  const int cw = min(C, cout - co0);
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG, pg = threadIdx.x / CG;
  const size_t img = (size_t)b * h * w;
  const float* wb = wk + (size_t)b * 9 * cin * cout;

  int base[CV_PM];
  tile_bases<CV_PM>(base, TH * TW, TW, CV_IC);
  float acc[CV_PM][PN];
  zero(acc);
  for (int c0 = 0; c0 < cin; c0 += C) {
    const int kc = min(C, cin - c0);
    __syncthreads();  // every thread is done with the previous chunk
    load_tile<T>(xs, CV_NI, x + img * cin, cin, c0, kc, h, w, y0 - 1, x0 - 1, CV_IR, CV_IC);
    conv3x3<CV_PM>(acc, xs, CV_NI, CV_IC, base, wb, ws, cin, cout, c0, kc, co0, cw, tn);
  }

  if (tn * PN >= cw) return;  // past the last group's width
  float bv[PN];
#pragma unroll
  for (int n = 0; n < PN; ++n) bv[n] = bias[(size_t)b * cout + co0 + tn * PN + n];
#pragma unroll
  for (int j = 0; j < CV_PM; ++j) {
    const int p = pg + PG * j;
    const int y = y0 + p / TW, xx = x0 + p % TW;
    if (y >= h || xx >= w) continue;
    float o[PN];
#pragma unroll
    for (int n = 0; n < PN; ++n) o[n] = acc[j][n] + bv[n];
    store8(out + (img + (size_t)y * w + xx) * cout + co0 + tn * PN, o);
  }
}

template <typename T>
cudaError_t launch_conv3x3(const void* x, const void* wk, const void* bias, void* out, int b,
                           int h, int w, int cin, int cout, cudaStream_t stream) {
  if (cin < 1 || cout < PN || cout % PN) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const int ngroups = (cout + C - 1) / C;
  auto k = conv3x3_kernel<T>;
  cudaError_t e = allow_smem(k, CV_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b * ngroups);
  k<<<grid, NT, CV_SMEM, stream>>>(static_cast<const T*>(x), static_cast<const float*>(wk),
                                   static_cast<const float*>(bias), static_cast<T*>(out), h, w,
                                   cin, cout, ngroups);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, cin); wk: (b, 9, cin, cout) and
// bias: (b, cout) float32, any gain folded in; out: (b, h, w, cout);
// cout a multiple of 8.
extern "C" int pnp_conv3x3(int dtype, const void* x, const void* wk, const void* bias, void* out,
                           int b, int h, int w, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::launch_conv3x3<float>(x, wk, bias, out, b, h, w, cin, cout, s);
  if (dtype == 1)
    return (int)pnp::launch_conv3x3<__nv_bfloat16>(x, wk, bias, out, b, h, w, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block (the same at every width), for the
// build report and the wrappers' width check
extern "C" int pnp_conv3x3_smem(int) { return (int)pnp::CV_SMEM; }
