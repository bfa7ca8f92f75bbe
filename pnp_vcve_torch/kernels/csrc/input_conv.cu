// K2: the BAE input conv, out = lrelu_0.1(sum_p conv3x3_same(part_p; K_p[b]) + bias),
// written as a dense NHWC (b, h, w, c) tensor.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: input_conv_pf
// (:649). Like it, the concat of the parts is never built: each part is
// staged and convolved with its own per-sample kernel slice. The parts are,
// in concat order, the 3-channel lr frame and one to three c-channel
// features (key warp, neighbour, and in the forward sweep the backward
// feature). The align_key select arrives folded into the kernel slices by
// the wrapper (K_kw + g K_nb and (1 - g) K_nb), so no select runs here.
//
// Bound: CUDA-core float32 FMAs, ~139 (backward) / ~207 (forward) GFLOP per
// 720p frame at c = 64. A block computes an 8 x 16 pixel tile by one group of
// up to 64 output channels (grid z: samples x groups) from a 10 x 18 input
// tile in shared memory, each wide part staged in chunks of up to 64
// channels, streaming the weights one tap (64 x 64 floats) at a time; the
// narrow lr part has its own load path and keeps all nine of its taps in
// shared memory. Shared memory does not grow with c.
#include "common.cuh"

namespace pnp {

constexpr int IC_IR = TH + 2, IC_IC = TW + 2, IC_NI = IC_IR * IC_IC;  // input tile 10 x 18
constexpr int IC_PM = TH * TW / PG;                                   // 4 pixels per thread
constexpr int IC_NLR = 3;                                             // lr channels
constexpr size_t IC_SMEM = sizeof(float) * (C * IC_NI + C * C + 9 * IC_NLR * C);

// CF: the width, 64 (the flagship's, every bound known at compile time) or
// 0 (any multiple of 8, read at run time)
template <typename T, int CF>
__global__ void __launch_bounds__(NT, 2)
    input_conv_kernel(const T* __restrict__ lr, const T* __restrict__ p0,
                      const T* __restrict__ p1, const T* __restrict__ p2,
                      const float* __restrict__ wlr, const float* __restrict__ w0,
                      const float* __restrict__ w1, const float* __restrict__ w2,
                      const float* __restrict__ bias, T* __restrict__ out, int h, int w,
                      int nwide, int c_rt) {
  extern __shared__ float smem[];
  float* xs = smem;             // C x IC_NI staged chunk
  float* ws = xs + C * IC_NI;   // one tap of a wide part's weights
  float* wl = ws + C * C;       // all nine taps of the lr weights

  const int c = CF ? CF : c_rt;
  const int ngroups = (c + C - 1) / C;
  const int b = blockIdx.z / ngroups, co0 = (blockIdx.z % ngroups) * C;
  const int cw = min(C, c - co0);
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG;
  const size_t img = (size_t)b * h * w;

  int base[IC_PM];
  tile_bases<IC_PM>(base, TH * TW, TW, IC_IC);
  float acc[IC_PM][PN];
  zero(acc);

  // narrow lr part
  load_tile<T>(xs, IC_NI, lr + img * IC_NLR, IC_NLR, 0, IC_NLR, h, w, y0 - 1, x0 - 1, IC_IR,
               IC_IC);
  for (int tap = 0; tap < 9; ++tap)
    stage_tap(wl + tap * IC_NLR * C, wlr + (size_t)b * 9 * IC_NLR * c, tap, IC_NLR, c, 0, IC_NLR,
              co0, cw);
  __syncthreads();
  for (int tap = 0; tap < 9; ++tap)
    conv_tap<IC_PM>(acc, xs, IC_NI, base, (tap / 3) * IC_IC + tap % 3, wl + tap * IC_NLR * C,
                    IC_NLR, tn);

  // wide parts, in chunks of up to 64 channels
  const T* parts[3] = {p0, p1, p2};
  const float* wts[3] = {w0, w1, w2};
  for (int k = 0; k < nwide; ++k) {
    for (int c0 = 0; c0 < c; c0 += C) {
      const int kc = min(C, c - c0);
      __syncthreads();  // every thread is done reading the previous chunk
      load_tile<T>(xs, IC_NI, parts[k] + img * c, c, c0, kc, h, w, y0 - 1, x0 - 1, IC_IR, IC_IC);
      conv3x3<IC_PM>(acc, xs, IC_NI, IC_IC, base, wts[k] + (size_t)b * 9 * c * c, ws, c, c, c0,
                     kc, co0, cw, tn);
    }
  }

  if (tn * PN >= cw) return;  // past the last group's width
  float bv[PN];
#pragma unroll
  for (int n = 0; n < PN; ++n) bv[n] = bias[co0 + tn * PN + n];
  const int pg = threadIdx.x / CG;
#pragma unroll
  for (int j = 0; j < IC_PM; ++j) {
    const int p = pg + PG * j;
    const int y = y0 + p / TW, x = x0 + p % TW;
    if (y >= h || x >= w) continue;
    float o[PN];
#pragma unroll
    for (int n = 0; n < PN; ++n) {
      const float v = acc[j][n] + bv[n];
      o[n] = v >= 0.f ? v : 0.1f * v;
    }
    store8(out + (img + (size_t)y * w + x) * c + co0 + tn * PN, o);
  }
}

template <typename T>
cudaError_t launch_input_conv(const void* lr, const void* p0, const void* p1, const void* p2,
                              const void* wlr, const void* w0, const void* w1, const void* w2,
                              const void* bias, void* out, int b, int h, int w, int nwide, int c,
                              cudaStream_t stream) {
  if (c < PN || c % PN) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = c == C ? input_conv_kernel<T, C> : input_conv_kernel<T, 0>;
  cudaError_t e = allow_smem(k, IC_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b * ((c + C - 1) / C));
  k<<<grid, NT, IC_SMEM, stream>>>(
      static_cast<const T*>(lr), static_cast<const T*>(p0), static_cast<const T*>(p1),
      static_cast<const T*>(p2), static_cast<const float*>(wlr), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(bias), static_cast<T*>(out), h, w, nwide, c);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. lr: (b, h, w, 3); p0..p2: (b, h, w, c), the
// first nwide (1..3) used, c a multiple of 8; wlr: (b, 9, 3, c) and
// w0..w2: (b, 9, c, c) float32 per-sample kernels; bias: (c,) float32;
// out: (b, h, w, c).
extern "C" int pnp_input_conv(int dtype, const void* lr, const void* p0, const void* p1,
                              const void* p2, const void* wlr, const void* w0, const void* w1,
                              const void* w2, const void* bias, void* out, int b, int h, int w,
                              int nwide, int c, void* stream) {
  if (nwide < 1 || nwide > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::launch_input_conv<float>(lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b, h,
                                              w, nwide, c, s);
  if (dtype == 1)
    return (int)pnp::launch_input_conv<__nv_bfloat16>(lr, p0, p1, p2, wlr, w0, w1, w2, bias,
                                                      out, b, h, w, nwide, c, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block (the same at every width), for the
// build report and the wrappers' width check
extern "C" int pnp_input_conv_smem(int) { return (int)pnp::IC_SMEM; }
