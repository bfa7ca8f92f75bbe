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
// Design (tc_conv.cuh): K2's GEMM loop (conv_tc) with one input and an
// epilogue of bias and gain: an implicit GEMM on the tensor cores (mma.sync;
// bf16, or 3xTF32 for float32 features, each step summed apart: the sums
// reach 9 x 195 terms at the model's widest input conv) over an 8 x 16
// output tile by a group of 64 output channels; grid z runs over samples x
// groups. Any c_in: an input whose pixels are not 16-byte aligned (c_in % 8
// != 0) is staged with scalar loads, its weight rows zero-padded to whole
// 16-byte vectors; a last group narrower than 64 (c_out % 64) stages its
// weights zero-padded and stores nothing past its width.
//
// Bound (64 -> 64, 720p): 67.9 GFLOP a frame, 0.069 ms on the bf16 tensor
// cores at 989 TFLOP/s, 0.412 ms in 3xTF32 (three TF32 products at 495
// TFLOP/s); the features' bytes 0.14 ms (float32) / 0.07 ms (bf16).
#include "tc_conv.cuh"

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

template <typename T>
cudaError_t launch_conv3x3(const void* x, const void* wk, const void* bias, const void* gain,
                           void* out, int b, int h, int w, int cin, int cout,
                           cudaStream_t stream) {
  if (cin < 1 || cout < PN || cout % PN) return cudaErrorInvalidValue;
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

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, cin), any cin >= 1; wk: (NW,
// b, 9, cout, wc) per-sample taps in x's type, each transposed (out, in),
// wc = cin rounded up to a multiple of 8 (zeros past cin), NW = 2 for
// float32 (tf32_split's head and tail), 1 for bfloat16; bias, gain: (b,
// cout) float32; out: (b, h, w, cout) = gain * (conv + bias); cout a
// multiple of 8.
extern "C" int pnp_conv3x3(int dtype, const void* x, const void* wk, const void* bias,
                           const void* gain, void* out, int b, int h, int w, int cin, int cout,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::tc::launch_conv3x3<float>(x, wk, bias, gain, out, b, h, w, cin, cout, s);
  if (dtype == 1)
    return (int)pnp::tc::launch_conv3x3<__nv_bfloat16>(x, wk, bias, gain, out, b, h, w, cin,
                                                       cout, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block (the same at every width; dtype 0
// float32, 1 bfloat16), for the build report
extern "C" int pnp_conv3x3_smem(int, int dtype) {
  return (int)pnp::tc::conv_tc_smem(dtype == 1 ? 1 : 2);
}
