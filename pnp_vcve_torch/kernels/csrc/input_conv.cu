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
// Design (tc_conv.cuh): one implicit GEMM on the tensor cores (mma.sync;
// bf16, or 3xTF32 for float32 features), conv_tc's loop, whose rows are the
// 128 pixels of an 8 x 16 output tile and whose columns are a group of 64
// output channels (grid z: samples x groups). Its depth is every part's
// nine taps over the part's input chunks, in order: the lr frame first,
// staged with scalar loads zero-padded to one mma k-step (16 bf16 or 8
// float channels; its weights arrive padded the same way), then each wide
// part's chunks. Chunks flow through two buffers and the weight taps
// through a two-stage ring, each loaded with cp.async while the previous
// step computes. The epilogue adds the bias and applies the leaky ReLU in
// float32. In 3xTF32 each step sums apart before it joins the running sum
// (conv_step's SPLIT): K2's sums are long and its output large.
//
// Bound (c = 64, 720p): 139 (backward, 3 parts) / 207 (forward, 4 parts)
// GFLOP a frame: 0.14 / 0.21 ms on bf16 tensor cores at 989 TFLOP/s, 0.84 /
// 1.26 ms in 3xTF32 (three TF32 products at 495 TFLOP/s); the parts' bytes
// 0.09-0.2 ms. mma.sync is the first step; wgmma and TMA staging are next.
#include "tc_conv.cuh"

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

template <typename T>
cudaError_t launch_input_conv(const void* lr, const void* p0, const void* p1, const void* p2,
                              const void* wlr, const void* w0, const void* w1, const void* w2,
                              const void* bias, void* out, int b, int h, int w, int nwide, int c,
                              cudaStream_t stream) {
  if (c < PN || c % PN) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = input_conv_tc<T>;
  const size_t smem = conv_tc_smem(Operand<T>::NW);
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, b * cdiv(c, NB));
  k<<<grid, NTHR, smem, stream>>>(
      static_cast<const T*>(lr), static_cast<const T*>(p0), static_cast<const T*>(p1),
      static_cast<const T*>(p2), static_cast<const T*>(wlr), static_cast<const T*>(w0),
      static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<const float*>(bias),
      static_cast<T*>(out), b, h, w, nwide, c);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. lr: (b, h, w, 3); p0..p2: (b, h, w, c), the
// first nwide (1..3) used, c a multiple of 8; wlr: (NW, b, 9, c, KP) and
// w0..w2: (NW, b, 9, c, c) per-sample kernels in the features' type, each
// tap transposed (out, in), the lr part zero-padded to KP = 16 (bfloat16) or
// 8 (float32) input channels, NW = 2 for float32 (tf32_split's head and
// tail), 1 for bfloat16; bias: (c,) float32; out: (b, h, w, c).
extern "C" int pnp_input_conv(int dtype, const void* lr, const void* p0, const void* p1,
                              const void* p2, const void* wlr, const void* w0, const void* w1,
                              const void* w2, const void* bias, void* out, int b, int h, int w,
                              int nwide, int c, void* stream) {
  if (nwide < 1 || nwide > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::tc::launch_input_conv<float>(lr, p0, p1, p2, wlr, w0, w1, w2, bias, out, b,
                                                  h, w, nwide, c, s);
  if (dtype == 1)
    return (int)pnp::tc::launch_input_conv<__nv_bfloat16>(lr, p0, p1, p2, wlr, w0, w1, w2, bias,
                                                          out, b, h, w, nwide, c, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block (the same at every width; dtype 0
// float32, 1 bfloat16), for the build report
extern "C" int pnp_input_conv_smem(int, int dtype) {
  return (int)pnp::tc::conv_tc_smem(dtype == 1 ? 1 : 2);
}
