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
// bf16, or 3xTF32 for float32 features) whose rows are the 128 pixels of an
// 8 x 16 output tile and whose columns are a group of 64 output channels
// (grid z: samples x groups). Its depth is every part's nine taps over the
// part's input chunks, in order: the lr frame first, staged zero-padded to
// one mma k-step (16 bf16 or 8 float channels; its weights arrive padded
// the same way), then each wide part's chunks. Chunks flow through two
// buffers and the weight taps through a two-stage ring, each loaded with
// cp.async while the previous step computes. The epilogue adds the bias and
// applies the leaky ReLU in float32. In 3xTF32 each step sums apart before
// it joins the running sum (conv_step's SPLIT): K2's sums are long and its
// output large.
//
// Bound (c = 64, 720p): 139 (backward, 3 parts) / 207 (forward, 4 parts)
// GFLOP a frame: 0.14 / 0.21 ms on bf16 tensor cores at 989 TFLOP/s, 0.84 /
// 1.26 ms in 3xTF32 (three TF32 products at 495 TFLOP/s); the parts' bytes
// 0.09-0.2 ms. mma.sync is the first step; wgmma and TMA staging are next.
#include "tc_conv.cuh"

namespace pnp {
namespace tc {

constexpr int IC_RH = TILE_H + 2, IC_RW = TILE_W + 2, IC_NA = IC_RH * IC_RW;  // input tile 10 x 18
constexpr int IC_NLR = 3;                                                      // lr channels

// dynamic shared memory of one block: two chunk buffers and the weight ring
__host__ __device__ constexpr size_t ic_smem(int elt) {
  return (size_t)2 * IC_NA * PITCH + (size_t)2 * (elt == 2 ? 1 : 2) * WTILE;
}

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
  constexpr int KP = Op::KSTEP_CH;
  extern __shared__ __align__(16) uint8_t smem[];
  const int nch = cdiv(c, Op::KC), ngr = cdiv(c, NB);
  const int b = blockIdx.z / ngr, co0 = (blockIdx.z % ngr) * NB, cw = imin(NB, c - co0);
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;
  uint8_t* xb = smem;                      // two chunk buffers
  uint8_t* wb = xb + 2 * IC_NA * PITCH;    // weight ring: 2 slots of NW tiles

  const T* parts[3] = {p0, p1, p2};
  const T* wts[3] = {w0, w1, w2};
  const size_t lr_lo = (size_t)bsz * 9 * c * KP, wide_lo = (size_t)bsz * 9 * c * c;
  const int S = 9 + nwide * nch * 9;  // the lr part's taps, then each wide chunk's

  // the lr frame, zero-padded to KP channels, into buffer 0: plain stores
  // (3 channels a pixel are not 16-byte vectors); published by the first
  // step's __syncthreads
  for (int i = threadIdx.x; i < IC_NA * NVEC; i += NTHR) {
    const int p = i / NVEC, v = i % NVEC;
    const int y = y0 - 1 + p / IC_RW, x = x0 - 1 + p % IC_RW;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (v == 0 && y >= 0 && y < h && x >= 0 && x < w) {
      T* vals = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < IC_NLR; ++k) vals[k] = lr[(img + (size_t)y * w + x) * IC_NLR + k];
    }
    *reinterpret_cast<uint4*>(xb + p * PITCH + v * 16) = u;
  }

  ChunkRing ring;
  ring.cur = 1;
  ring.tag[0] = 0;  // chunk id 0, the lr frame, sits in buffer 0
  int xnext = 0;
  // step s >= 9: wide part k, chunk ch (chunk id 1 + k * nch + ch), tap
  auto issue = [&](int s) {
    uint8_t* wd = wb + (s & 1) * Op::NW * WTILE;
    if (s < 9) {
      stage_w_step<T>(wd, wlr + ((size_t)b * 9 + s) * c * KP, lr_lo, KP, 0, KP, co0, cw);
      xnext = 0;
    } else {
      const int k = (s - 9) / (9 * nch), ch = (s - 9) / 9 % nch, tap = (s - 9) % 9;
      const int c0 = ch * Op::KC, kc = imin(Op::KC, c - c0);
      stage_w_step<T>(wd, wts[k] + ((size_t)b * 9 + tap) * c * c, wide_lo, c, c0, kc, co0, cw);
      xnext = ring.next(1 + k * nch + ch, [&](int o) {
        stage_chunk<T>(xb + o * IC_NA * PITCH, parts[k] + img * c, c, c0, kc, h, w, y0 - 1,
                       x0 - 1, IC_RH, IC_RW);
      });
    }
    cp_async_commit();
  };

  float acc[MT_OUT][4][4];
  int arow[MT_OUT];
  const float nogate[MT_OUT][2] = {};
  row_offsets<MT_OUT>(arow, TILE_H * TILE_W, TILE_W, IC_RW, PITCH);
  zero_acc(acc);
  issue(0);
  for (int s = 0; s < S; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s's data is in; every warp is done with step s - 1
    ring.cur = xnext;
    if (s + 1 < S) issue(s + 1);
    const int tap = s < 9 ? s : (s - 9) % 9;
    const int nks = s < 9 ? 1 : cdiv(imin(Op::KC, c - ((s - 9) / 9 % nch) * Op::KC), Op::KSTEP_CH);
    conv_step<T, MT_OUT, false, true>(acc, xb + ring.cur * IC_NA * PITCH, arow,
                                ((tap / 3) * IC_RW + tap % 3) * PITCH,
                                wb + (s & 1) * Op::NW * WTILE, nks, nogate);
  }

  for_each_pair<MT_OUT>(acc, [&](int p, int col, float& v0, float& v1) {
    const int n = co0 + col;
    const int y = y0 + p / TILE_W, x = x0 + p % TILE_W;
    if (n >= c || y >= h || x >= w) return;
    const float a = v0 + bias[n], d = v1 + bias[n + 1];
    store2(out + (img + (size_t)y * w + x) * c + n, a >= 0.f ? a : 0.1f * a,
           d >= 0.f ? d : 0.1f * d);
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
  const size_t smem = ic_smem(sizeof(T));
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
  return (int)pnp::tc::ic_smem(dtype == 1 ? 2 : 4);
}
