// K10: a valid 3x3 "tap" convolution on the tensor cores,
//   out[r, c, :] = sum over dy, dx < 3 of band[dy + r, dx + c, :] @ w[dy, dx]
// for r < rows, c < cols: band (bh, bw, cin) with bh >= rows + 2 and
// bw >= cols + 2, w (3, 3, cin, cout). bf16 inputs with float32 sums and
// output, or int8 inputs with int32 sums and a float32 output
// float(sum) * s, s a scale in device memory (K9's).
//
// Replaces the TPU probe kernels of tools/int8_probe.py: k4 (:127, int8,
// after the in-kernel quantize that K9 takes over) and k5 (:148, bf16). The
// TPU ran the whole band as one block and each tap as one (rows * cols, C)
// x (C, C) matmul on strided slices of it. Here the taps are 9 shifted mma
// products over a patch staged once in shared memory (implicit GEMM: a
// pixel's 16-byte channel runs are the rows of the A fragments, so a shift
// by a tap is an address offset, not a copy).
//
// Layout: a block of 8 warps computes a 16 x 16 pixel tile by 64 output
// channels; warp w takes output rows 4 (w % 4) .. + 4 (one 16-pixel mma row
// tile each) and channels 32 (w / 4) .. + 32 (four 8-column tiles). The
// 18 x 18 x cin patch is staged once, zeros past the band; each tap's
// (cin, 64) weights are staged transposed (the "col" operand) in turn. Rows
// are padded by 16 bytes so that ldmatrix's row reads do not conflict.
// cin % 16 == 0 (bf16) or % 32 (int8) and cout % 8 == 0; pixels past rows or
// cols and channels past cout are computed on zeros and not stored.
//
// Bound: at the probe's 16 x 320 x 128 -> 128 it is 1.5 GFLOP (1.5 us in
// bf16 at 989 TFLOP/s, 0.76 us in int8) against 2.2 MB (0.66 us): near a
// launch. At K5's geometry (720 x 1280, 64 -> 64) 68 GFLOP, 69 us in bf16,
// against 0.36 GB of bf16 features in and float32 out (107 us): bytes.
// The design is the simple one (synchronous staging, weights re-staged by
// every block, mma.sync): on an H100 (700 W) it runs at ~3.7x the byte
// bound there, 7x faster than K5 and 2.4x slower than cuDNN's bf16 conv;
// overlapping the staging with the mma (wgmma, TMA) is for the PRs that
// make it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace pnp {

constexpr int TC_THREADS = 256;
constexpr int TC_TR = 16, TC_TC = 16;                                 // output tile
constexpr int TC_PR = TC_TR + 2, TC_PC = TC_TC + 2, TC_NP = TC_PR * TC_PC;  // patch 18 x 18
constexpr int TC_BN = 64;                                             // output channels a block
constexpr int TC_SMEM_MAX = 232448;                                   // an H100 block's most

__host__ __device__ constexpr int tc_ld(int cin, int elt) { return cin * elt + 16; }
__host__ __device__ constexpr size_t tc_smem(int cin, int elt) {
  return (size_t)(TC_NP + TC_BN) * tc_ld(cin, elt);
}

template <typename T>
__global__ void __launch_bounds__(TC_THREADS)
    tapconv_kernel(const T* __restrict__ band, const T* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out, int bh, int bw,
                   int cin, int cout, int rows, int cols) {
  using AccT = typename Acc<T>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ld = tc_ld(cin, sizeof(T)), pix = cin * (int)sizeof(T);
  uint8_t* ps = smem;              // patch [TC_NP][ld]
  uint8_t* ws = smem + TC_NP * ld;  // one tap's weights [TC_BN][ld]
  const int x0 = blockIdx.x * TC_TC, y0 = blockIdx.y * TC_TR, co0 = blockIdx.z * TC_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;

  for (int i = threadIdx.x; i < TC_NP * (pix / 16); i += TC_THREADS) {
    const int p = i / (pix / 16), v = (i % (pix / 16)) * 16;
    const int y = y0 + p / TC_PC, x = x0 + p % TC_PC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (y < bh && x < bw)
      val = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(band) +
                                                 ((size_t)y * bw + x) * pix + v));
    *reinterpret_cast<uint4*>(ps + p * ld + v) = val;
  }

  AccT acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = AccT(0);

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the patch is staged; every warp is done with the last tap
    stage_bt<T, TC_THREADS>(ws, ld, w + (size_t)tap * cin * cout, cout, 0, cin, cin, co0, cout);
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    for (int kb = 0; kb < pix; kb += KSTEP_BYTES) {
      const uint8_t* ap[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ap[i] = a_frag_addr(ps + ((4 * wm + i + dy) * TC_PC + dx) * ld + kb, ld, lane);
      warp_kstep<4>(acc, ap, b_pair_addr(ws + (32 * wn) * ld + kb, ld, lane), ld);
    }
  }

  const float s = scale ? *scale : 1.f;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = y0 + 4 * wm + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = x0 + g + 8 * h, n = co0 + 32 * wn + 8 * j + 2 * t;
        if (r >= rows || c >= cols || n >= cout) continue;
        float2 o;
        if constexpr (std::is_same<AccT, int>::value) {
          o.x = __int2float_rn(acc[i][j][2 * h]) * s;
          o.y = __int2float_rn(acc[i][j][2 * h + 1]) * s;
        } else {
          o.x = acc[i][j][2 * h];
          o.y = acc[i][j][2 * h + 1];
        }
        *reinterpret_cast<float2*>(out + ((size_t)r * cols + c) * cout + n) = o;
      }
  }
}

template <typename T>
cudaError_t launch_tapconv(const void* band, const void* w, const float* scale, void* out,
                           int bh, int bw, int cin, int cout, int rows, int cols,
                           cudaStream_t stream) {
  const size_t smem = tc_smem(cin, sizeof(T));
  if (smem > TC_SMEM_MAX) return cudaErrorInvalidValue;
  auto k = tapconv_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((cols + TC_TC - 1) / TC_TC, (rows + TC_TR - 1) / TC_TR,
                  (cout + TC_BN - 1) / TC_BN);
  k<<<grid, TC_THREADS, smem, stream>>>(static_cast<const T*>(band), static_cast<const T*>(w),
                                        scale, static_cast<float*>(out), bh, bw, cin, cout,
                                        rows, cols);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype 1: bf16 band and w, scale null. dtype 2: int8 band and w, scale a
// float in device memory. out (rows, cols, cout) float32.
extern "C" int pnp_tapconv(int dtype, const void* band, const void* w, const void* scale,
                           void* out, int bh, int bw, int cin, int cout, int rows, int cols,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (rows <= 0 || cols <= 0 || bh < rows + 2 || bw < cols + 2 || cout <= 0 || cout % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && cin > 0 && cin % 16 == 0 && !s)
    return (int)pnp::launch_tapconv<__nv_bfloat16>(band, w, s, out, bh, bw, cin, cout, rows,
                                                   cols, st);
  if (dtype == 2 && cin > 0 && cin % 32 == 0 && s)
    return (int)pnp::launch_tapconv<int8_t>(band, w, s, out, bh, bw, cin, cout, rows, cols, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block at the probe's 128 bf16 channels
extern "C" int pnp_tapconv_smem() { return (int)pnp::tc_smem(128, 2); }
