// K8: a tensor-core matrix product, out = a (m, k) @ b (k, n), both
// row-major: bf16 inputs with float32 sums and output, or int8 inputs with
// int32 sums, output as int32 or, given a scale s in device memory, as
// float32 float(sum) * s.
// K9: per-tensor absmax int8 quantization of a bf16 tensor,
//   s = max(max|x|, 1e-6) / 127,  q = clip(round_half_even(x / s), -127, 127)
// with IEEE division (this file is built without fast math).
//
// They replace the TPU probe kernels of tools/int8_probe.py (main :53):
// k1 (:70, bf16 matmul), k2 (:80, pre-quantized int8 matmul) and k3 (:100,
// quantize in the kernel, int8 matmul, scale). The TPU ran each as one block
// holding the whole of A in VMEM; k3's quantize took the max over that block.
// Blocks on the card cannot see each other, so K9 is two passes: a max of
// |x| over grid-stride slices into one partial per block, then a quantize
// pass in which every block reduces the partials itself (a few hundred
// floats from L2) and block 0 stores s for K8's epilogue. No atomics, no
// memset, the same bits every run. k3 is K9 then K8 with the scale.
//
// K8's layout: a block of 8 warps computes a 128 x 64 tile of out; warp w
// computes rows 32 (w % 4) .. + 32 and columns 32 (w / 4) .. + 32 as 2 x 4
// mma tiles. The depth runs in chunks of 128 bytes (64 bf16 or 128 int8):
// the chunk of A is staged row-major and that of B transposed (the "col"
// operand), each row padded by 16 bytes so that ldmatrix's eight row reads
// fall in distinct banks; rows and columns past m, n and k are zeros.
//
// Bound: at the probe's 4096 x 128 x 128 the work is 134 MFLOP (0.14 us at
// 989 TFLOP/s bf16) against 3.2 MB of bytes (0.95 us at 3.35 TB/s): a
// launch (~2-4 us) costs more than either. The design is the simple one,
// synchronous staging and no pipelining; wgmma and TMA are for the PRs that
// make a kernel fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma.cuh"

namespace pnp {

constexpr int MM_THREADS = 256;
constexpr int MM_BM = 128, MM_BN = 64;  // block tile
constexpr int MM_KB = 128;              // depth chunk in bytes
constexpr int MM_LD = MM_KB + 16;       // shared row stride in bytes

template <typename T, typename Out>
__global__ void __launch_bounds__(MM_THREADS)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ scale, Out* __restrict__ out, int m, int n, int k) {
  using AccT = typename Acc<T>::type;
  __shared__ __align__(16) uint8_t as[MM_BM * MM_LD];
  __shared__ __align__(16) uint8_t bs[MM_BN * MM_LD];
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int row_bytes = k * (int)sizeof(T);
  constexpr int KE = MM_KB / (int)sizeof(T);  // elements per chunk

  AccT acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = AccT(0);

  for (int kb0 = 0; kb0 < row_bytes; kb0 += MM_KB) {
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < MM_BM * (MM_KB / 16); i += MM_THREADS) {
      const int r = i / (MM_KB / 16), v = (i % (MM_KB / 16)) * 16;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < m && kb0 + v < row_bytes)
        val = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(a) +
                                                   (size_t)(m0 + r) * row_bytes + kb0 + v));
      *reinterpret_cast<uint4*>(as + r * MM_LD + v) = val;
    }
    const int k0 = kb0 / (int)sizeof(T);
    stage_bt<T, MM_THREADS>(bs, MM_LD, b, n, k0, min(KE, k - k0), KE, n0, n);
    __syncthreads();
    const int steps = min(MM_KB, row_bytes - kb0) / KSTEP_BYTES;
    for (int ks = 0; ks < steps; ++ks) {
      const uint8_t* ap[2] = {
          a_frag_addr(as + (32 * wm) * MM_LD + ks * KSTEP_BYTES, MM_LD, lane),
          a_frag_addr(as + (32 * wm + 16) * MM_LD + ks * KSTEP_BYTES, MM_LD, lane)};
      warp_kstep<2>(acc, ap, b_pair_addr(bs + (32 * wn) * MM_LD + ks * KSTEP_BYTES, MM_LD, lane),
                    MM_LD);
    }
  }

  const float s = scale ? *scale : 1.f;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 32 * wm + 16 * i + g + 8 * h, c = n0 + 32 * wn + 8 * j + 2 * t;
        if (r >= m || c >= n) continue;
        Out* o = out + (size_t)r * n + c;
        if constexpr (std::is_same<Out, float>::value && std::is_same<AccT, int>::value) {
          o[0] = __int2float_rn(acc[i][j][2 * h]) * s;  // exact for |sum| < 2^24, one rounding
          o[1] = __int2float_rn(acc[i][j][2 * h + 1]) * s;
        } else {
          o[0] = acc[i][j][2 * h];
          o[1] = acc[i][j][2 * h + 1];
        }
      }
}

template <typename T, typename Out>
cudaError_t launch_matmul(const void* a, const void* b, const float* scale, void* out, int m,
                          int n, int k, cudaStream_t stream) {
  const dim3 grid((n + MM_BN - 1) / MM_BN, (m + MM_BM - 1) / MM_BM);
  matmul_kernel<T, Out><<<grid, MM_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), scale, static_cast<Out*>(out), m, n, k);
  return cudaGetLastError();
}

// ---- K9 -------------------------------------------------------------------------------

constexpr int AQ_THREADS = 256;
constexpr int AQ_PARTS = 264;  // pass-one blocks at most: two per SM of an H100

// The block's max of v, returned to every thread (v >= 0).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < AQ_THREADS / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// Pass one: parts[block] = max |x| over the block's grid-stride slices of
// 8 values.
__global__ void __launch_bounds__(AQ_THREADS)
    absmax_kernel(const __nv_bfloat16* __restrict__ x, size_t n8, float* __restrict__ parts) {
  __shared__ float red[AQ_THREADS / 32];
  float mx = 0.f;
  for (size_t i = (size_t)blockIdx.x * AQ_THREADS + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * AQ_THREADS) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      mx = fmaxf(mx, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  mx = block_max(mx, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = mx;
}

__device__ __forceinline__ int8_t quantize1(float v, float s) {
  // round half to even (as jnp.round), then clip; IEEE division
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// Pass two: s from the partials, then q = quantize(x) over grid-stride
// slices of 8 values; block 0 stores s.
__global__ void __launch_bounds__(AQ_THREADS)
    quantize_kernel(const __nv_bfloat16* __restrict__ x, size_t n8,
                    const float* __restrict__ parts, int nparts, int8_t* __restrict__ q,
                    float* __restrict__ s_out) {
  __shared__ float red[AQ_THREADS / 32];
  float mx = 0.f;
  for (int i = threadIdx.x; i < nparts; i += AQ_THREADS) mx = fmaxf(mx, parts[i]);
  mx = block_max(mx, red);
  const float s = __fdiv_rn(fmaxf(mx, 1e-6f), 127.f);  // JAX's order: max, then / 127
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  for (size_t i = (size_t)blockIdx.x * AQ_THREADS + threadIdx.x; i < n8;
       i += (size_t)gridDim.x * AQ_THREADS) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    union {
      int8_t b[8];
      uint2 u;
    } o;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o.b[2 * j] = quantize1(f.x, s);
      o.b[2 * j + 1] = quantize1(f.y, s);
    }
    reinterpret_cast<uint2*>(q)[i] = o.u;
  }
}

}  // namespace pnp

// K8. dtype: 1 bf16 (out float32), 2 int8 (out int32, or float32 when scale
// is not null: float(sum) * *scale). a (m, k), b (k, n), out (m, n), all
// row-major; m % 16 == 0, n % 8 == 0, k % 16 == 0 (bf16) or % 32 (int8).
extern "C" int pnp_matmul(int dtype, const void* a, const void* b, const void* scale, void* out,
                          int m, int n, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (m <= 0 || n <= 0 || k <= 0 || m % 16 || n % 8) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && k % 16 == 0 && !s)
    return (int)pnp::launch_matmul<__nv_bfloat16, float>(a, b, s, out, m, n, k, st);
  if (dtype == 2 && k % 32 == 0)
    return s ? (int)pnp::launch_matmul<int8_t, float>(a, b, s, out, m, n, k, st)
             : (int)pnp::launch_matmul<int8_t, int>(a, b, s, out, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// K9 (both passes). x: n bf16 values (n % 8 == 0); parts: pnp_absmax_parts()
// floats of scratch; q: n int8; s: one float.
extern "C" int pnp_absmax_quantize(const void* x, long long n, void* parts, void* q, void* s,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  const size_t n8 = (size_t)n / 8;
  const int nparts = (int)std::min<size_t>(pnp::AQ_PARTS, (n8 + pnp::AQ_THREADS - 1) / pnp::AQ_THREADS);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  pnp::absmax_kernel<<<nparts, pnp::AQ_THREADS, 0, st>>>(xb, n8, static_cast<float*>(parts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nq = (int)std::min<size_t>(132 * 8, (n8 + pnp::AQ_THREADS - 1) / pnp::AQ_THREADS);
  pnp::quantize_kernel<<<nq, pnp::AQ_THREADS, 0, st>>>(xb, n8, static_cast<const float*>(parts),
                                                       nparts, static_cast<int8_t*>(q),
                                                       static_cast<float*>(s));
  return (int)cudaGetLastError();
}

// scratch floats pnp_absmax_quantize needs for its partials
extern "C" int pnp_absmax_parts() { return pnp::AQ_PARTS; }
