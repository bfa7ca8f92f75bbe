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
// Bound: at the probe's 4096 x 128 x 128 the work is 134 MFLOP (0.14 us at
// 989 TFLOP/s bf16) against 3.2 MB of bytes (0.95 us at 3.35 TB/s): a
// launch (~2-4 us) costs more than either, so what counts is the latency
// of one wave of blocks.
//
// Two designs, picked by the type:
//
// bf16: matmul_wg, wgmma with its operands loaded by the tensor memory
// accelerator (tma.cuh). A block computes a 64 x 64 tile of out (128 blocks
// at the probe's shape: one wave on 132 SMs) with one consumer warpgroup
// and one producer warp. The producer's thread copies each 64-deep chunk of
// the depth as two boxes into a ring of 4 stages (at the probe's k = 128
// the whole depth is two stages, both in flight at once): A's 64 rows x 64
// (128 bytes, K-major) and B's 64 rows of k x 64 columns (128 bytes, MN-major
// as B lies in device memory: bf16 wgmma reads a transposed B, so nothing is
// repacked), both 128-byte swizzled, zeros past m, n and k. The consumers
// run four m64n64k16 a chunk with both operands read from the stage by
// descriptors (A K-major, B MN-major), a chunk a commit group, the next
// chunk's products issued before the one before is waited for; the float32
// sums are stored from registers.
//
// int8 (k2, and k3's product): matmul_kernel, mma.sync. wgmma's s8 form
// reads B K-major only, so B would need a transpose in shared memory; on
// device time this design is already under torch._int_mm at the probe's
// shape (PERF.md), so it stays. A block of 8 warps computes a 128 x 64
// tile of out; warp w computes rows 32 (w % 4) .. + 32 and columns
// 32 (w / 4) .. + 32 as 2 x 4 mma tiles. The depth runs in chunks of 128
// bytes (128 int8): the chunk of A is staged row-major and that of B
// transposed (the "col" operand), each row padded by 16 bytes so that
// ldmatrix's eight row reads fall in distinct banks; rows and columns past
// m, n and k are zeros; synchronous staging, no pipelining. It also runs
// bf16 through pnp_matmul_mma_sync, the yardstick chip_smoke.py times the
// wgmma design against.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma.cuh"
#include "wg_conv.cuh"

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

// ---- K8 bf16: the wgmma design ------------------------------------------------------

namespace mw {

constexpr int BM = 64, BN = 64, BK = 64;  // out tile; a depth chunk (128 bytes of bf16)
constexpr int NS = 4;                     // ring stages
constexpr int ABOX = BM * 128, BBOX = BK * 128;  // A's and B's boxes, 8 KB each
constexpr int STAGE = ABOX + BBOX;
constexpr int NTHR = 160;                 // one consumer warpgroup, one producer warp

// a block's dynamic shared memory: alignment slack, the ring, its barriers
__host__ __device__ constexpr int smem() { return 1024 + NS * STAGE + 2 * NS * 8; }

// tm_a: a (m, k) in boxes of 64 rows x 64 (k); tm_b: b (k, n) in boxes of 64
// rows (k) x 64 (n); both bf16, 128-byte swizzled. Block (x, y) computes out
// rows 64 y .. + 64, columns 64 x .. + 64.
__global__ void __launch_bounds__(NTHR)
    matmul_wg(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
              float* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = tc::wgc::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * STAGE);
  uint64_t* empty = full + NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // one arrival from each consumer warp
    }
    wg::fence_mbar_init();
  }
  __syncthreads();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, nk = (k + BK - 1) / BK;

  if (threadIdx.x >= 128) {
    // ---- the producer warp: one thread copies each chunk's two boxes
    if (threadIdx.x == 128) {
      tma::prefetch(&tm_a);
      tma::prefetch(&tm_b);
      int slot = 0;
      uint32_t ph = 0;
      for (int kc = 0; kc < nk; ++kc) {
        wg::mbar_wait(&empty[slot], ph ^ 1);
        wg::mbar_arrive_tx(&full[slot], STAGE);
        uint8_t* st = ring + slot * STAGE;
        tma::load_2d(st, &tm_a, kc * BK, m0, &full[slot]);
        tma::load_2d(st + ABOX, &tm_b, n0, kc * BK, &full[slot]);
        if (++slot == NS) {
          slot = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: warp w holds out rows 16 w .. + 16 of the
  // tile. A chunk's four products read both operands from its stage; each
  // chunk is one commit group, and a stage is released once the group after
  // it has been issued and its own has completed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  int slot = 0;
  uint32_t ph = 0;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);
  };
  for (int kc = 0; kc < nk; ++kc) {
    wg::mbar_wait(&full[slot], ph);
    const uint8_t* st = ring + slot * STAGE;
    const uint64_t da = wg::desc_sw128(st), db = wg::desc_mn<128>(st + ABOX);
    wg::hold(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg::mma_bf16_ss_mn(acc, wg::desc_add(da, ks * KSTEP_BYTES), wg::desc_add(db, ks * 16 * 128));
    wg::commit();
    if (kc > 0) {  // the chunk before has completed: its stage is free
      wg::wait<1>();
      release(slot == 0 ? NS - 1 : slot - 1);
    }
    if (++slot == NS) {
      slot = 0;
      ph ^= 1;
    }
  }
  wg::wait<0>();
  wg::hold(acc);
  // sums d[4 j + 2 hf + e]: row 16 warp + g + 8 hf, column 8 j + 2 t + e
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = m0 + 16 * warp + g + 8 * hf, c = n0 + 8 * j + 2 * t;
      if (r < m && c < n)
        *reinterpret_cast<float2*>(out + (size_t)r * n + c) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
}

}  // namespace mw

inline cudaError_t launch_matmul_wg(const void* a, const void* b, void* out, int m, int n, int k,
                                    cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  const uint64_t adims[2] = {(uint64_t)k, (uint64_t)m}, astr[1] = {(uint64_t)k * 2};
  const uint64_t bdims[2] = {(uint64_t)n, (uint64_t)k}, bstr[1] = {(uint64_t)n * 2};
  const uint32_t abox[2] = {mw::BK, mw::BM}, bbox[2] = {mw::BN, mw::BK};
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = tma::encode(&tm_a, bf16, a, 2, adims, astr, abox, 128);
  if (e == cudaSuccess) e = tma::encode(&tm_b, bf16, b, 2, bdims, bstr, bbox, 128);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mw::matmul_wg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           mw::smem());
  if (e != cudaSuccess) return e;
  const dim3 grid((n + mw::BN - 1) / mw::BN, (m + mw::BM - 1) / mw::BM);
  mw::matmul_wg<<<grid, mw::NTHR, mw::smem(), stream>>>(tm_a, tm_b, static_cast<float*>(out), m,
                                                        n, k);
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

namespace pnp {

// design 0: bf16 by the wgmma design, int8 by mma.sync; 1: mma.sync for both
inline int matmul_entry(int design, int dtype, const void* a, const void* b, const void* scale,
                        void* out, int m, int n, int k, cudaStream_t st) {
  const float* s = static_cast<const float*>(scale);
  if (m <= 0 || n <= 0 || k <= 0 || m % 16 || n % 8 || (design != 0 && design != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && k % 16 == 0 && !s)
    return design == 0 ? (int)launch_matmul_wg(a, b, out, m, n, k, st)
                       : (int)launch_matmul<__nv_bfloat16, float>(a, b, s, out, m, n, k, st);
  if (dtype == 2 && k % 32 == 0)
    return s ? (int)launch_matmul<int8_t, float>(a, b, s, out, m, n, k, st)
             : (int)launch_matmul<int8_t, int>(a, b, s, out, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pnp

// K8. dtype: 1 bf16 (out float32; the wgmma design), 2 int8 (out int32, or
// float32 when scale is not null: float(sum) * *scale; mma.sync). a (m, k),
// b (k, n), out (m, n), all row-major; m % 16 == 0, n % 8 == 0, k % 16 == 0
// (bf16) or % 32 (int8).
extern "C" int pnp_matmul(int dtype, const void* a, const void* b, const void* scale, void* out,
                          int m, int n, int k, void* stream) {
  return pnp::matmul_entry(0, dtype, a, b, scale, out, m, n, k,
                           static_cast<cudaStream_t>(stream));
}

// The mma.sync design for bf16 too, with pnp_matmul's arguments.
// chip_smoke.py times it beside the wgmma design as the yardstick; no probe
// calls it.
extern "C" int pnp_matmul_mma_sync(int dtype, const void* a, const void* b, const void* scale,
                                   void* out, int m, int n, int k, void* stream) {
  return pnp::matmul_entry(1, dtype, a, b, scale, out, m, n, k,
                           static_cast<cudaStream_t>(stream));
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

// dynamic shared memory of one bf16 (wgmma) block, any shape
// (kernels/probes.py: MATMUL_SMEM)
extern "C" int pnp_matmul_smem() { return pnp::mw::smem(); }

// scratch floats pnp_absmax_quantize needs for its partials
extern "C" int pnp_absmax_parts() { return pnp::AQ_PARTS; }
