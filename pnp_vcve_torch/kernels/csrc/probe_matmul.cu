// K8: a tensor-core matrix product, out = a (m, k) @ b (k, n), both
// row-major: bf16 inputs with float32 sums and output, or int8 inputs with
// int32 sums, output as int32 or, given a scale s in device memory, as
// float32 float(sum) * s.
// K9: per-tensor absmax int8 quantization of a bf16 tensor,
//   s = max(max|x|, 1e-6) / 127,  q = clip(round_half_even(x / s), -127, 127)
// with IEEE division (this file is built without fast math).
//
// They replace the TPU probe kernels of tools/int8_probe.py (main :53):
// k1 (:70, bf16 matmul), k2 (:80, pre-quantized int8 matmul), k3 (:100,
// quantize in the kernel, int8 matmul, scale) and k4's quantize (:127). The
// TPU ran each as one block holding the whole of A in VMEM; k3's quantize
// took the max over that block. k3 is K9 then K8 with the scale.
//
// Bound: at the probe's 4096 x 128 x 128 the work is 134 MFLOP (0.14 us at
// 989 TFLOP/s bf16) against 3.2 MB of bytes (0.95 us at 3.35 TB/s): a
// launch (~2-4 us) costs more than either, so what counts is the latency
// of one wave of blocks. K9 is bound by its bytes: x read once (2 bytes a
// value), q written once (1 byte).
//
// K8, two designs, picked by the type:
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
// int8 (k2, and k3's product): matmul8_wg, wgmma's s8 form (m64n64k32) on
// the same 64 x 64 tiles, one consumer warpgroup and one producer warp. The
// s8 form reads B K-major only and B lies N-contiguous, so each block
// transposes its 64 columns of B, the whole depth, once into a resident
// K-major image (4 x 4 byte transposes by __byte_perm, 128-byte rows a
// 128-deep chunk, swizzled as a tensor map's 128-byte boxes); the producer
// issues A's first boxes (64 rows x 128 bytes, K-major, 128-byte swizzled,
// zeros past m and k) before the block transposes, so the two overlap;
// past 4 chunks of depth the boxes run through a ring of 4 stages. Four
// k-steps a chunk with both operands read by descriptors; the sums, int32
// or float(sum) * s (one rounding), go from registers into two swizzled
// 64 x 32 boxes and out by tensor-map stores that clip at m and n. Past
// M8_MAXK of depth (B's image would not fit) int8 runs matmul_kernel.
//
// matmul_kernel, mma.sync: the int8 design past M8_MAXK, and the yardstick
// of both types (pnp_matmul_mma_sync) chip_smoke.py times the wgmma designs
// against. A block of 8 warps computes a 128 x 64 tile of out; warp w
// computes rows 32 (w % 4) .. + 32 and columns 32 (w / 4) .. + 32 as 2 x 4
// mma tiles. The depth runs in chunks of 128 bytes: the chunk of A is
// staged row-major and that of B transposed (the "col" operand), each row
// padded by 16 bytes so that ldmatrix's eight row reads fall in distinct
// banks; rows and columns past m, n and k are zeros; synchronous staging,
// no pipelining.
//
// K9: absmax_quantize_kernel, one cooperative launch of a persistent grid
// whose blocks are all resident (blocks_per_sm x the SMs, from the
// occupancy calculator at the kernel's shared memory), x read from device
// memory once where it fits on chip. Block b takes the contiguous slice of
// 16-byte vectors [b per, (b + 1) per). Pass one: one thread issues bulk
// copies of the slice's first AQ_HOLD vectors (chunks of 1024 vectors, one
// mbarrier each, evict-first) into shared memory; meanwhile the threads
// stream the rest of the slice forward and take max|x| (as bf16 bit
// patterns, two at a time), then take it over the chunks as they land. One
// partial a block; the grid barrier; every block folds the partials (max is
// order-free: the same bits every run, no atomics, no memset) and computes
// s in JAX's order, block 0 stores it. Pass two: the chunks held in shared
// memory are quantized, then the rest is read again in the reverse order
// of pass one, so that its first bytes still come from the L2; q goes out
// in 16-byte streaming stores, a pair of vectors a thread. The probes' 1 MB
// and 4 MB fit on chip (264 blocks x 112 KB); K5's 720p geometry (118 MB)
// re-reads what does not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "bulk.cuh"
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

// ---- K8 int8: the wgmma design ------------------------------------------------------

namespace m8 {

constexpr int BM = 64, BN = 64, KB = 128;  // out tile; a depth chunk (128 int8)
constexpr int NS = 4;                      // A's ring stages
constexpr int ABOX = BM * KB;              // A's box, 8 KB
constexpr int BCH = BN * KB;               // a depth chunk of B's image, 8 KB
constexpr int OB = BM * 128;               // an output box: 64 rows x 32 four-byte columns
constexpr int NTHR = 160;                  // one consumer warpgroup, one producer warp
constexpr int MAXK = 2048;                 // B's image resident up to this depth
constexpr int TB = 4;                      // transpose units a thread loads before it stores

// a block's dynamic shared memory at depth k: alignment slack, A's ring,
// B's image, the two output boxes, the barriers (kernels/probes.py:
// matmul8_smem)
__host__ __device__ constexpr int smem(int k) {
  return 1024 + NS * ABOX + (k + KB - 1) / KB * BCH + 2 * OB + 2 * NS * 8;
}
static_assert(smem(MAXK) <= 232448, "an int8 wgmma matmul block fits an H100 block at MAXK");

// b (k, n) int8 -> B's image: chunk kc (depth 128 kc .. + 127) at bimg + kc
// BCH, row j (column n0 + j) the chunk's 128 depth bytes, 128-byte swizzled
// (16-byte piece p of row j at p ^ (j % 8): wgmma.cuh desc_sw128); zeros
// past k and n. A unit is 4 depth rows x 8 columns: four 8-byte loads, two
// 4 x 4 byte transposes, eight 4-byte stores, store t to column (t + cg) %
// 8 of its group cg, so that a warp's stores meet no bank twice.
__device__ __forceinline__ void stage_b(uint8_t* bimg, const int8_t* __restrict__ b, int n, int k,
                                        int n0, int nk) {
  const int units = nk * (KB / 4) * 8;
  for (int u0 = threadIdx.x; u0 < units; u0 += TB * NTHR) {
    uint2 r[TB][4];
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const int u = u0 + t * NTHR, c = n0 + 8 * (u % 8), k0 = 4 * (u / 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[t][i] = (u < units && k0 + i < k && c < n)
                      ? __ldg(reinterpret_cast<const uint2*>(b + (size_t)(k0 + i) * n + c))
                      : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int t = 0; t < TB; ++t) {
      const int u = u0 + t * NTHR;
      if (u >= units) break;
      const int cg = u % 8, k0 = 4 * (u / 8), kc = k0 / KB, kb = k0 % KB;
      // r[t][i] holds columns 8 cg .. + 7 of depth row k0 + i; col[j]
      // holds depth rows k0 .. k0 + 3 of column 8 cg + j
      uint32_t col[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t x0 = h ? r[t][0].y : r[t][0].x, x1 = h ? r[t][1].y : r[t][1].x;
        const uint32_t x2 = h ? r[t][2].y : r[t][2].x, x3 = h ? r[t][3].y : r[t][3].x;
        const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
        const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
        col[4 * h] = __byte_perm(lo01, lo23, 0x5410);
        col[4 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
        col[4 * h + 2] = __byte_perm(hi01, hi23, 0x5410);
        col[4 * h + 3] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int st = 0; st < 8; ++st) {
        const int j = (st + cg) & 7, row = 8 * cg + j;
        uint32_t v = col[0];
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (j == q) v = col[q];
        *reinterpret_cast<uint32_t*>(bimg + kc * BCH + row * 128 + (((kb >> 4) ^ j) << 4) +
                                     (kb & 15)) = v;
      }
    }
  }
}

// tm_a: a (m, k) int8 in boxes of 64 rows x 128 bytes, 128-byte swizzled;
// tm_out: out (m, n) int32 (SCALED: float32) in boxes of 64 rows x 32
// columns, 128-byte swizzled. b (k, n) int8 and the scale in device memory.
// Block (x, y) computes out rows 64 y .. + 64, columns 64 x .. + 64.
template <bool SCALED>
__global__ void __launch_bounds__(NTHR)
    matmul8_wg(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_out,
               const int8_t* __restrict__ b, const float* __restrict__ scale, int n, int k) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nk = (k + KB - 1) / KB;
  uint8_t* ring = tc::wgc::align1024(smem_raw);
  uint8_t* bimg = ring + NS * ABOX;
  uint8_t* obox = bimg + nk * BCH;
  uint64_t* full = reinterpret_cast<uint64_t*>(obox + 2 * OB);
  uint64_t* empty = full + NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // one arrival from each consumer warp
    }
    wg::fence_mbar_init();
  }
  __syncthreads();
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // the producer thread's loads: chunk kc into stage kc % NS, once the
  // consumers have released the chunk NS before it; the first NS go out
  // before B is transposed
  int kc_load = 0;
  auto load = [&]() {
    const int st = kc_load % NS;
    if (kc_load >= NS) wg::mbar_wait(&empty[st], ((kc_load / NS) & 1) ^ 1);
    wg::mbar_arrive_tx(&full[st], ABOX);
    tma::load_2d(ring + st * ABOX, &tm_a, kc_load * KB, m0, &full[st]);
    ++kc_load;
  };
  if (threadIdx.x == 128) {
    tma::prefetch(&tm_a);
    tma::prefetch(&tm_out);
    while (kc_load < nk && kc_load < NS) load();
  }
  stage_b(bimg, b, n, k, n0, nk);
  wg::fence_proxy_async();  // the image's stores, before the wgmma (async proxy) read them
  __syncthreads();
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128)
      while (kc_load < nk) load();
    return;
  }

  // ---- the consumer warpgroup: warp w holds out rows 16 w .. + 16 of the
  // tile; each chunk is one commit group, and a stage is released once the
  // group after it has been issued and its own has completed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc % NS;
    wg::mbar_wait(&full[st], (kc / NS) & 1);
    const uint64_t da = wg::desc_sw128(ring + st * ABOX), db = wg::desc_sw128(bimg + kc * BCH);
    wg::hold(acc);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < KB / KSTEP_BYTES; ++ks)
      wg::mma_s8_ss(acc, wg::desc_add(da, ks * KSTEP_BYTES), wg::desc_add(db, ks * KSTEP_BYTES));
    wg::commit();
    if (kc > 0) {  // the chunk before has completed: its stage is free
      wg::wait<1>();
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[(kc - 1) % NS]);
    }
  }
  wg::wait<0>();
  wg::hold(acc);
  // sums d[4 j + 2 hf + e]: row 16 warp + g + 8 hf, column 8 j + 2 t + e,
  // into box j / 4 (columns 32 (j / 4) .. + 31) as the tensor map's
  // 128-byte swizzle lays it
  const int g = lane / 4, t4 = lane % 4;
  const float s = SCALED ? *scale : 1.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int piece = 2 * (j % 4) + t4 / 2;
      uint8_t* o = obox + (j / 4) * OB + r * 128 + ((piece ^ (r % 8)) << 4) + (t4 % 2) * 8;
      const int v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
      if constexpr (SCALED)  // exact for |sum| < 2^24, one rounding
        *reinterpret_cast<float2*>(o) = make_float2(__int2float_rn(v0) * s, __int2float_rn(v1) * s);
      else
        *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
    }
  }
  wg::fence_proxy_async();  // the boxes' stores, before the tensor store (async proxy) reads them
  wg::named_sync(1, 128);
  if (threadIdx.x == 0) {
    tma::store_2d(&tm_out, n0, m0, obox);
    if (n0 + 32 < n) tma::store_2d(&tm_out, n0 + 32, m0, obox + OB);
    bulk::commit();
    tma::store_wait_all();
  }
}

}  // namespace m8

inline cudaError_t launch_matmul8_wg(const void* a, const void* b, const float* scale, void* out,
                                     int m, int n, int k, cudaStream_t stream) {
  CUtensorMap tm_a, tm_out;
  const uint64_t adims[2] = {(uint64_t)k, (uint64_t)m}, astr[1] = {(uint64_t)k};
  const uint64_t odims[2] = {(uint64_t)n, (uint64_t)m}, ostr[1] = {(uint64_t)n * 4};
  const uint32_t abox[2] = {m8::KB, m8::BM}, obox[2] = {32, m8::BM};
  cudaError_t e = tma::encode(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 2, adims, astr, abox, 128);
  if (e == cudaSuccess)
    e = tma::encode(&tm_out,
                    scale ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_INT32, out,
                    2, odims, ostr, obox, 128);
  if (e != cudaSuccess) return e;
  auto kern = scale ? m8::matmul8_wg<true> : m8::matmul8_wg<false>;
  const int smem = m8::smem(k);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + m8::BN - 1) / m8::BN, (m + m8::BM - 1) / m8::BM);
  kern<<<grid, m8::NTHR, smem, stream>>>(tm_a, tm_out, static_cast<const int8_t*>(b), scale, n, k);
  return cudaGetLastError();
}

// ---- K9 -------------------------------------------------------------------------------

namespace aq {

constexpr int NTHR = 512;
constexpr int CHUNK = 2 * NTHR;       // vectors (16 bytes: 8 values) a held chunk, a pair a thread
constexpr int NCHUNK = 7;             // held chunks a block at most
constexpr int HOLD = NCHUNK * CHUNK;  // vectors a block holds in shared memory (112 KB)
constexpr int SMEM = HOLD * 16;       // dynamic shared memory: two blocks an SM
constexpr int UNROLL = 2;             // pairs of the re-read part a thread loads at once
constexpr int STEP = 2 * NTHR * UNROLL;  // vectors an iteration over the re-read part

// The block's max of v, returned to every thread (v >= 0).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < NTHR / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// m, the bit patterns of two non-negative bf16 values, raised to |each|
// of a vector's eight values (non-negative bf16 values order as their bits)
__device__ __forceinline__ uint32_t absmax_bits(uint32_t m, uint4 v) {
  m = __vmaxu2(m, v.x & 0x7fff7fffu);
  m = __vmaxu2(m, v.y & 0x7fff7fffu);
  m = __vmaxu2(m, v.z & 0x7fff7fffu);
  return __vmaxu2(m, v.w & 0x7fff7fffu);
}

__device__ __forceinline__ int8_t quantize1(float v, float s) {
  // round half to even (as jnp.round), then clip; IEEE division
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// the eight int8 of a vector's eight values
__device__ __forceinline__ uint2 quantize8(uint4 v, float s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
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
  return o.u;
}

// q's vectors p and p + 1 (p even) from v0, v1; p + 1 where it is n16 (the
// tensor's last vector, at an odd count) is not stored
__device__ __forceinline__ void store_pair(int8_t* q, long long p, long long n16, uint4 v0,
                                           uint4 v1, float s) {
  const uint2 a = quantize8(v0, s);
  if (p + 1 < n16) {
    const uint2 b = quantize8(v1, s);
    __stcs(reinterpret_cast<int4*>(q) + p / 2, make_int4(a.x, a.y, b.x, b.y));
  } else {
    __stcs(reinterpret_cast<int2*>(q) + p, make_int2(a.x, a.y));
  }
}

// x: n16 vectors of 8 bf16; block b the vectors [b per, min((b + 1) per,
// n16)) (per even); parts: a float a block; q: n16 vectors of 8 int8; s_out:
// one float. Launched cooperatively, every block resident.
__global__ void __launch_bounds__(NTHR, 2)
    absmax_quantize_kernel(const uint4* __restrict__ x, long long n16, int per,
                           float* __restrict__ parts, int8_t* __restrict__ q,
                           float* __restrict__ s_out) {
  extern __shared__ __align__(16) uint4 held[];
  __shared__ __align__(8) uint64_t bars[NCHUNK];
  __shared__ float red[NTHR / 32];
  const long long v0 = (long long)blockIdx.x * per;
  const int len = (int)(min(v0 + per, n16) - v0);
  const int nheld = min(len, HOLD), nch = (nheld + CHUNK - 1) / CHUNK;
  const int rest = len - nheld, iters = (rest + STEP - 1) / STEP;
  const long long r0 = v0 + nheld;  // the first re-read vector (even)
  const long long v1 = v0 + len;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int c = 0; c < nch; ++c) bulk::mbar_init(&bars[c], 1);
    bulk::fence_mbar_init();
    for (int c = 0; c < nch; ++c) {
      const uint32_t bytes = 16u * min(CHUNK, nheld - c * CHUNK);
      bulk::mbar_expect_tx(&bars[c], bytes);
      bulk::load(held + c * CHUNK, x + v0 + c * CHUNK, bytes, &bars[c]);
    }
  }
  __syncthreads();  // the barriers are initialised

  // ---- pass one: the re-read part forward, then the chunks as they land
  uint32_t mb = 0;
  for (int it = 0; it < iters; ++it) {
    uint4 v[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = r0 + (long long)it * STEP + 2 * (u * NTHR + tid);
      v[u][0] = p < v1 ? __ldg(x + p) : make_uint4(0u, 0u, 0u, 0u);
      v[u][1] = p + 1 < v1 ? __ldg(x + p + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) mb = absmax_bits(absmax_bits(mb, v[u][0]), v[u][1]);
  }
  for (int c = 0; c < nch; ++c) {
    bulk::mbar_wait(&bars[c], 0);
    const int i = c * CHUNK + 2 * tid;
    if (i < nheld) mb = absmax_bits(mb, held[i]);
    if (i + 1 < nheld) mb = absmax_bits(mb, held[i + 1]);
  }
  float mx = __uint_as_float(max(mb >> 16, mb & 0xffffu) << 16);
  mx = block_max(mx, red);
  if (tid == 0) parts[blockIdx.x] = mx;

  // ---- the grid barrier, then every block folds the partials
  cooperative_groups::this_grid().sync();
  mx = 0.f;
  for (int i = tid; i < (int)gridDim.x; i += NTHR) mx = fmaxf(mx, __ldcg(parts + i));
  mx = block_max(mx, red);
  const float s = __fdiv_rn(fmaxf(mx, 1e-6f), 127.f);  // JAX's order: max, then / 127
  if (blockIdx.x == 0 && tid == 0) *s_out = s;

  // ---- pass two: the held chunks, then the re-read part backwards
  for (int c = 0; c < nch; ++c) {
    const int i = c * CHUNK + 2 * tid;
    if (i < nheld) store_pair(q, v0 + i, n16, held[i], held[i + 1], s);
  }
  for (int it = iters - 1; it >= 0; --it) {
    uint4 v[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = r0 + (long long)it * STEP + 2 * (u * NTHR + tid);
      v[u][0] = p < v1 ? __ldg(x + p) : make_uint4(0u, 0u, 0u, 0u);
      v[u][1] = p + 1 < v1 ? __ldg(x + p + 1) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long p = r0 + (long long)it * STEP + 2 * (u * NTHR + tid);
      if (p < v1) store_pair(q, p, n16, v[u][0], v[u][1], s);
    }
  }
}

}  // namespace aq

// blocks of absmax_quantize_kernel an SM can hold at its shared memory
// (0 where the query fails)
inline int absmax_blocks_per_sm() {
  int blocks = 0;
  if (cudaFuncSetAttribute(aq::absmax_quantize_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, aq::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, aq::absmax_quantize_kernel,
                                                    aq::NTHR, aq::SMEM) != cudaSuccess)
    return 0;
  return blocks;
}

}  // namespace pnp

namespace pnp {

// design 0: the wgmma designs (int8 past m8::MAXK of depth: mma.sync); 1:
// mma.sync for both types
inline int matmul_entry(int design, int dtype, const void* a, const void* b, const void* scale,
                        void* out, int m, int n, int k, cudaStream_t st) {
  const float* s = static_cast<const float*>(scale);
  if (m <= 0 || n <= 0 || k <= 0 || m % 16 || n % 8 || (design != 0 && design != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && k % 16 == 0 && !s)
    return design == 0 ? (int)launch_matmul_wg(a, b, out, m, n, k, st)
                       : (int)launch_matmul<__nv_bfloat16, float>(a, b, s, out, m, n, k, st);
  if (dtype == 2 && k % 32 == 0) {
    if (design == 0 && k <= m8::MAXK) return (int)launch_matmul8_wg(a, b, s, out, m, n, k, st);
    return s ? (int)launch_matmul<int8_t, float>(a, b, s, out, m, n, k, st)
             : (int)launch_matmul<int8_t, int>(a, b, s, out, m, n, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pnp

// K8. dtype: 1 bf16 (out float32; the wgmma design), 2 int8 (out int32, or
// float32 when scale is not null: float(sum) * *scale; the wgmma s8 design
// up to a depth of 2048, mma.sync past it). a (m, k), b (k, n), out (m, n),
// all row-major; m % 16 == 0, n % 8 == 0, k % 16 == 0 (bf16) or % 32 (int8).
extern "C" int pnp_matmul(int dtype, const void* a, const void* b, const void* scale, void* out,
                          int m, int n, int k, void* stream) {
  return pnp::matmul_entry(0, dtype, a, b, scale, out, m, n, k,
                           static_cast<cudaStream_t>(stream));
}

// The mma.sync design in both types, with pnp_matmul's arguments.
// chip_smoke.py times it beside the wgmma designs as the yardstick; no probe
// calls it.
extern "C" int pnp_matmul_mma_sync(int dtype, const void* a, const void* b, const void* scale,
                                   void* out, int m, int n, int k, void* stream) {
  return pnp::matmul_entry(1, dtype, a, b, scale, out, m, n, k,
                           static_cast<cudaStream_t>(stream));
}

// K9, one cooperative launch. x: n bf16 values (n % 8 == 0); grid blocks of
// per vectors of 8 values each (per even, every block some: kernels/
// probes.py absmax_schedule), at most pnp_absmax_blocks_per_sm() x the SMs;
// parts: grid floats of scratch; q: n int8; s: one float. A grid that
// cannot be resident is refused (cudaErrorCooperativeLaunchTooLarge).
extern "C" int pnp_absmax_quantize(const void* x, long long n, void* parts, void* q, void* s,
                                   int grid, int per, void* stream) {
  if (n <= 0 || n % 8 || grid < 1 || per < 2 || per % 2) return (int)cudaErrorInvalidValue;
  const long long n16 = n / 8;
  if ((long long)per * grid < n16 || (long long)per * (grid - 1) >= n16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pnp::aq::absmax_quantize_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, pnp::aq::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(pnp::aq::NTHR);
  cfg.dynamicSmemBytes = pnp::aq::SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, pnp::aq::absmax_quantize_kernel,
                         static_cast<const uint4*>(x), n16, per, static_cast<float*>(parts),
                         static_cast<int8_t*>(q), static_cast<float*>(s));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dynamic shared memory of one bf16 (wgmma) block, any shape
// (kernels/probes.py: MATMUL_SMEM)
extern "C" int pnp_matmul_smem() { return pnp::mw::smem(); }

// dynamic shared memory of one int8 (wgmma) block at depth k
// (kernels/probes.py: matmul8_smem)
extern "C" int pnp_matmul8_smem(int k) { return pnp::m8::smem(k); }

// blocks of K9 an SM holds (the cooperative grid's limit is this x the SMs)
extern "C" int pnp_absmax_blocks_per_sm() { return pnp::absmax_blocks_per_sm(); }

// K9's dynamic shared memory a block (kernels/probes.py: AQ_SMEM)
extern "C" int pnp_absmax_smem() { return pnp::aq::SMEM; }
