// K7: the selection-matmul warp of the TPU probes, a horizontal pass on the
// tensor cores and a vertical pass on the CUDA cores. For band ri (8 output
// rows) and tile tj (128 output columns, source window from ws = 128 tj):
//
//   H: hband[j, o, :] = bf16(sum over k < kw of S[ri, tj, o, k] * src[0, 8 ri + j0 + j, ws + k, :])
//   V: out[0, 8 ri + i, ws + o, :] = bf16(sum over d < dv of vm[ri, ws + o, d] * hband[d + i, o, :])
//
// with i < 8, j < dv + 7 and j0 = 0 (the V mode), or the H pass alone on
// rows j0 .. j0 + 7 written as the output rows (the H mode), with columns
// nt * 128 .. wout - 1 of the output zeros.
//
// Replaces tools/warp_kernel_probe2.py: probe_mmsel (:125; V mode; S from
// build_s, two bilinear taps per row of S) and tools/warp_bisect.py:
// k_fori_dot (:84; H mode, tile 0, one S for every band, rows 16 .. 23).
// The TPU probe leaves k_fori_dot's columns 128 .. 255 unwritten (scratch
// from an earlier grid step); here they are zeros.
//
// Layout. A block (tj, channel group, ri) of 4 warps owns 8 channels (one
// 16-byte run a pixel). Warp w keeps the A fragments of S rows 32 w .. + 32,
// all 12 k-steps of the depth kw zero-padded to 192 (kw = 184 is no multiple
// of 16), in registers for the whole block. The source window's rows stream
// through shared memory, two buffers, one row (192 pixels x 8 channels, the
// "col" operand through ldmatrix.trans) ahead of the mma. A band's whole
// hband (48 x 128 x 64 bf16 = 786 KB) does not fit in a block's 227 KB, and
// a pass through device memory would write and read it again; so a block
// takes 8 channels, whose hband (47 rows x 128 x 8 bf16 = 94 KB) stays in
// shared memory for the V pass: two blocks fit on an SM. The V pass sums
// in float32 in the TPU kernel's order, d = 0 .. dv - 1, one fused
// multiply-add a term, as XLA compiles that kernel's acc + h * w.
//
// Bound: S has two non-zeros a row and vm two a pixel, so the function
// needs few operations; the dense products the TPU ran are 128 GFLOP at
// 720p (0.13 ms at 989 TFLOP/s). Bytes: xp 131 MB, S 42 MB, vm 18 MB, out
// 118 MB (0.09 ms). The block re-reads its window rows (6 of every 48 rows
// overlap the next band's) and S once a channel group, from L2. On an H100
// (700 W) it runs at ~20x that bound: one row of look-ahead does not cover
// a row's load latency, so each of a block's 47 rows waits on memory; a
// deeper ring of rows (cp.async or TMA) is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace pnp {

constexpr int MS_THREADS = 128;
constexpr int MS_TILE = 128;       // output columns a tile (S rows)
constexpr int MS_KP = 192;         // depth: kw <= 192 taps, zero-padded
constexpr int MS_KS = MS_KP / 16;  // 12 bf16 k-steps
constexpr int MS_CG = 8;           // channels a block
constexpr int MS_B = 8;            // output rows a band
constexpr int MS_DVMAX = 40;       // V terms at most
constexpr size_t MS_WIN = (size_t)MS_KP * MS_CG * 2;  // one window row, bytes

__host__ __device__ constexpr size_t ms_smem(bool v_mode, int dv) {
  return 2 * MS_WIN + (v_mode ? (size_t)(dv + MS_B - 1) * MS_TILE * MS_CG * 2 : 0);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <bool kV>
__global__ void __launch_bounds__(MS_THREADS, 2)
    mmsel_kernel(const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ s,
                 const float* __restrict__ vm, __nv_bfloat16* __restrict__ out, int hs, int wsrc,
                 int c, int kw, long long s_band, long long s_tile, int j0, int nrows, int dv,
                 int wvm, int wout, int nt) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][MS_KP][MS_CG]
  __nv_bfloat16* hband = win + 2 * MS_KP * MS_CG;               // [nrows][MS_TILE][MS_CG]
  const int tj = blockIdx.x, ri = blockIdx.z;
  const int c0 = blockIdx.y * MS_CG, ws = tj * MS_TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // S rows 32 warp + 16 m + g (+ 8), depth k = 16 ks + 2t (+ 1) (+ 8)
  const __nv_bfloat16* st = s + ri * s_band + tj * s_tile;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint32_t af[2][MS_KS][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ks = 0; ks < MS_KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = 32 * warp + 16 * m + g + 8 * (q & 1), k = 16 * ks + 2 * t + 8 * (q >> 1);
        const __nv_bfloat16* row = st + (size_t)o * kw;
        af[m][ks][q] = pack_bf16(k < kw ? row[k] : zero, k + 1 < kw ? row[k + 1] : zero);
      }

  // window row j: src[0, 8 ri + j0 + j, ws .. ws + 191, c0 .. c0 + 7], zeros
  // past kw or the source
  auto stage = [&](int j, __nv_bfloat16* buf) {
    const int y = ri * MS_B + j0 + j;
    for (int p = threadIdx.x; p < MS_KP; p += MS_THREADS) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < kw && ws + p < wsrc && y < hs)
        v = __ldg(reinterpret_cast<const uint4*>(src + ((size_t)y * wsrc + ws + p) * c + c0));
      *reinterpret_cast<uint4*>(buf + p * MS_CG) = v;
    }
  };

  stage(0, win);
  __syncthreads();
  for (int j = 0; j < nrows; ++j) {
    const __nv_bfloat16* cur = win + (j & 1) * MS_KP * MS_CG;
    if (j + 1 < nrows) stage(j + 1, win + ((j + 1) & 1) * MS_KP * MS_CG);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kp = 0; kp < MS_KS / 2; ++kp) {
      // pixels 32 kp + lane: matrices (k-step 2 kp, k 0-7), (2 kp, 8-15),
      // (2 kp + 1, 0-7), (2 kp + 1, 8-15), transposed to the "col" operand
      uint32_t b[4];
      ldmatrix_x4_trans(b, cur + (32 * kp + lane) * MS_CG);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_step(acc[m], af[m][2 * kp], b[0], b[1]);
        mma_step(acc[m], af[m][2 * kp + 1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 32 * warp + 16 * m + g + 8 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[m][2 * h], acc[m][2 * h + 1]);
        __nv_bfloat16* dst =
            kV ? hband + ((size_t)j * MS_TILE + o) * MS_CG + 2 * t
               : out + ((size_t)(ri * MS_B + j) * wout + ws + o) * c + c0 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dst) = v;
      }
    __syncthreads();  // cur is free for row j + 2; hband row j is complete
  }

  if constexpr (kV) {
    const int o = threadIdx.x;  // one output column a thread
    const float* vrow = vm + ((size_t)ri * wvm + ws + o) * dv;
    float wv[MS_DVMAX];
#pragma unroll
    for (int d = 0; d < MS_DVMAX; ++d) wv[d] = d < dv ? vrow[d] : 0.f;
    for (int i = 0; i < MS_B; ++i) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < MS_DVMAX; ++d) {
        if (d >= dv) break;
        const uint4 u = *reinterpret_cast<const uint4*>(hband + ((size_t)(d + i) * MS_TILE + o) * MS_CG);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(h[k]);
          acc[2 * k] = __fmaf_rn(f.x, wv[d], acc[2 * k]);
          acc[2 * k + 1] = __fmaf_rn(f.y, wv[d], acc[2 * k + 1]);
        }
      }
      uint4 r;
      __nv_bfloat162* rh = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
      for (int k = 0; k < 4; ++k) rh[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
      *reinterpret_cast<uint4*>(out + ((size_t)(ri * MS_B + i) * wout + ws + o) * c + c0) = r;
    }
  } else if (tj == 0) {
    // the columns past the tiles, zeros
    const uint4 z = make_uint4(0, 0, 0, 0);
    const int extra = wout - nt * MS_TILE;
    for (int p = threadIdx.x; p < MS_B * extra; p += MS_THREADS) {
      const int i = p / extra, x = nt * MS_TILE + p % extra;
      *reinterpret_cast<uint4*>(out + ((size_t)(ri * MS_B + i) * wout + x) * c + c0) = z;
    }
  }
}

}  // namespace pnp

// src (1, hs, wsrc, c) bf16, c % 8 == 0; s (nb or 1, nt, 128, kw) bf16 with
// kw <= 192, read at s_band (0: one S for every band) and s_tile
// elements a band and a tile; out (1, 8 nb, wout, c) bf16.
// V mode (vm not null): vm (nb, wvm, dv) float32 with dv <= 40 and
// wout = wvm = 128 nt, H rows 0 .. dv + 6. H mode (vm null): the H pass on
// rows j0 .. j0 + 7 of each band, wout >= 128 nt.
// The window of tile nt - 1 must lie inside src: 128 (nt - 1) + kw <= wsrc.
extern "C" int pnp_mmsel(const void* src, const void* s, const void* vm, void* out, int nb,
                         int nt, int hs, int wsrc, int c, int kw, long long s_band,
                         long long s_tile, int j0, int dv, int wout, void* stream) {
  const bool v_mode = vm != nullptr;
  if (nb < 1 || nt < 1 || c < 8 || c % 8 || kw < 2 || kw > pnp::MS_KP ||
      pnp::MS_TILE * (nt - 1) + kw > wsrc || wout < pnp::MS_TILE * nt)
    return (int)cudaErrorInvalidValue;
  if (v_mode && (dv < 1 || dv > pnp::MS_DVMAX || j0 != 0 || wout != pnp::MS_TILE * nt ||
                 pnp::MS_B * (nb - 1) + dv + pnp::MS_B - 1 > hs))
    return (int)cudaErrorInvalidValue;
  if (!v_mode && (j0 < 0 || pnp::MS_B * nb + j0 > hs)) return (int)cudaErrorInvalidValue;
  const int nrows = v_mode ? dv + pnp::MS_B - 1 : pnp::MS_B;
  const size_t smem = pnp::ms_smem(v_mode, dv);
  auto k = v_mode ? pnp::mmsel_kernel<true> : pnp::mmsel_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nt, c / pnp::MS_CG, nb);
  k<<<grid, pnp::MS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(s),
      static_cast<const float*>(vm), static_cast<__nv_bfloat16*>(out), hs, wsrc, c, kw, s_band,
      s_tile, j0, nrows, dv, wout, wout, nt);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one block in the V mode at the probe's dv = 40
extern "C" int pnp_mmsel_smem() { return (int)pnp::ms_smem(true, pnp::MS_DVMAX); }
