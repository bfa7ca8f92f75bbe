// K7: the selection-matmul warp of the TPU probes, a horizontal pass on the
// tensor cores (wgmma) and a vertical pass fused into its epilogue. For band
// ri (8 output rows) and tile tj (128 output columns, source window from
// ws = 128 tj):
//
//   H: hband[j, o, :] = bf16(sum over k < kw of S[ri, tj, o, k] * src[0, 8 ri + j0 + j, ws + k, :])
//   V: out[0, 8 ri + i, ws + o, :] = bf16(sum over d < dv of vm[ri, ws + o, d] * hband[d + i, o, :])
//
// with i < 8, j < dv + 7 and j0 = 0 (the V mode), or the H pass alone on
// rows j0 .. j0 + 7 written as the output rows (the H mode), with columns
// nt * 128 .. wout - 1 of the output zeros. S is any matrix: the kernel
// takes the dense product (k_fori_dot's S is all ones).
//
// Replaces tools/warp_kernel_probe2.py: probe_mmsel (:125; V mode; S from
// build_s, two bilinear taps per row of S) and tools/warp_bisect.py:
// k_fori_dot (:84; H mode, tile 0, one S for every band, rows 16 .. 23).
// The TPU probe leaves k_fori_dot's columns 128 .. 255 unwritten (scratch
// from an earlier grid step); here they are zeros.
//
// Design (mmsel_wg). The H pass of a window row is one wgmma product: M =
// the tile's 128 columns o (two consumer warpgroups of 64), K = the taps,
// kw zero-padded to 192 (12 k-steps), N = 32 channels. Work items are
// (band, tile, row group, 32-channel part), channel part fastest; a block
// of two consumer warpgroups and one producer warpgroup runs one an SM,
// persistent over the items (grid = min(items, SMs); block b takes items b,
// b + grid, ...). kernels/probes.py: mmsel_schedule mirrors the walk, the
// row groups and the shared memory; the wrapper passes its numbers.
//   - One producer thread copies each item's S into one of two item slots,
//     the next item's while the current one computes: three tensor-map
//     boxes of 128 rows x 64 taps (tma.cuh), 128-byte swizzled, zeros past
//     kw (where 2 kw is no multiple of 16, producer warp 0's stores lay it
//     out the same way), and in the V mode its 128 x dv block of vm (one
//     bulk copy).
//   - Another streams the window rows through a ring of NS (6) stages, each
//     row one box of kw taps x 32 channels, MN-major (each tap's channels
//     contiguous), 64-byte swizzled, zeros past the source and past c; the
//     taps kw .. 191 of every stage are zeroed once. The rows run in one
//     sequence over a block's items, rounded up to an even count an item
//     (the extra row reaches no output).
//   - The consumers load S's A fragments from the slot once an item (48
//     registers), then per row 12 wgmma m64n32k16 (B read MN-major through
//     the descriptor), the row's sums in 16 registers a thread, two rows in
//     flight: row j + 1's products run while row j's epilogue does. H
//     mode: rounded to bf16 and stored. V mode: each row, rounded to bf16,
//     is added straight into the 8 output rows' float32 sums held in
//     registers, acc[i] = fma(vm[o, r - i], h_r, acc[i]) for 0 <= r - i <
//     dv, then dropped: each output's terms still arrive in the order d = 0,
//     1, ..., one fused multiply-add a term, as XLA compiles the TPU
//     kernel's acc + h * w; hband never reaches shared memory.
//
// Bound: S has two non-zeros a row and vm two a pixel, so the function
// needs few operations; the dense products the TPU ran are 128 GFLOP at
// 720p (0.13 ms at 989 TFLOP/s). Bytes: xp 131 MB, S 42 MB, vm 18 MB, out
// 118 MB (0.09 ms). This design runs the dense product: at 720p the tensor
// cores at their peak and the fused V pass on the CUDA cores bound it, not
// the bytes; each window row is read from L2 by its 6 bands' items. The H
// mode (k_fori_dot, 2 or 4 MB) is a matter of latency: its items are cut
// into row groups until they fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "wg_conv.cuh"

namespace pnp {
namespace ms {

using tc::wgc::NCONS;
using tc::wgc::NCW;
using tc::wgc::NTHR;
using tc::wgc::REG_CONS;
using tc::wgc::REG_PROD;

constexpr int TILE = 128;        // output columns a tile (S rows)
constexpr int KP = 192;          // depth: kw <= 192 taps, zero-padded
constexpr int KS = KP / 16;      // 12 bf16 k-steps
constexpr int NC = 32;           // channels an item: the wgmma's N
constexpr int B = 8;             // output rows a band
constexpr int DVMAX = 40;        // V terms at most
constexpr int NS = 6;            // window-row stages
constexpr int SBLK = TILE * 128;   // a 64-tap block of S's image: 128 rows of 128 bytes
constexpr int SIMG = 3 * SBLK;     // S's image: taps 0-63, 64-127, 128-191
constexpr int ROWB = KP * NC * 2;  // a window row: 192 taps x 64 bytes
constexpr int SW = NC * 2;         // its swizzle: one 64-byte row a tap
constexpr int NBAR = 2 * NS + 4;   // the ring's and the two slots' barriers

__host__ __device__ constexpr int slot_bytes(bool v_mode, int dv) {
  return (SIMG + (v_mode ? TILE * dv * 4 : 0) + 1023) / 1024 * 1024;
}
// a block's dynamic shared memory: 1024-byte alignment slack, the row ring,
// two item slots, the barriers (kernels/probes.py: mmsel_schedule)
__host__ __device__ constexpr int smem(bool v_mode, int dv) {
  return 1024 + NS * ROWB + 2 * slot_bytes(v_mode, dv) + NBAR * 8;
}
static_assert(smem(true, DVMAX) <= 232448, "a V-mode block fits an SM's shared memory");

// the byte of S's image holding tap k of row o (16-byte chunks swizzled by
// the row, as the boxes land)
__device__ __forceinline__ int s_byte(int o, int k) {
  return (k / 64) * SBLK + o * 128 + ((((k % 64) / 8) ^ (o % 8)) << 4) + (k % 8) * 2;
}

// item it -> (band, tile, row group, channel part), the channel part fastest
struct Item {
  int ri, tj, rg, cp;
  __device__ __forceinline__ Item(int it, int nt, int nrg, int ncp) {
    cp = it % ncp;
    it /= ncp;
    rg = it % nrg;
    it /= nrg;
    tj = it % nt;
    ri = it / nt;
  }
};

// tm_src: src (hs, wsrc, c) in boxes of 1 x kw x 32, 64-byte swizzled;
// tm_s: S as (rows, kw) in boxes of 128 x 64, 128-byte swizzled (where 2 kw
// is a multiple of 16; else s is read by warp 0's loads)
template <bool kV>
__global__ void __launch_bounds__(NTHR, 1)
    mmsel_wg(const __grid_constant__ CUtensorMap tm_src, const __grid_constant__ CUtensorMap tm_s,
             const __nv_bfloat16* __restrict__ s, const float* __restrict__ vm,
             __nv_bfloat16* __restrict__ out, int c, int kw, long long s_band, long long s_tile,
             int j0, int nrows, int dv, int wout, int nt, int nrg, int ncp, int items) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = tc::wgc::align1024(smem_raw);
  const int sbytes = slot_bytes(kV, dv);
  uint8_t* slots = ringb + NS * ROWB;
  uint64_t* rfull = reinterpret_cast<uint64_t*>(slots + 2 * sbytes);
  uint64_t* rempty = rfull + NS;
  uint64_t* sfull = rempty + NS;  // two: the producer's arrival with the slot's bytes
  uint64_t* sempty = sfull + 2;   // two: one arrival from each consumer warp
  if (threadIdx.x == 0) {
    for (int k = 0; k < NS; ++k) {
      wg::mbar_init(&rfull[k], 1);
      wg::mbar_init(&rempty[k], NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&sfull[k], 1);
      wg::mbar_init(&sempty[k], NCONS / 32);
    }
    wg::fence_mbar_init();
  }
  // zeros that no copy overwrites: taps kw .. 191 of every window stage,
  // and S's image past kw where warp 0 stores S
  const bool s_box = (2 * kw) % 16 == 0;
  for (int i = threadIdx.x; i < NS * (KP - kw) * 4; i += NTHR) {
    const int st = i / ((KP - kw) * 4), k = kw + i / 4 % (KP - kw);
    *reinterpret_cast<uint4*>(ringb + st * ROWB + wg::mn_chunk(SW, k, i % 4)) =
        make_uint4(0, 0, 0, 0);
  }
  if (!s_box)
    for (int i = threadIdx.x; i < 2 * TILE * (KP - kw); i += NTHR) {
      const int row = i / (KP - kw), k = kw + i % (KP - kw);
      *reinterpret_cast<__nv_bfloat16*>(slots + (row / TILE) * sbytes + s_byte(row % TILE, k)) =
          __float2bfloat16(0.f);
    }
  wg::fence_proxy_async();  // the zeros, before the products read them
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int npad = nrows + (nrows & 1);  // rows an item, even
  tc::wgc::TRing<NS, ROWB> rows{ringb, rfull, rempty};

  if (wgi == NCW) {
    wg::setmaxnreg_dec<REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid < 32) {
      // ---- warp 0: each item's S (and vm) into slot n % 2
      const uint32_t vbytes = kV ? TILE * dv * 4 : 0;
      if (s_box && lane == 0) tma::prefetch(&tm_s);
      int n = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
        const Item w(it, nt, nrg, ncp);
        const int sl = n & 1;
        uint8_t* img = slots + sl * sbytes;
        wg::mbar_wait(&sempty[sl], ((n >> 1) & 1) ^ 1);
        if (s_box) {
          if (lane == 0) {
            const int row0 = ((s_band ? w.ri * nt : 0) + w.tj) * TILE;
            wg::mbar_arrive_tx(&sfull[sl], SIMG + vbytes);
            for (int kb = 0; kb < 3; ++kb)
              tma::load_2d(img + kb * SBLK, &tm_s, 64 * kb, row0, &sfull[sl]);
          }
        } else {
          const __nv_bfloat16* st = s + w.ri * s_band + w.tj * s_tile;
          for (int i = lane; i < TILE * kw; i += 32)
            *reinterpret_cast<__nv_bfloat16*>(img + s_byte(i / kw, i % kw)) = st[i];
          __syncwarp();
          if (lane == 0) wg::mbar_arrive_tx(&sfull[sl], vbytes);
        }
        if (kV && lane == 0)
          wg::bulk_g2s(img + SIMG, vm + ((size_t)w.ri * nt * TILE + w.tj * TILE) * dv, vbytes,
                       &sfull[sl]);
      }
    } else if (ptid == 32) {
      // ---- the window rows, one box a ring stage
      tma::prefetch(&tm_src);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const Item w(it, nt, nrg, ncp);
        const int y0 = w.ri * B + j0 + w.rg * nrows;
        for (int j = 0; j < npad; ++j)
          rows.put(&tm_src, w.cp * NC, w.tj * TILE, y0 + j, kw * NC * 2);
      }
    }
    return;
  }

  // ---- the consumer warpgroups
  wg::setmaxnreg_inc<REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  const int g = lane / 4, t = lane % 4;
  const int o0 = 64 * wgi + 16 * warp + g;  // this thread's columns o0 and o0 + 8
  tc::wgc::TRing<NS, ROWB> done{ringb, rfull, rempty};  // the stages to release
  int n = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++n) {
    const int sl = n & 1;
    wg::mbar_wait(&sfull[sl], (n >> 1) & 1);
    const uint8_t* img = slots + sl * sbytes;
    uint32_t af[KS][4];
    {
      const int o = 64 * wgi + 16 * warp + lane % 16;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(af[ks], img + s_byte(o, 16 * ks + 8 * (lane / 16)));
    }
    const float* vms = reinterpret_cast<const float*>(img + SIMG);
    float osum[kV ? B : 1][16];
#pragma unroll
    for (int i = 0; i < (kV ? B : 1); ++i)
#pragma unroll
      for (int v = 0; v < 16; ++v) osum[i][v] = 0.f;

    // row j's products into a: the next stage, 12 k-steps, one commit group
    auto start_row = [&](float (&a)[16]) {
      const uint8_t* st = rows.wait();
#pragma unroll
      for (int v = 0; v < 16; ++v) a[v] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wg::hold(af[ks]);
      wg::hold(a);
      wg::fence();
      const uint64_t d0 = wg::desc_mn<SW>(st);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg::mma_bf16_n32_mn(a, af[ks], wg::desc_add(d0, ks * 16 * SW));
      wg::commit();
    };
    // row j's sums a are complete: release its stage, then use them. The
    // sums: a[4 q + 0, 1] column o0, channels 8 q + 2 t, + 1; a[4 q + 2, 3]
    // column o0 + 8
    auto finish = [&](float (&a)[16], int j) {
      wg::hold(a);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wg::hold(af[ks]);
      done.release();
      if constexpr (kV) {
#pragma unroll
        for (int v = 0; v < 16; ++v) a[v] = __bfloat162float(__float2bfloat16(a[v]));
#pragma unroll
        for (int i = 0; i < B; ++i) {
          const int d = j - i;
          if (d < 0 || d >= dv) continue;
          const float w0 = vms[o0 * dv + d], w1 = vms[(o0 + 8) * dv + d];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            osum[i][4 * q] = __fmaf_rn(a[4 * q], w0, osum[i][4 * q]);
            osum[i][4 * q + 1] = __fmaf_rn(a[4 * q + 1], w0, osum[i][4 * q + 1]);
            osum[i][4 * q + 2] = __fmaf_rn(a[4 * q + 2], w1, osum[i][4 * q + 2]);
            osum[i][4 * q + 3] = __fmaf_rn(a[4 * q + 3], w1, osum[i][4 * q + 3]);
          }
        }
      } else {
        if (j >= nrows) return;  // the padding row
        const Item w(wg::opaque(it), nt, nrg, ncp);
        const int c0 = w.cp * NC;
        __nv_bfloat16* row = out + ((size_t)(w.ri * B + w.rg * nrows + j) * wout + w.tj * TILE +
                                    o0) * c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = c0 + 8 * q + 2 * t;
          if (ch >= c) continue;
          *reinterpret_cast<__nv_bfloat162*>(row + ch) =
              __floats2bfloat162_rn(a[4 * q], a[4 * q + 1]);
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + ch) =
              __floats2bfloat162_rn(a[4 * q + 2], a[4 * q + 3]);
        }
      }
    };

    // two rows in flight, no guard around a wgmma: rows (j, j + 1) a step
    float acc0[16], acc1[16];
    start_row(acc0);
    for (int j = 0; j < npad - 2; j += 2) {
      start_row(acc1);
      wg::wait<1>();
      finish(acc0, j);
      start_row(acc0);
      wg::wait<1>();
      finish(acc1, j + 1);
    }
    start_row(acc1);
    wg::wait<1>();
    finish(acc0, npad - 2);
    wg::wait<0>();
    finish(acc1, npad - 1);

    // the slot (S's image, vm) is read
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sempty[sl]);

    const Item w(wg::opaque(it), nt, nrg, ncp);
    const int c0 = w.cp * NC;
    if constexpr (kV) {
#pragma unroll
      for (int i = 0; i < B; ++i) {
        __nv_bfloat16* row = out + ((size_t)(w.ri * B + i) * wout + w.tj * TILE + o0) * c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ch = c0 + 8 * q + 2 * t;
          if (ch >= c) continue;
          *reinterpret_cast<__nv_bfloat162*>(row + ch) =
              __floats2bfloat162_rn(osum[i][4 * q], osum[i][4 * q + 1]);
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * c + ch) =
              __floats2bfloat162_rn(osum[i][4 * q + 2], osum[i][4 * q + 3]);
        }
      }
    } else if (w.tj == nt - 1) {
      // the item's rows and channels of the columns past the tiles: zeros
      const int extra = wout - nt * TILE, ctid = threadIdx.x;
      for (int p = ctid; p < nrows * extra * (NC / 8); p += NCONS) {
        const int cj = p % (NC / 8), x = nt * TILE + (p / (NC / 8)) % extra;
        const int yo = w.ri * B + w.rg * nrows + p / (NC / 8) / extra, ch = c0 + 8 * cj;
        if (ch < c)
          *reinterpret_cast<uint4*>(out + ((size_t)yo * wout + x) * c + ch) =
              make_uint4(0, 0, 0, 0);
      }
    }
  }
}

}  // namespace ms
}  // namespace pnp

// src (1, hs, wsrc, c) bf16, c % 8 == 0; s (nb or 1, nt, 128, kw) bf16 with
// kw <= 192, read at s_band (0: one S for every band) and s_tile
// elements a band and a tile; out (1, 8 nb, wout, c) bf16.
// V mode (vm not null): vm (nb, wvm, dv) float32 with dv <= 40 and
// wout = wvm = 128 nt, H rows 0 .. dv + 6, rows_item 8. H mode (vm null): the
// H pass on rows j0 .. j0 + 7 of each band in groups of rows_item (1, 2, 4
// or 8; kernels/probes.py takes 2 at least) rows, wout >= 128 nt. grid: the persistent blocks, at most the
// items (kernels/probes.py: mmsel_schedule).
// The window of tile nt - 1 must lie inside src: 128 (nt - 1) + kw <= wsrc.
extern "C" int pnp_mmsel(const void* src, const void* s, const void* vm, void* out, int nb,
                         int nt, int hs, int wsrc, int c, int kw, long long s_band,
                         long long s_tile, int j0, int dv, int wout, int rows_item, int grid,
                         void* stream) {
  using namespace pnp::ms;
  const bool v_mode = vm != nullptr;
  if (nb < 1 || nt < 1 || c < 8 || c % 8 || kw < 2 || kw > KP || TILE * (nt - 1) + kw > wsrc ||
      wout < TILE * nt || rows_item < 1 || B % rows_item)
    return (int)cudaErrorInvalidValue;
  if (v_mode && (dv < 1 || dv > DVMAX || j0 != 0 || wout != TILE * nt || rows_item != B ||
                 B * (nb - 1) + dv + B - 1 > hs))
    return (int)cudaErrorInvalidValue;
  if (!v_mode && (j0 < 0 || B * nb + j0 > hs)) return (int)cudaErrorInvalidValue;
  const int nrg = v_mode ? 1 : B / rows_item, ncp = (c + NC - 1) / NC;
  const int nrows = v_mode ? dv + B - 1 : rows_item;
  const long long items = (long long)nb * nt * nrg * ncp;
  if (grid < 1 || grid > items || items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_src, tm_s;
  memset(&tm_s, 0, sizeof(tm_s));
  const uint64_t sdims[3] = {(uint64_t)c, (uint64_t)wsrc, (uint64_t)hs};
  const uint64_t sstr[2] = {(uint64_t)c * 2, (uint64_t)wsrc * c * 2};
  const uint32_t sbox[3] = {NC, (uint32_t)kw, 1};
  cudaError_t e = pnp::tma::encode(&tm_src, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, src, 3, sdims, sstr, sbox, SW);
  if (e == cudaSuccess && (2 * kw) % 16 == 0) {
    const uint64_t dims[2] = {(uint64_t)kw, (uint64_t)(s_band ? nb : 1) * nt * TILE};
    const uint64_t str[1] = {(uint64_t)kw * 2};
    const uint32_t box[2] = {64, TILE};
    e = pnp::tma::encode(&tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, 2, dims, str, box, 128);
  }
  if (e != cudaSuccess) return (int)e;
  const int bytes = smem(v_mode, v_mode ? dv : 0);
  auto k = v_mode ? mmsel_wg<true> : mmsel_wg<false>;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, NTHR, bytes, static_cast<cudaStream_t>(stream)>>>(
      tm_src, tm_s, static_cast<const __nv_bfloat16*>(s), static_cast<const float*>(vm),
      static_cast<__nv_bfloat16*>(out), c, kw, s_band, s_tile, j0, nrows, dv, wout, nt, nrg, ncp,
      (int)items);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one block in the V mode at the probe's dv = 40
extern "C" int pnp_mmsel_smem() { return pnp::ms::smem(true, pnp::ms::DVMAX); }
