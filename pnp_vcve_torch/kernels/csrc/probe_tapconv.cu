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
// x (C, C) matmul on strided slices of it. Here the taps are 9 shifted
// products over a patch staged in shared memory (implicit GEMM: a pixel's
// channels are the rows of the A fragments, so a shift by a tap is an
// address offset, not a copy).
//
// bf16 (tapconv_wg, on wg_conv.cuh's pieces): a block of two consumer
// warpgroups and one producer warpgroup, one an SM, persistent over items
// of (4 NM rows x 32 columns of output pixels, 64 output channels), the
// channel part fastest (kernels/probes.py: tapconv_schedule picks NM = 2,
// or 1 where the NM = 2 items would leave SMs idle, as at the probe's 16 x
// 320, and mirrors the walk). One producer thread copies the item's (4 NM
// + 2) x 34 patch, 64 input channels (128 bytes) a chunk, as one
// tensor-map box (tma.cuh) into the two chunk buffers (XRing), pixel-
// swizzled as wg_conv.cuh: xpiece reads it; another copies each (chunk,
// tap)'s 64 x 64 weights as one box straight from the (3, 3, cin, cout)
// tensor, MN-major (cout contiguous, 128-byte swizzled), into a ring of 6
// stages (TRing); no repacking, and the boxes' zeros past the band, cin
// and cout. The consumers run a chunk's 9 taps as one stream of wgmma
// m64n64k16 groups (chunk_taps: conv_stage's two fragment buffers without
// its drain at every tap): A from the chunk by ldmatrix at the tap's
// offset, B through an MN-major descriptor, 64 x NM rows a warpgroup. The epilogue writes each
// warpgroup's sums into two swizzled output boxes in shared memory and one
// of its threads stores them with the TMA, clipped at the tensor's edges,
// while the next item's products run: the float32 output, two thirds of
// the bytes at K5's geometry, leaves the consumers' critical path.
//
// int8 keeps the mma.sync design (tapconv_kernel): wgmma's s8 form reads B
// K-major only, so the (cin, cout) weights would need a transpose while
// staging. A block of 8 warps computes a 16 x 16 pixel tile by 64 output
// channels on mma.sync; the 18 x 18 x cin patch is staged once, each tap's
// (cin, 64) weights transposed in turn.
//
// Bound: at the probe's 16 x 320 x 128 -> 128 it is 1.5 GFLOP (1.5 us in
// bf16 at 989 TFLOP/s, 0.76 us in int8) against 2.2 MB (0.66 us): near a
// launch, so the items are cut to fill the card. At K5's geometry (720 x
// 1280, 64 -> 64) 68 GFLOP, 69 us in bf16, against 0.36 GB of bf16
// features in and float32 out (107 us): bytes, the float32 output two
// thirds of them; the chunk ring stages the next item's patch while the
// current one multiplies and stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk.cuh"
#include "wg_conv.cuh"

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

// the mma.sync design, int8 only
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

// ---- bf16: the wgmma design ----------------------------------------------------

namespace tw {

using tc::wgc::CHB;
using tc::wgc::NCONS;
using tc::wgc::NCW;
using tc::wgc::NTHR;
using tc::wgc::REG_CONS;
using tc::wgc::REG_PROD;
using tc::wgc::RW;
using tc::wgc::XW;

constexpr int NS = 6;          // weight stages
constexpr int WST = 64 * 128;  // a stage: 64 input x 64 output channels, bf16
constexpr int NBAR = 2 * NS + 4;

template <int NM>
struct Geo {
  static constexpr int TH = 4 * NM;                    // output rows an item
  static constexpr int NX = (TH + 2) * XW;             // staged patch pixels
  static constexpr int XB = (NX * CHB + 1023) / 1024 * 1024;  // a chunk buffer, 1024-aligned
  static constexpr int OB = 2 * NM * RW * 128;         // an output box: a warpgroup's rows x 32
                                                       // pixels x 32 float32 channels
};
// a block's dynamic shared memory: alignment slack, the weight ring, two
// chunk buffers, each warpgroup's two output boxes, the barriers
// (kernels/probes.py: tapconv_schedule)
template <int NM>
__host__ __device__ constexpr int smem() {
  return 1024 + NS * WST + 2 * Geo<NM>::XB + 2 * NCW * Geo<NM>::OB + NBAR * 8;
}
static_assert(smem<2>() <= TC_SMEM_MAX, "a wgmma tap-conv block fits an SM's shared memory");

using WRing = tc::wgc::TRing<NS, WST>;

// The 9 taps of one 64-channel chunk xb for a warpgroup's NM M-tiles (rows
// at pixels base + 2 XW m + the tap's offset), as one stream of commit
// groups, a tap's k-step each (NM products), through two fragment buffers
// as wg_conv.cuh: conv_stage runs a stage, but without its drain at every
// tap: tap t's weight stage is released at the wait that sees tap t's last
// group complete, while tap t + 1's products run. Ends with every group
// complete. No wgmma sits behind a runtime guard (tap 0 is peeled).
template <int NM>
__device__ __forceinline__ void chunk_taps(float (&acc)[NM][32], const uint8_t* xb, int base,
                                           WRing& wr, WRing& wdone) {
  using Frag = tc::wgc::AFrag<__nv_bfloat16, NM>;
  const int half = (threadIdx.x % 32) / 16;
  Frag f[2];
  auto group = [&](const uint8_t* st, int off, int ks, Frag& cur) {
#pragma unroll
    for (int m = 0; m < NM; ++m)
      ldmatrix_x4(cur.a[m], tc::wgc::xpiece(xb, base + 2 * XW * m + off, 2 * ks + half));
    cur.hold();
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
    wg::fence();
    const uint64_t d = wg::desc_add(wg::desc_mn<128>(st), ks * 16 * 128);
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::mma_bf16_mn(acc[m], cur.a[m], d);
    wg::commit();
  };
  auto step = [&](Frag& cur) {  // the group two back, which read cur, is done
    wg::wait<1>();
    cur.hold();
  };
  const uint8_t* st = wr.wait();
  group(st, 0, 0, f[0]);
  group(st, 0, 1, f[1]);
  step(f[0]);
  group(st, 0, 2, f[0]);
  step(f[1]);
  group(st, 0, 3, f[1]);
#pragma unroll 1
  for (int tap = 1; tap < 9; ++tap) {
    const int off = (tap / 3) * XW + tap % 3;
    st = wr.wait();
    step(f[0]);
    group(st, off, 0, f[0]);
    step(f[1]);
    wdone.release();  // tap - 1's last group is complete
    group(st, off, 1, f[1]);
    step(f[0]);
    group(st, off, 2, f[0]);
    step(f[1]);
    group(st, off, 3, f[1]);
  }
  wg::wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
  f[0].hold();
  f[1].hold();
  wdone.release();
}

// tm_band: the band (bh, bw, cin) in boxes of (TH + 2) rows x 34 pixels x 64
// channels, tm_w: w (9, cin, cout) in boxes of 64 x 64, tm_out: out (rows,
// cols, cout) float32 in boxes of 2 NM rows x 32 pixels x 32 channels, all
// 128-byte swizzled. Item it: channel part it % ncp, tile it / ncp of ntx a
// tile row.
template <int NM>
__global__ void __launch_bounds__(NTHR, 1)
    tapconv_wg(const __grid_constant__ CUtensorMap tm_band, const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_out, int cin, int cout, int ntx, int ncp,
               int items) {
  using G = Geo<NM>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = tc::wgc::align1024(smem_raw);
  uint8_t* xs = ringb + NS * WST;
  uint8_t* obox = xs + 2 * G::XB;  // warpgroup w's two output boxes at 2 w OB
  uint64_t* full = reinterpret_cast<uint64_t*>(obox + 2 * NCW * G::OB);
  uint64_t* empty = full + NS;
  uint64_t* xfull = empty + NS;  // two
  uint64_t* xempty = xfull + 2;  // two
  if (threadIdx.x == 0) {
    for (int k = 0; k < NS; ++k) {
      wg::mbar_init(&full[k], 1);
      wg::mbar_init(&empty[k], NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&xfull[k], 1);
      wg::mbar_init(&xempty[k], NCONS / 32);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int nch = (cin + 63) / 64;  // 64-channel chunks of the input
  const int lane = threadIdx.x % 32;
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  WRing wr{ringb, full, empty};
  tc::wgc::XRing<G::XB> xr{xs, xfull, xempty};

  if (wgi == NCW) {
    wg::setmaxnreg_dec<REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid == 0) {
      // ---- each (chunk, tap)'s weights: one box, MN-major
      tma::prefetch(&tm_w);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int co0 = 64 * (it % ncp);
        for (int ci = 0; ci < nch; ++ci)
          for (int tap = 0; tap < 9; ++tap) wr.put(&tm_w, co0, 64 * ci, tap, WST);
      }
    } else if (ptid == 32) {
      // ---- the patch, a 64-channel chunk at a time: one box, pixel-swizzled
      tma::prefetch(&tm_band);
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int tt = it / ncp, y0 = tt / ntx * G::TH, x0 = tt % ntx * RW;
        for (int ci = 0; ci < nch; ++ci, ++xr.g) {
          uint8_t* dst = xr.claim();
          wg::mbar_arrive_tx(&xr.full[xr.g & 1], G::NX * CHB);
          tma::load_3d(dst, &tm_band, 64 * ci, x0, y0, &xr.full[xr.g & 1]);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups: M-tile m of warpgroup wgi is output rows
  // 2 (NM wgi + m), + 1 of the item
  wg::setmaxnreg_inc<REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  WRing wdone{ringb, full, empty};  // the weight stages to release
  float acc[NM][32];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int p0 = 64 * NM * wgi + 16 * warp + lane % 16;
    const int base = (p0 / RW) * XW + p0 % RW;
    tc::wgc::zero(acc);
    for (int ci = 0; ci < nch; ++ci, ++xr.g) {
      chunk_taps<NM>(acc, xr.wait(), wg::opaque(base), wr, wdone);
      xr.release();
    }
    // the epilogue: the sums into this warpgroup's two output boxes (line
    // r = its pixel 64 m + 16 warp + g (+ 8), channel 8 j + 2 t (+ 1) in
    // box j / 4), then one thread stores the boxes (clipped at the edges)
    // while the next item's products run
    const int ln = wg::opaque(lane), gq = ln / 4, t4 = ln % 4;
    uint8_t* ob = obox + 2 * wgi * G::OB;
    const bool leader = threadIdx.x % 128 == 0;
    if (leader) bulk::wait_read<0>();  // the last item's stores have read the boxes
    wg::named_sync(1 + wgi, 128);
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 64 * m + 16 * warp + gq + 8 * hf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int chunk = 2 * (j % 4) + t4 / 2;
          *reinterpret_cast<float2*>(ob + (j / 4) * G::OB + r * 128 + ((chunk ^ (r % 8)) << 4) +
                                     (t4 % 2) * 8) =
              make_float2(acc[m][4 * j + 2 * hf], acc[m][4 * j + 2 * hf + 1]);
        }
      }
    wg::fence_proxy_async();
    wg::named_sync(1 + wgi, 128);
    if (leader) {
      const int tt = wg::opaque(it);
      const int co0 = 64 * (tt % ncp), y = tt / ncp / ntx * G::TH + 2 * NM * wgi;
      const int x0 = tt / ncp % ntx * RW;
      tma::store_3d(&tm_out, co0, x0, y, ob);
      if (co0 + 32 < cout) tma::store_3d(&tm_out, co0 + 32, x0, y, ob + G::OB);
      bulk::commit();
    }
  }
  if (threadIdx.x % 128 == 0) tma::store_wait_all();
}

}  // namespace tw

// nm 1 or 2 (output rows an item 4 nm), grid the persistent blocks, at most
// the items (kernels/probes.py: tapconv_schedule)
inline cudaError_t launch_tapconv_wg(const void* band, const void* w, void* out, int bh, int bw,
                                     int cin, int cout, int rows, int cols, int nm, int grid,
                                     cudaStream_t stream) {
  const int ntx = (cols + tw::RW - 1) / tw::RW, nty = (rows + 4 * nm - 1) / (4 * nm);
  const int ncp = (cout + 63) / 64;
  const long long items = (long long)ntx * nty * ncp;
  if ((nm != 1 && nm != 2) || grid < 1 || grid > items || items > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap tm_band, tm_w, tm_out;
  const uint64_t bdims[3] = {(uint64_t)cin, (uint64_t)bw, (uint64_t)bh};
  const uint64_t bstr[2] = {(uint64_t)cin * 2, (uint64_t)bw * cin * 2};
  const uint32_t bbox[3] = {64, (uint32_t)tw::XW, (uint32_t)(4 * nm + 2)};
  const uint64_t wdims[3] = {(uint64_t)cout, (uint64_t)cin, 9};
  const uint64_t wstr[2] = {(uint64_t)cout * 2, (uint64_t)cin * cout * 2};
  const uint32_t wbox[3] = {64, 64, 1};
  const uint64_t odims[3] = {(uint64_t)cout, (uint64_t)cols, (uint64_t)rows};
  const uint64_t ostr[2] = {(uint64_t)cout * 4, (uint64_t)cols * cout * 4};
  const uint32_t obox[3] = {32, (uint32_t)tw::RW, (uint32_t)(2 * nm)};
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t e = tma::encode(&tm_band, bf16, band, 3, bdims, bstr, bbox, 128);
  if (e == cudaSuccess) e = tma::encode(&tm_w, bf16, w, 3, wdims, wstr, wbox, 128);
  if (e == cudaSuccess)
    e = tma::encode(&tm_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, 3, odims, ostr, obox, 128);
  if (e != cudaSuccess) return e;
  auto k = nm == 1 ? tw::tapconv_wg<1> : tw::tapconv_wg<2>;
  const int smem = nm == 1 ? tw::smem<1>() : tw::smem<2>();
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, tw::NTHR, smem, stream>>>(tm_band, tm_w, tm_out, cin, cout, ntx, ncp, (int)items);
  return cudaGetLastError();
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

// dtype 1: bf16 band and w, scale null: the wgmma design, nm and grid from
// kernels/probes.py: tapconv_schedule. dtype 2: int8 band and w, scale a
// float in device memory: the mma.sync design (nm and grid unused). out
// (rows, cols, cout) float32.
extern "C" int pnp_tapconv(int dtype, const void* band, const void* w, const void* scale,
                           void* out, int bh, int bw, int cin, int cout, int rows, int cols,
                           int nm, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  if (rows <= 0 || cols <= 0 || bh < rows + 2 || bw < cols + 2 || cout <= 0 || cout % 8)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && cin > 0 && cin % 16 == 0 && !s)
    return (int)pnp::launch_tapconv_wg(band, w, out, bh, bw, cin, cout, rows, cols, nm, grid,
                                       st);
  if (dtype == 2 && cin > 0 && cin % 32 == 0 && s)
    return (int)pnp::launch_tapconv<int8_t>(band, w, s, out, bh, bw, cin, cout, rows, cols, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one bf16 block at the probe's 16 x 320 (nm 1)
extern "C" int pnp_tapconv_smem() { return pnp::tw::smem<1>(); }
