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
// int8 (tapconv8_wg, on the same roles and rings): wgmma's s8 form
// (m64n64k32, int32 sums) reads B K-major only, and the weights lie (3, 3,
// cin, cout), cout contiguous. So each block keeps one 64-channel output
// part (kernels/probes.py: tapconv8_schedule makes the grid a multiple of
// the parts, so a block's items share one part) and transposes that part's
// weights once, before the roles split: 9 taps x cin x 64 int8 read from
// global memory four 8-byte rows at a time, turned by byte permutes into
// K-major 64-byte rows (64 input channels, two k-steps), 64-byte swizzled,
// resident for all the block's items (36 KB at 64 -> 64, 72 KB at 128 ->
// 128); the first two patch chunks are already on their way. The patch
// comes as 64-channel (64-byte) chunks, one tensor-map box each, 64-byte
// swizzled, into the two chunk buffers; a
// chunk's 9 taps x 2 k-steps run as one stream of commit groups with no
// drain at a tap (nothing to release: the weights stay). A is ldmatrix's
// b16 read of the int8 pairs, the m16n8k32 fragment layout that the s8
// form takes from registers. The epilogue computes float(sum) * s (the
// mma.sync design's arithmetic) into the swizzled output boxes and stores
// them with the TMA while the next item's products run, as the bf16 form.
// Up to cin 256 (the resident weights' room); above it, or where the
// schedule says nm = 0, int8 runs the mma.sync design (tapconv_kernel): a
// block of 8 warps, a 16 x 16 pixel tile by 64 output channels, the 18 x
// 18 x cin patch staged once, each tap's (cin, 64) weights transposed in
// turn.
//
// Bound: at the probe's 16 x 320 x 128 -> 128 it is 1.5 GFLOP (1.5 us in
// bf16 at 989 TFLOP/s, 0.76 us in int8) against 2.2 MB (0.66 us): near a
// launch, so the items are cut to fill the card. At K5's geometry (720 x
// 1280, 64 -> 64) 68 GFLOP, 69 us in bf16, against 0.36 GB of bf16
// features in and float32 out (107 us; int8 in, 88 us): bytes, the float32
// output two thirds of them (four fifths in int8); the chunk ring stages
// the next item's patch while the current one multiplies and stores.
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

// ---- int8: the wgmma design -----------------------------------------------------

namespace t8 {

using tc::wgc::NCONS;
using tc::wgc::NCW;
using tc::wgc::NTHR;
using tc::wgc::REG_CONS;
using tc::wgc::REG_PROD;
using tc::wgc::RW;
using tc::wgc::XW;

constexpr int PIX = 64;        // bytes of a pixel's staged chunk: 64 int8 channels
constexpr int WT = 64 * PIX;   // a (tap, chunk)'s weights: 64 output x 64 input channels
constexpr int NBAR = 4;
constexpr int MAX_CHUNKS = 4;  // cin 256 at most (nm 1; nm 2 takes 3)

template <int NM>
struct Geo {
  static constexpr int TH = 4 * NM;                           // output rows an item
  static constexpr int NX = (TH + 2) * XW;                    // staged patch pixels
  static constexpr int XB = (NX * PIX + 1023) / 1024 * 1024;  // a chunk buffer, 1024-aligned
  static constexpr int OB = 2 * NM * RW * 128;                // an output box, as tw::Geo's
};
// a block's dynamic shared memory with nch chunks of input: alignment
// slack, the resident weights, two chunk buffers, each warpgroup's two
// output boxes, the barriers (kernels/probes.py: tapconv8_schedule)
template <int NM>
__host__ __device__ constexpr int smem(int nch) {
  return 1024 + 9 * nch * WT + 2 * Geo<NM>::XB + 2 * NCW * Geo<NM>::OB + NBAR * 8;
}
static_assert(smem<1>(MAX_CHUNKS) <= TC_SMEM_MAX && smem<2>(3) <= TC_SMEM_MAX,
              "an int8 wgmma tap-conv block fits an SM's shared memory");

// pixel q's 16-byte piece j in a chunk buffer of 64-byte pixels, as the
// tensor map's 64-byte swizzle lays it (tma.cuh): conflict-free for
// ldmatrix over 8 consecutive pixels
__device__ __forceinline__ const uint8_t* xpiece(const uint8_t* buf, int q, int j) {
  return buf + q * PIX + ((j ^ ((q >> 1) & 3)) << 4);
}

// w (9, cin, cout) int8 -> the block's resident B: tile (tap, chunk ci) at
// wres + (tap nch + ci) WT, row n (output channel co0 + n) the 64 input
// channels 64 ci .. 64 ci + 63, 64-byte swizzled (wgmma.cuh: desc_sw64);
// zeros past cin and cout. A unit is 4 input x 8 output channels: four
// 8-byte loads (8 lanes read a row's 64 bytes), two 4 x 4 byte transposes,
// eight 4-byte stores, store s to column (s + n / 8) % 8, so that a warp's
// stores meet no bank twice. A thread loads SW_BATCH units before it
// stores any, so that their loads are in flight together.
constexpr int SW_BATCH = 6;
__device__ __forceinline__ void stage_weights(uint8_t* wres, const int8_t* __restrict__ w,
                                              int cin, int cout, int co0, int nch) {
  const int units = 9 * nch * 128;
  for (int u0 = threadIdx.x; u0 < units; u0 += SW_BATCH * NTHR) {
    uint2 r[SW_BATCH][4];
#pragma unroll
    for (int b = 0; b < SW_BATCH; ++b) {
      const int u = u0 + b * NTHR, tile = u / 128;
      const int n = 8 * (u % 8), k = 64 * (tile % nch) + 4 * ((u / 8) % 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[b][i] = (u < units && k + i < cin && co0 + n < cout)
                      ? __ldg(reinterpret_cast<const uint2*>(
                            w + ((size_t)(tile / nch) * cin + k + i) * cout + co0 + n))
                      : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < SW_BATCH; ++b) {
      const int u = u0 + b * NTHR;
      if (u >= units) break;
      const int n = 8 * (u % 8), kq = 4 * ((u / 8) % 16), tile = u / 128;
      // r[b][i] holds output channels n .. n + 7 of input channel k + i;
      // col[j] holds input channels k .. k + 3 of output channel n + j
      uint32_t col[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t x0 = h ? r[b][0].y : r[b][0].x, x1 = h ? r[b][1].y : r[b][1].x;
        const uint32_t x2 = h ? r[b][2].y : r[b][2].x, x3 = h ? r[b][3].y : r[b][3].x;
        const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
        const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
        col[4 * h] = __byte_perm(lo01, lo23, 0x5410);
        col[4 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
        col[4 * h + 2] = __byte_perm(hi01, hi23, 0x5410);
        col[4 * h + 3] = __byte_perm(hi01, hi23, 0x7632);
      }
#pragma unroll
      for (int st = 0; st < 8; ++st) {
        const int j = (st + n / 8) & 7, row = n + j;
        uint32_t v = col[0];
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (j == q) v = col[q];
        *reinterpret_cast<uint32_t*>(wres + tile * WT + row * PIX +
                                     (((kq >> 4) ^ ((row >> 1) & 3)) << 4) + (kq & 15)) = v;
      }
    }
  }
}

// The 9 taps of one 64-channel chunk xb for a warpgroup's NM M-tiles (rows
// at pixels base + 2 XW m + the tap's offset), 2 k-steps a tap, as one
// stream of 18 commit groups of NM products through two fragment buffers:
// a group loads its A while the one before multiplies and waits only for
// the group two back, which read the buffer it overwrites. B: the chunk's
// resident tile of each tap (wt, tap_bytes apart). Ends with every group
// complete. No wgmma sits behind a runtime guard.
template <int NM>
__device__ __forceinline__ void chunk_taps(int (&acc)[NM][32], const uint8_t* xb, int base,
                                           const uint8_t* wt, int tap_bytes) {
  const int half = (threadIdx.x % 32) / 16;
  uint32_t f[2][NM][4];
#pragma unroll
  for (int u = 0; u < 18; ++u) {
    const int tap = u / 2, ks = u % 2, off = (tap / 3) * XW + tap % 3;
    uint32_t(&cur)[NM][4] = f[u % 2];
    if (u >= 2) {  // the group two back has read this buffer
      wg::wait<1>();
#pragma unroll
      for (int m = 0; m < NM; ++m) wg::hold(cur[m]);
    }
#pragma unroll
    for (int m = 0; m < NM; ++m)
      ldmatrix_x4(cur[m], xpiece(xb, base + 2 * XW * m + off, 2 * ks + half));
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      wg::hold(cur[m]);
      wg::hold(acc[m]);
    }
    wg::fence();
    const uint64_t d = wg::desc_add(wg::desc_sw64(wt + tap * tap_bytes), ks * KSTEP_BYTES);
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::mma_s8(acc[m], cur[m], d);
    wg::commit();
  }
  wg::wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    wg::hold(acc[m]);
    wg::hold(f[0][m]);
    wg::hold(f[1][m]);
  }
}

// tm_band: the band (bh, bw, cin) int8 in boxes of (TH + 2) rows x 34 pixels
// x 64 channels, 64-byte swizzled; tm_out: out (rows, cols, cout) float32 as
// tw's. w (9, cin, cout) int8 in device memory, scale one float there.
// Item it: channel part it % ncp (blockIdx.x % ncp for all a block's items:
// gridDim.x % ncp == 0), tile it / ncp of ntx a tile row.
template <int NM>
__global__ void __launch_bounds__(NTHR, 1)
    tapconv8_wg(const __grid_constant__ CUtensorMap tm_band,
                const __grid_constant__ CUtensorMap tm_out, const int8_t* __restrict__ w,
                const float* __restrict__ scale, int cin, int cout, int ntx, int ncp, int items) {
  using G = Geo<NM>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nch = (cin + 63) / 64;  // 64-channel chunks of the input
  uint8_t* wres = tc::wgc::align1024(smem_raw);
  uint8_t* xs = wres + 9 * nch * WT;
  uint8_t* obox = xs + 2 * G::XB;  // warpgroup w's two output boxes at 2 w OB
  uint64_t* xfull = reinterpret_cast<uint64_t*>(obox + 2 * NCW * G::OB);  // two
  uint64_t* xempty = xfull + 2;                                            // two
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&xfull[k], 1);
      wg::mbar_init(&xempty[k], NCONS / 32);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();
  tc::wgc::XRing<G::XB> xr{xs, xfull, xempty};
  // ---- the producer thread's patch loads, a 64-channel chunk at a time in
  // (item, chunk) order: one box, 64-byte swizzled. The first two (their
  // buffers free) go out before the weights are staged.
  int pit = blockIdx.x, pci = 0;
  auto load_next = [&]() {
    uint8_t* dst = xr.claim();
    const int tt = pit / ncp, y0 = tt / ntx * G::TH, x0 = tt % ntx * RW;
    wg::mbar_arrive_tx(&xr.full[xr.g & 1], G::NX * PIX);
    tma::load_3d(dst, &tm_band, 64 * pci, x0, y0, &xr.full[xr.g & 1]);
    ++xr.g;
    if (++pci == nch) {
      pci = 0;
      pit += gridDim.x;
    }
  };
  if (threadIdx.x == NCONS) {
    tma::prefetch(&tm_band);
    tma::prefetch(&tm_out);
    while (xr.g < 2 && pit < items) load_next();
  }
  stage_weights(wres, w, cin, cout, 64 * (blockIdx.x % ncp), nch);
  wg::fence_proxy_async();  // the weights' stores, before the wgmma (async proxy) read them
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == NCW) {
    wg::setmaxnreg_dec<REG_PROD>();
    if (threadIdx.x == NCONS)
      while (pit < items) load_next();
    return;
  }

  // ---- the consumer warpgroups: M-tile m of warpgroup wgi is output rows
  // 2 (NM wgi + m), + 1 of the item
  wg::setmaxnreg_inc<REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  const float s = *scale;
  int acc[NM][32];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int p0 = 64 * NM * wgi + 16 * warp + lane % 16;
    const int base = (p0 / RW) * XW + p0 % RW;
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[m][k] = 0;
    for (int ci = 0; ci < nch; ++ci, ++xr.g) {
      chunk_taps<NM>(acc, xr.wait(), wg::opaque(base), wres + ci * WT, nch * WT);
      xr.release();
    }
    // the epilogue, as tw's: float(sum) * s into this warpgroup's two output
    // boxes, then one thread stores them (clipped at the edges) while the
    // next item's products run
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
              make_float2(__int2float_rn(acc[m][4 * j + 2 * hf]) * s,
                          __int2float_rn(acc[m][4 * j + 2 * hf + 1]) * s);
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

}  // namespace t8

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

// nm 1 or 2 (output rows an item 4 nm), grid the persistent blocks, a
// multiple of the 64-channel output parts and at most the items
// (kernels/probes.py: tapconv8_schedule)
inline cudaError_t launch_tapconv8_wg(const void* band, const void* w, const float* scale,
                                      void* out, int bh, int bw, int cin, int cout, int rows,
                                      int cols, int nm, int grid, cudaStream_t stream) {
  const int ntx = (cols + t8::RW - 1) / t8::RW, nty = (rows + 4 * nm - 1) / (4 * nm);
  const int ncp = (cout + 63) / 64, nch = (cin + 63) / 64;
  const long long items = (long long)ntx * nty * ncp;
  if ((nm != 1 && nm != 2) || grid < 1 || grid > items || grid % ncp || items > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int smem = nm == 1 ? t8::smem<1>(nch) : t8::smem<2>(nch);
  if (smem > TC_SMEM_MAX) return cudaErrorInvalidValue;
  CUtensorMap tm_band, tm_out;
  const uint64_t bdims[3] = {(uint64_t)cin, (uint64_t)bw, (uint64_t)bh};
  const uint64_t bstr[2] = {(uint64_t)cin, (uint64_t)bw * cin};
  const uint32_t bbox[3] = {64, (uint32_t)t8::XW, (uint32_t)(4 * nm + 2)};
  const uint64_t odims[3] = {(uint64_t)cout, (uint64_t)cols, (uint64_t)rows};
  const uint64_t ostr[2] = {(uint64_t)cout * 4, (uint64_t)cols * cout * 4};
  const uint32_t obox[3] = {32, (uint32_t)t8::RW, (uint32_t)(2 * nm)};
  cudaError_t e = tma::encode(&tm_band, CU_TENSOR_MAP_DATA_TYPE_UINT8, band, 3, bdims, bstr,
                              bbox, 64);
  if (e == cudaSuccess)
    e = tma::encode(&tm_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, 3, odims, ostr, obox, 128);
  if (e != cudaSuccess) return e;
  auto k = nm == 1 ? t8::tapconv8_wg<1> : t8::tapconv8_wg<2>;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  k<<<grid, t8::NTHR, smem, stream>>>(tm_band, tm_out, static_cast<const int8_t*>(w), scale, cin,
                                      cout, ntx, ncp, (int)items);
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
// float in device memory: nm 1 or 2 the wgmma design (nm and grid from
// kernels/probes.py: tapconv8_schedule), nm 0 the mma.sync design (cin above
// the resident weights' room; grid unused). out (rows, cols, cout) float32.
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
    return nm ? (int)pnp::launch_tapconv8_wg(band, w, s, out, bh, bw, cin, cout, rows, cols, nm,
                                             grid, st)
              : (int)pnp::launch_tapconv<int8_t>(band, w, s, out, bh, bw, cin, cout, rows, cols,
                                                 st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one bf16 block at the probe's 16 x 320 (nm 1)
extern "C" int pnp_tapconv_smem() { return pnp::tw::smem<1>(); }
// dynamic shared memory of one int8 block at the probe's 16 x 320 x 128 -> 128
// (nm 1, two chunks)
extern "C" int pnp_tapconv8_smem() { return pnp::t8::smem<1>(2); }
