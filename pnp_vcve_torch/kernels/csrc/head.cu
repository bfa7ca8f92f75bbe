// K4: the reconstruction head, y = conv3x3(lrelu_0.1(conv3x3(x; W_hr) + b_hr); W_last) + b_last,
// c -> c -> 3 channels. The caller adds lr.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: head_pf (:1058,
// pallas_call :1089, kernel _head_kernel :977). Same two-stage structure as
// the DRT block (K3): stage 1 computes the c-channel hidden map on the
// output tile plus a 1-pixel halo, zeroed outside the image (conv_last's
// zero padding), and stage 2 reduces it to 3 channels without it leaving
// the chip. The hidden map stays float32 in both types, and W_hr keeps two
// terms in both: the 3xTF32 head and tail (float32), or bf16_split's hi +
// lo (bfloat16; x is bf16 already, so the two products keep W_hr to ~16
// bits). With one bf16 term the head's mean error against float32 was
// 0.85-0.99 of its parity bound (0.002 std) in an emulation of this
// arithmetic (tests/test_torch_port_tc_head.py).
//
// Bound (c = 64, 720p): 71.1 GFLOP a frame, 0.072 ms on the bf16 tensor
// cores, 0.431 ms in 3xTF32; its bytes 0.037-0.074 ms.
//
// Two designs, picked by the width (launch_head; launch.kernel_design says
// the same for the wrapper's weight layout):
//
// c = 64, every model path's width: head_wg, wgmma on both stages
// (wg_conv.cuh).
//   - Tile: K3's (drt_block_wg): a 14 x 30 output tile, stage 1 on its 16 x
//     32 region (512 rows, 1.22x the outputs; the mma.sync tile's 10 x 18
//     region padded to 192 rows was 1.5x), 4 M-tiles a consumer warpgroup,
//     the staged x tile 18 x 34 pixels of 128-byte chunks.
//   - Stage 1: W_hr's nine taps over each chunk of x (bf16 one of 64
//     channels, two products a k-step, lo then hi; float32 two of 32, three
//     TF32 products), one ring stage a tap and chunk, 16 KB (the two terms)
//     each, a ring of 3 stages: 9 (bf16) / 18 (float32) stages a tile, 3.3x
//     fewer weight bytes an output than the 8 x 16 tile. 576 terms a sum,
//     no split (K3's stage 1 takes 768 without one). The hidden map h =
//     lrelu(sums + b_hr), zero outside the image, stays in the sum
//     registers, float32.
//   - Stage 2 (c -> 3) on the tensor cores as one small GEMM: Z = h W',
//     512 x 64 by 64 x 32, W' the (tap, output) pairs of W_last as columns
//     (27 used), m64n32k8 in 3xTF32 (h split in registers, W' by the
//     wrapper) in both types, so it keeps float32's accuracy. A comes
//     straight from the sum registers: a k-step's A fragment is a sum
//     fragment with its 8 channels taken in the order 0 2 4 6 1 3 5 7, and
//     the wrapper permutes W''s rows the same way (head_last_image). Z (512
//     x 36 floats) goes to shared memory over the x chunk stage 1 last read,
//     and y = b_last + sum_tap Z[pixel + tap][tap] is a gather of 27 values
//     an output. Stage 2 is 1/21 of the head's work: 96 m64n32k8 a
//     warpgroup and tile against 288 (bf16) / 864 (float32) m64n64 products
//     of stage 1; the CUDA-core stage 2 of the mma.sync design loaded one
//     scalar and one float4 from shared memory a multiply-add triple.
//   - Weights: the wrapper's images (drt_stack.wg_image of W_hr's two
//     terms; W' resident, 16 KB, loaded once a block with one bulk copy).
//   - x: two chunk buffers; Z lies over the buffer of the tile's last
//     chunk, which is released after the gather. bf16 (one chunk a tile):
//     tile i + 1's x lands in the other buffer while tile i runs; float32:
//     tile i + 1's first chunk lands once tile i's first is done, its second
//     once tile i's gather is.
//   - Shared memory: 223,320 bytes in both types (hd_wg_smem).
//
// Other widths (8, 128, the two-launch 192): head_tc, stage 1 on K2's GEMM
// loop (tc_conv.cuh: conv_tc) over the 10 x 18 halo region: an implicit
// GEMM on the tensor cores (mma.sync) whose 180 rows are padded to 12 row
// tiles (3 a warp), whose columns are the output groups of 64 hidden
// channels (the block runs every group: stage 2 reads all of them) and
// whose depth is W_hr's nine taps over x's input chunks, through the
// cp.async rings; its epilogue adds b_hr, applies the leaky ReLU and writes
// the hidden map, float32, channel-major, zero outside the image. At c <=
// 64 (NARROW) the hidden map overwrites the x chunk buffers once stage 1 is
// done, and two blocks run on an SM. Stage 2, c -> 3, runs on the CUDA
// cores: each output pixel's channels are split between two threads, one
// LDS.128 of W_last (padded to four floats) a channel, and their halves are
// joined through shared memory. It also runs at 64 channels through
// pnp_head_mma_sync, the yardstick chip_smoke.py times the wgmma design
// against.
//
// Two-launch form. Above the one-launch width (HD_ONE_LAUNCH_*) the hidden map
// does not fit: the wrapper passes a float32 (b, h, w, c) scratch and the
// head runs as two launches, head_hidden_tc (conv_tc over the output tile,
// one output group a block, the same epilogue into the scratch) and
// head_last_kernel (stage 2 over the scratch, staged back in chunks of 64
// channels with W_last's rows for them).
#include "tc_conv.cuh"
#include "wg_conv.cuh"

namespace pnp {
namespace tc {

constexpr int HD_CO = 3;   // output channels
constexpr int HD_NW = 2;   // W_hr's tiles a step: TF32 head and tail, or bf16 hi and lo
using HR = Region<1>;      // stage 1: the 10 x 18 hidden region
constexpr int HD_PIX = TILE_H * TILE_W;  // output pixels of a block (stage 2: two threads each)
static_assert(NTHR == 2 * HD_PIX, "stage 2 splits each pixel's channels between two threads");

// dynamic shared memory of a one-launch block at width c (elt: the feature
// type's bytes): the x chunk buffers (two where c takes more than one
// chunk) and the float32 hidden map (NARROW: one over the other), the weight
// ring and W_last as (9, c) float4
__host__ __device__ constexpr size_t head_smem(int c, int elt) {
  const int kc = elt == 2 ? Operand<__nv_bfloat16>::KC : Operand<float>::KC;
  const size_t xbytes = (size_t)(cdiv(c, kc) > 1 ? 2 : 1) * HR::NA * PITCH;
  const size_t hbytes = sizeof(float) * c * HR::NR;
  return (c <= NB ? (xbytes > hbytes ? xbytes : hbytes) : xbytes + hbytes) +
         (size_t)2 * HD_NW * WTILE + sizeof(float4) * 9 * c;
}
static_assert(head_smem(NB, 4) <= SMEM_MAX / 2 && head_smem(NB, 2) <= SMEM_MAX / 2,
              "two narrow blocks fit an SM");
// the widest one-launch block that fits, per feature type (launch.ONE_LAUNCH_WIDTH)
constexpr int HD_ONE_LAUNCH_F32 = 144;
constexpr int HD_ONE_LAUNCH_BF16 = 144;
static_assert(head_smem(HD_ONE_LAUNCH_F32, 4) <= SMEM_MAX &&
                  head_smem(HD_ONE_LAUNCH_F32 + PN, 4) > SMEM_MAX,
              "HD_ONE_LAUNCH_F32 is the widest one-launch block that fits");
static_assert(head_smem(HD_ONE_LAUNCH_BF16, 2) <= SMEM_MAX &&
                  head_smem(HD_ONE_LAUNCH_BF16 + PN, 2) > SMEM_MAX,
              "HD_ONE_LAUNCH_BF16 is the widest one-launch block that fits");
// the two-launch form: launch 1 as K5 (two chunk buffers, the weight ring);
// launch 2 a hidden chunk, W_last's rows for it and the halves' sums
constexpr size_t HH_SMEM = conv_tc_smem(HD_NW);
constexpr size_t HL_SMEM = sizeof(float) * NB * HR::NR + sizeof(float4) * 9 * NB +
                           sizeof(float) * HD_CO * HD_PIX;

// W_last (9 c, 3) float32 into wl as (9 c) float4, the fourth lane zero
__device__ __forceinline__ void stage_wlast(float4* wl, const float* wlast, int rows) {
  for (int i = threadIdx.x; i < rows; i += NTHR)
    wl[i] = make_float4(wlast[3 * i], wlast[3 * i + 1], wlast[3 * i + 2], 0.f);
}

// Stage 2's part of this thread: output pixel p = t % 128 of the tile, the
// half j = t / 128 of the kc channels of a channel-major hidden chunk hs
// (HR::NR pixels a channel), wl its W_last rows (9, kc) as float4.
__device__ __forceinline__ void last_sums(float (&o)[HD_CO], const float* hs, const float4* wl,
                                          int kc) {
  const int p = threadIdx.x % HD_PIX, half = kc / 2, c0 = threadIdx.x / HD_PIX * half;
  const int base = (p / TILE_W) * HR::RW + p % TILE_W;
  for (int tap = 0; tap < 9; ++tap) {
    const float* row = hs + base + (tap / 3) * HR::RW + tap % 3;
    const float4* wt = wl + tap * kc;
#pragma unroll 4
    for (int ci = c0; ci < c0 + half; ++ci) {
      const float v = row[ci * HR::NR];
      const float4 q = wt[ci];
      o[0] = fmaf(v, q.x, o[0]);
      o[1] = fmaf(v, q.y, o[1]);
      o[2] = fmaf(v, q.z, o[2]);
    }
  }
}

// The two halves of each pixel's sums joined through red (3 x 128 floats),
// + b_last, stored as T by the first half's threads.
template <typename T>
__device__ __forceinline__ void last_store(const float (&o)[HD_CO], float* red,
                                           const float* blast, T* out, int h, int w, int y0,
                                           int x0, size_t img) {
  const int p = threadIdx.x % HD_PIX;
  if (threadIdx.x >= HD_PIX)
#pragma unroll
    for (int k = 0; k < HD_CO; ++k) red[k * HD_PIX + p] = o[k];
  __syncthreads();
  const int y = y0 + p / TILE_W, xx = x0 + p % TILE_W;
  if (threadIdx.x >= HD_PIX || y >= h || xx >= w) return;
  T* dst = out + (img + (size_t)y * w + xx) * HD_CO;
#pragma unroll
  for (int k = 0; k < HD_CO; ++k) dst[k] = from_f<T>(o[k] + red[k * HD_PIX + p] + blast[k]);
}

// Weights (the wrapper's layout): whr (2, 9, c, c) in x's type, each tap
// transposed (out, in), the two terms of each weight; bhr (c,), wlast (9,
// c, 3), blast (3,) float32.
template <typename T, bool NARROW>
__global__ void __launch_bounds__(NTHR, NARROW ? 2 : 1)
    head_tc(const T* __restrict__ x, const T* __restrict__ whr, const float* __restrict__ bhr,
            const float* __restrict__ wlast, const float* __restrict__ blast, T* __restrict__ out,
            int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  const size_t xbytes = (size_t)(cdiv(c, Operand<T>::KC) > 1 ? 2 : 1) * HR::NA * PITCH;
  const size_t hbytes = sizeof(float) * c * HR::NR;
  uint8_t* xb = smem;  // x chunk buffers
  float* hs = reinterpret_cast<float*>(NARROW ? smem : smem + xbytes);  // c x NR hidden map
  uint8_t* wb = smem + (NARROW ? (xbytes > hbytes ? xbytes : hbytes) : xbytes + hbytes);
  float4* wl = reinterpret_cast<float4*>(wb + 2 * HD_NW * WTILE);  // W_last (9, c)

  const int b = blockIdx.z, y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;
  stage_wlast(wl, wlast, 9 * c);  // published by the first step's __syncthreads
  const ConvIn<T> in[1] = {{x, whr, c, c}};
  // ---- stage 1: the hidden map on the tile and its halo, every group
  conv_tc<T, 1, HD_NW, !NARROW>(
      in, 1, false, 1, b, h, w, c, 0, cdiv(c, NB), xb, wb, [&](int co0, auto& acc) {
        if (NARROW) __syncthreads();  // every warp is done with the x tile h overwrites
        for_each_pair<HR::MT>(acc, [&](int p, int col, float& v0, float& v1) {
          const int n = co0 + col;
          if (p >= HR::NR || n >= c) return;
          const int y = y0 - 1 + p / HR::RW, xx = x0 - 1 + p % HR::RW;
          const bool inside = y >= 0 && y < h && xx >= 0 && xx < w;
          hs[n * HR::NR + p] = inside ? lrelu(v0 + bhr[n]) : 0.f;
          hs[(n + 1) * HR::NR + p] = inside ? lrelu(v1 + bhr[n + 1]) : 0.f;
        });
      });
  __syncthreads();
  // ---- stage 2: c -> 3 on the CUDA cores (the weight ring holds the halves' sums)
  float o[HD_CO] = {0.f, 0.f, 0.f};
  last_sums(o, hs, wl, c);
  last_store<T>(o, reinterpret_cast<float*>(wb), blast, out, h, w, y0, x0, img);
}

// Launch 1 of the two-launch form: hbuf = lrelu_0.1(conv3x3(x; W_hr) + b_hr)
// on the output tile, float32, one output group a block (grid z: samples x
// groups).
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    head_hidden_tc(const T* __restrict__ x, const T* __restrict__ whr,
                   const float* __restrict__ bhr, float* __restrict__ hbuf, int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ngr = cdiv(c, NB), b = blockIdx.z / ngr, g = blockIdx.z % ngr;
  const size_t img = (size_t)b * h * w;
  const ConvIn<T> in[1] = {{x, whr, c, c}};
  conv_tc<T, 0, HD_NW, true>(
      in, 1, false, 1, b, h, w, c, g, g + 1, smem, smem + 2 * Region<0>::NA * PITCH,
      [&](int co0, auto& acc) {
        for_each_out_pair(acc, co0, c, h, w, [&](size_t px, int n, float v0, float v1) {
          store2(hbuf + (img + px) * c + n, lrelu(v0 + bhr[n]), lrelu(v1 + bhr[n + 1]));
        });
      });
}

// Launch 2: out = conv3x3(hbuf; W_last) + b_last, stage 2 over the hidden
// map staged in chunks of 64 channels (zeros outside the image: conv_last's
// padding) with W_last's rows for the chunk.
template <typename T>
__global__ void __launch_bounds__(NTHR, 2)
    head_last_kernel(const float* __restrict__ hbuf, const float* __restrict__ wlast,
                     const float* __restrict__ blast, T* __restrict__ out, int h, int w, int c) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* hs = reinterpret_cast<float*>(smem);              // NB x NR hidden chunk
  float4* wl = reinterpret_cast<float4*>(hs + NB * HR::NR);  // (9, NB) rows of W_last
  float* red = reinterpret_cast<float*>(wl + 9 * NB);       // the halves' sums
  const int b = blockIdx.z, y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  const size_t img = (size_t)b * h * w;
  float o[HD_CO] = {0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < c; c0 += NB) {
    const int kc = imin(NB, c - c0);
    __syncthreads();  // every thread is done with the previous chunk
    // 8 channels of a pixel a thread (two float4 loads), consecutive
    // threads on consecutive pixels: the channel-major stores do not conflict
    for (int i = threadIdx.x; i < HR::NR * (kc / PN); i += NTHR) {
      const int p = i % HR::NR, v = i / HR::NR;
      const int y = y0 - 1 + p / HR::RW, xx = x0 - 1 + p % HR::RW;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a;
      if (y >= 0 && y < h && xx >= 0 && xx < w) {
        const float4* src =
            reinterpret_cast<const float4*>(hbuf + (img + (size_t)y * w + xx) * c + c0 + v * PN);
        a = src[0];
        d = src[1];
      }
      const float vals[PN] = {a.x, a.y, a.z, a.w, d.x, d.y, d.z, d.w};
#pragma unroll
      for (int k = 0; k < PN; ++k) hs[(v * PN + k) * HR::NR + p] = vals[k];
    }
    for (int i = threadIdx.x; i < 9 * kc; i += NTHR) {
      const float* src = wlast + ((size_t)(i / kc) * c + c0 + i % kc) * HD_CO;
      wl[i] = make_float4(src[0], src[1], src[2], 0.f);
    }
    __syncthreads();
    last_sums(o, hs, wl, kc);
  }
  last_store<T>(o, red, blast, out, h, w, y0, x0, img);
}

// ---- the wgmma design (c = 64) ----------------------------------------------------

struct HGeo {
  static constexpr int RH = 16, RW = wgc::RW, NR = RH * RW;     // stage-1 region: 512 rows
  static constexpr int TH = RH - 2, TW = RW - 2, NO = TH * TW;  // output tile: 420 pixels
  static constexpr int XH = RH + 2, NX = XH * wgc::XW;          // staged x tile: 612 pixels
  static constexpr int MT = NR / 64 / wgc::NCW;                 // a warpgroup's M-tiles: 4
  static constexpr int NS = 3;                                  // ring stages
  static constexpr int STAGE = 2 * wgc::BTILE;                  // a stage: W_hr's two terms
  static constexpr int NZ = 9 * HD_CO, ZN = 32;                 // W' columns: used, wgmma's N
  static constexpr int ZP = 36;                                 // floats a Z row
  static constexpr int WLB = 2 * 2 * ZN * 128;                  // W': 2 k-blocks x 2 terms
};
static_assert(HGeo::NR == 64 * wgc::NCW * HGeo::MT, "stage 1's rows are whole M-tiles");
static_assert(HGeo::NR * HGeo::ZP * sizeof(float) <= HGeo::NX * wgc::CHB,
              "Z fits in the x chunk buffer it lies over");

// per feature type: 128-byte chunks of a pixel's 64 channels
template <typename T> struct HType { static constexpr int KB = 2; };
template <> struct HType<__nv_bfloat16> { static constexpr int KB = 1; };

// dynamic shared memory of a block: 1024 bytes to align the ring, the ring,
// W', two chunk buffers and the barriers
__host__ __device__ constexpr size_t hd_wg_smem() {
  using G = HGeo;
  return 1024 + (size_t)G::NS * G::STAGE + G::WLB + (size_t)2 * G::NX * wgc::CHB +
         sizeof(uint64_t) * (2 * G::NS + 5);
}
static_assert(hd_wg_smem() <= SMEM_MAX, "a wgmma head block fits an SM's shared memory");

// Weights (the wrapper's images, drt_stack.wg_image): whr (9, KB, 2, 64,
// 128 bytes), the two terms of each (tap, k-block) one ring stage; wl (2,
// 2, 32, 128 bytes) float32, W' (head_last_image): k-block, TF32 term, 32
// columns (tap, output; 27 used) of 32 permuted channels each; bhr (64,),
// blast (3,) float32.
template <typename T>
__global__ void __launch_bounds__(wgc::NTHR, 1)
    head_wg(const T* __restrict__ x, const T* __restrict__ whr, const float* __restrict__ bhr,
            const float* __restrict__ wl, const float* __restrict__ blast, T* __restrict__ out,
            int bsz, int h, int w) {
  using G = HGeo;
  using namespace wgc;
  constexpr int ELT = sizeof(T), KB = HType<T>::KB, MT = G::MT;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ringb = align1024(smem_raw);
  uint8_t* wls = ringb + G::NS * G::STAGE;
  uint8_t* xs = wls + G::WLB;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 2 * G::NX * CHB);
  uint64_t* empty = full + G::NS;
  uint64_t* xfull = empty + G::NS;  // two
  uint64_t* xempty = xfull + 2;     // two
  uint64_t* wbar = xempty + 2;      // W' is in
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::NS; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], NCONS / 32);
    }
    for (int k = 0; k < 2; ++k) {
      wg::mbar_init(&xfull[k], NXLOAD);
      wg::mbar_init(&xempty[k], NCONS / 32);
    }
    wg::mbar_init(wbar, 1);
    wg::fence_mbar_init();
  }
  __syncthreads();

  const int ntx = cdiv(w, G::TW), nty = cdiv(h, G::TH), per = ntx * nty, ntiles = bsz * per;
  const int lane = threadIdx.x % 32;
  // the warpgroup, warp-uniform as the compiler sees it
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  WRing<G::NS, G::STAGE> ring{ringb, full, empty};
  XRing<G::NX * CHB> xr{xs, xfull, xempty};

  if (wgi == NCW) {
    // ---- the producer warpgroup: warp 0 W' and the weight ring (one
    // thread), warps 1-3 the x chunks
    wg::setmaxnreg_dec<REG_PROD>();
    const int ptid = threadIdx.x - NCONS;
    if (ptid < 32) {
      if (ptid == 0) {
        wg::mbar_arrive_tx(wbar, G::WLB);
        wg::bulk_g2s(wls, wl, G::WLB, wbar);
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
          for (int kb = 0; kb < KB; ++kb)
            for (int tap = 0; tap < 9; ++tap)
              ring.put(whr + (size_t)(tap * KB + kb) * (G::STAGE / ELT), G::STAGE);
        ring.drain();
      }
      return;
    }
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      for (int kb = 0; kb < KB; ++kb, ++xr.g) {
        uint8_t* dst = xr.claim();
        // recomputed each chunk: nothing per thread is kept across the loop
        const int xt = wg::opaque(ptid - 32), tt = wg::opaque(t);
        const int b = tt / per, y0 = (tt % per) / ntx * G::TH - 2, x0 = tt % ntx * G::TW - 2;
        stage_chunk_wg<T>(dst, x + (size_t)b * h * w * C, kb * (CHB / ELT), h, w, y0, x0, XW,
                          G::NX, xt, &xr.full[xr.g & 1]);
      }
    }
    cp_async_wait_all();  // the last chunk's copies have landed
    return;
  }

  // ---- the consumer warpgroups (tile coordinates recomputed from opaque
  // copies where needed: the sums and fragments hold the registers)
  wg::setmaxnreg_inc<REG_CONS>();
  const int warp = __shfl_sync(0xffffffffu, (int)(threadIdx.x / 32) % 4, 0);
  const int ctid = threadIdx.x;  // 0 .. NCONS - 1
  float acc[MT][32];
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // ---- stage 1: region row p = 64 (MT wgi + m) + 16 warp + lane % 16
    // reads x-tile pixel (p / 32 + dy, p % 32 + dx) at tap (dy, dx)
    const int p0 = 64 * MT * wgi + 16 * warp + lane % 16;
    const int base = (p0 / G::RW) * XW + p0 % G::RW;
    zero(acc);
    uint8_t* zb = nullptr;  // the last chunk's buffer: Z lies over it
#pragma unroll
    for (int kb = 0; kb < KB; ++kb, ++xr.g) {
      const uint8_t* xb = xr.wait();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * XW + tap % 3, bs = wg::opaque(base);
        ring.take([&](const uint8_t* st) {
          conv_stage<T, MT, WGGroup<T>::MG, 4, 2, false>(acc, xb, bs, off, st);
        });
      }
      if (kb + 1 < KB)
        xr.release();
      else
        zb = xr.buf();
    }
    const uint32_t zbuf = (xr.g - 1) & 1;  // the buffer Z lies over
    // h = lrelu(sums + b_hr), zero outside the image, in the sum registers
    {
      const int tt = wg::opaque(t), ln = wg::opaque(lane);
      const int y0 = (tt % per) / ntx * G::TH - 1, x0 = tt % ntx * G::TW - 1;
      const int gq = ln / 4, t4 = ln % 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * t4;
        const float c0 = bhr[n], c1 = bhr[n + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = 64 * (MT * wgi + m) + 16 * warp + gq + 8 * hf;
            const int y = y0 + p / G::RW, xx = x0 + p % G::RW;
            const bool in = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
            float& v0 = acc[m][4 * j + 2 * hf];
            float& v1 = acc[m][4 * j + 2 * hf + 1];
            v0 = in ? lrelu(v0 + c0) : 0.f;
            v1 = in ? lrelu(v1 + c1) : 0.f;
          }
      }
    }
    wg::mbar_wait(wbar, 0);        // W' is in (the first tile waits)
    wg::named_sync(1, NCONS);      // every consumer is done with the x chunk Z overwrites
    // ---- stage 2: Z = h W' (3xTF32, m64n32k8), M-tile by M-tile
    float* zs = reinterpret_cast<float*>(zb);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // k-step s: channels 8 s + (0 2 4 6 1 3 5 7) of the sum fragment
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const float v[4] = {acc[m][4 * s], acc[m][4 * s + 2], acc[m][4 * s + 1],
                            acc[m][4 * s + 3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(__float_as_uint(v[r]), ah[s][r], al[s][r]);
      }
      float z[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) z[k] = 0.f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        wg::hold(ah[s]);
        wg::hold(al[s]);
      }
      wg::hold(z);
      wg::fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint8_t* hd = wls + ((s / 4) * 2) * (G::ZN * 128) + (s % 4) * KSTEP_BYTES;
        const uint64_t dh = wg::desc_sw128(hd), dt = wg::desc_sw128(hd + G::ZN * 128);
        wg::mma_tf32_n32(z, al[s], dh);  // the small terms first
        wg::mma_tf32_n32(z, ah[s], dt);
        wg::mma_tf32_n32(z, ah[s], dh);
      }
      wg::commit();
      wg::wait<0>();
      wg::hold(z);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        wg::hold(ah[s]);
        wg::hold(al[s]);
      }
      // rows g and g + 8 of the warp's 16, columns 8 j + 2 t4, + 1 (27 used)
      const int ln = wg::opaque(lane), gq = ln / 4, t4 = ln % 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = 64 * (MT * wgi + m) + 16 * warp + gq + 8 * hf, n = 8 * j + 2 * t4;
          if (n < G::NZ)
            *reinterpret_cast<float2*>(zs + p * G::ZP + n) =
                make_float2(z[4 * j + 2 * hf], z[4 * j + 2 * hf + 1]);
        }
    }
    wg::named_sync(1, NCONS);  // Z is whole
    // ---- y = b_last + sum_tap Z[pixel + tap][tap], as T
    {
      const int tt = wg::opaque(t);
      const int b = tt / per, y0 = (tt % per) / ntx * G::TH, x0 = tt % ntx * G::TW;
      const size_t img = (size_t)b * h * w;
      for (int i = ctid; i < G::NO * HD_CO; i += NCONS) {
        const int q = i / HD_CO, o = i - q * HD_CO, qy = q / G::TW, qx = q - qy * G::TW;
        const int y = y0 + qy, xx = x0 + qx;
        if (y >= h || xx >= w) continue;
        float v = blast[o];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          v += zs[((qy + tap / 3) * G::RW + qx + tap % 3) * G::ZP + tap * HD_CO + o];
        out[(img + (size_t)y * w + xx) * HD_CO + o] = from_f<T>(v);
      }
    }
    __syncwarp();  // Z (over x) may take the next tile's chunk
    if (lane == 0) wg::mbar_arrive(&xempty[zbuf]);
  }
}

// tiles of the wgmma design's walk (drt_stack.wg_tile_walk mirrors it)
__host__ __device__ constexpr int hd_wg_tiles(int b, int h, int w) {
  return b * cdiv(h, HGeo::TH) * cdiv(w, HGeo::TW);
}

template <typename T>
cudaError_t launch_head_wg(const T* x, const T* whr, const float* bhr, const float* wl,
                           const float* blast, T* out, int b, int h, int w,
                           cudaStream_t stream) {
  // the producer addresses a sample's pixels with 32-bit offsets
  if ((long long)h * w * wgc::C >= (1LL << 31)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  auto k = head_wg<T>;
  const size_t smem = hd_wg_smem();
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  int sms = 0;
  if ((e = wgc::sm_count(sms)) != cudaSuccess) return e;
  const int grid = imin(hd_wg_tiles(b, h, w), sms);
  k<<<grid, wgc::NTHR, smem, stream>>>(x, whr, bhr, wl, blast, out, b, h, w);
  return cudaGetLastError();
}

// design: 0 by the width (the wgmma design at 64 channels, head_tc at any
// other), 1 the mma.sync design at any width (the yardstick)
template <typename T>
cudaError_t launch_head(int design, const void* x, const void* whr, const void* bhr,
                        const void* wlast, const void* blast, void* hbuf, void* out, int b, int h,
                        int w, int c, cudaStream_t stream) {
  constexpr int ELT = sizeof(T);
  const auto* xt = static_cast<const T*>(x);
  const auto* whrt = static_cast<const T*>(whr);
  const auto* bhrf = static_cast<const float*>(bhr);
  const auto* wlf = static_cast<const float*>(wlast);
  const auto* blf = static_cast<const float*>(blast);
  auto* o = static_cast<T*>(out);
  if (design == 0 && c == wgc::C)
    return hbuf != nullptr ? cudaErrorInvalidValue
                           : launch_head_wg<T>(xt, whrt, bhrf, wlf, blf, o, b, h, w, stream);
  // one launch up to the widest block that fits, two through hbuf above it
  const int one = ELT == 2 ? HD_ONE_LAUNCH_BF16 : HD_ONE_LAUNCH_F32;
  if (c < PN || c % PN || (c > one) != (hbuf != nullptr) || (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const dim3 tiles((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, 1);
  cudaError_t e;
  if (hbuf == nullptr) {
    const size_t smem = head_smem(c, ELT);
    auto k = c <= NB ? head_tc<T, true> : head_tc<T, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
    k<<<dim3(tiles.x, tiles.y, b), NTHR, smem, stream>>>(xt, whrt, bhrf, wlf, blf, o, h, w, c);
    return cudaGetLastError();
  }
  auto* hb = static_cast<float*>(hbuf);
  if ((e = allow_smem(head_hidden_tc<T>, HH_SMEM)) != cudaSuccess) return e;
  head_hidden_tc<T><<<dim3(tiles.x, tiles.y, b * cdiv(c, NB)), NTHR, HH_SMEM, stream>>>(
      xt, whrt, bhrf, hb, h, w, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(head_last_kernel<T>, HL_SMEM)) != cudaSuccess) return e;
  head_last_kernel<T><<<dim3(tiles.x, tiles.y, b), NTHR, HL_SMEM, stream>>>(hb, wlf, blf, o, h,
                                                                           w, c);
  return cudaGetLastError();
}

int head_entry(int design, int dtype, const void* x, const void* whr, const void* bhr,
               const void* wlast, const void* blast, void* hbuf, void* out, int b, int h, int w,
               int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_head<float>(design, x, whr, bhr, wlast, blast, hbuf, out, b, h, w, c, s);
  if (dtype == 1)
    return (int)launch_head<__nv_bfloat16>(design, x, whr, bhr, wlast, blast, hbuf, out, b, h, w,
                                           c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, c), c a multiple of 8; bhr:
// (c,); blast: (3,) float32; hbuf: null for the one-launch form, above the
// one-launch width a float32 (b, h, w, c) scratch (two launches); out: (b,
// h, w, 3). W_hr in x's type, two terms (tf32_split's head and tail, or
// bf16_split's hi and lo), and W_last float32: at c = 64 (the wgmma design)
// drt_stack.wg_image's images whr (9, KB, 2, 64, 128 bytes) and wlast (2,
// 2, 32, 32) (head_last_image: W_last's (tap, output) columns, permuted
// channels, the TF32 head and tail); at any other width whr: (2, 9, c, c),
// each tap transposed (out, in), and wlast: (9, c, 3).
extern "C" int pnp_head(int dtype, const void* x, const void* whr, const void* bhr,
                        const void* wlast, const void* blast, void* hbuf, void* out, int b,
                        int h, int w, int c, void* stream) {
  return pnp::tc::head_entry(0, dtype, x, whr, bhr, wlast, blast, hbuf, out, b, h, w, c, stream);
}

// The mma.sync design at 64 channels too, with pnp_head's arguments in the
// (2, 9, c, c) / (9, c, 3) layout. chip_smoke.py times it beside the wgmma
// design as the yardstick; no model path calls it.
extern "C" int pnp_head_mma_sync(int dtype, const void* x, const void* whr, const void* bhr,
                                 const void* wlast, const void* blast, void* hbuf, void* out,
                                 int b, int h, int w, int c, void* stream) {
  return pnp::tc::head_entry(1, dtype, x, whr, bhr, wlast, blast, hbuf, out, b, h, w, c, stream);
}

// dynamic shared memory of a one-launch block at width c (dtype 0 float32,
// 1 bfloat16) in the design the width takes, for the build report and
// chip_smoke.py's check of launch.ONE_LAUNCH_WIDTH
extern "C" int pnp_head_smem(int c, int dtype) {
  if (c == pnp::tc::wgc::C) return (int)pnp::tc::hd_wg_smem();
  return (int)pnp::tc::head_smem(c, dtype == 1 ? 2 : 4);
}
