// What the wgmma designs at 64 channels share, on wgmma.cuh's pieces: K2's
// and K4's (input_conv.cu: input_conv_wg, head.cu: head_wg) all of it below,
// K3's (drt_block.cu: drt_block_wg) the block's roles, the weight ring, the
// A fragments and the swizzled pixel addressing; the probes' K10
// (probe_tapconv.cu: tapconv_wg) the roles, the chunk ring, the A
// fragments and the pixel addressing, and the tensor-map ring (TRing) that
// K7 (probe_mmsel.cu: mmsel_wg) shares.
//
// Block: two consumer warpgroups and one producer warpgroup, 384 threads,
// one block an SM, persistent over the output tiles in (sample, tile row,
// tile column) order (grid = min(tiles, SMs); block k takes tiles k, k +
// grid, ...). setmaxnreg gives the consumers 232 registers and the
// producer 40, as K3's drt_block_wg (drt_block.cu). Producer warp 0 (one
// thread) feeds the weight ring: one cp.async.bulk a stage onto an mbarrier
// ring, each consumer warp releasing a stage once its wgmma have read it.
// Producer warps 1-3 stage the input one chunk at a time: 128 bytes of
// channels a pixel (64 bf16 or 32 float32 channels; K2's 3-channel lr frame
// zero-padded to 32 bytes) into two chunk buffers, cp.async with zero fill
// outside the image (the lr frame by scalar loads), each pixel's 16-byte
// pieces XOR-swizzled by the pixel so that ldmatrix is conflict-free,
// completing on the buffer's x barrier (XRing). The chunks run in one
// sequence over a block's tiles, so chunk j + 1 (after a tile's last chunk,
// the next tile's first) lands while chunk j computes.
//
// A conv stage (conv_stage) is one tap of one chunk for a warpgroup's
// M-tiles of 64 rows, each two 32-pixel rows of the image: A loaded by
// ldmatrix at each lane's pixel (a tap an address offset; float32 split
// into its TF32 head and tail in registers), B the stage's weight tiles
// read through descriptors, K-major, 128-byte swizzled (32-byte swizzled
// for K2's lr part, one k-step deep). bf16 takes m64n64k16, one product a
// k-step and weight term; float32 takes 3xTF32, three m64n64k8 products
// (lo*hi, hi*lo, hi*hi).
#pragma once

#include "tc_conv.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace pnp {
namespace tc {
namespace wgc {

constexpr int C = 64;                    // the one width the designs take
constexpr int RW = 32, XW = RW + 2;      // an M-tile's image rows' width; the staged tile's
constexpr int NCW = 2;                   // consumer warpgroups
constexpr int NCONS = NCW * 128;         // consumer threads
constexpr int NTHR = NCONS + 128;        // + the producer warpgroup
constexpr int REG_CONS = 232, REG_PROD = 40;  // setmaxnreg per role
constexpr int NXLOAD = 96;               // producer threads on the input
constexpr int CHB = 128;                 // bytes of a pixel's staged chunk
constexpr int BTILE = 64 * 128;          // a 64 x 128-byte weight tile
constexpr int LRTILE = 64 * KSTEP_BYTES; // a 64 x 32-byte weight tile (one k-step)
// setmaxnreg moves registers within the block's allocation at launch (the
// 64K split evenly over its threads, a multiple of 8 each)
static_assert((65536 / NTHR / 8 * 8 - REG_PROD) * 128 ==
                  (REG_CONS - 65536 / NTHR / 8 * 8) * NCONS,
              "the roles' register counts balance");

// pixel q's 16-byte piece j in a tile of PIXB-byte pixels (128: a chunk
// buffer; K3's float32 x tile holds 256) whose pieces are XOR-swizzled by
// the pixel
template <int PIXB = CHB>
__device__ __forceinline__ uint8_t* xpiece(uint8_t* buf, int q, int j) {
  return buf + q * PIXB + ((j ^ (q & 7)) << 4);
}
template <int PIXB = CHB>
__device__ __forceinline__ const uint8_t* xpiece(const uint8_t* buf, int q, int j) {
  return buf + q * PIXB + ((j ^ (q & 7)) << 4);
}

// the first 1024-aligned byte at or after p (128-byte swizzle atoms)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The weight ring of NS stages of STAGE bytes (K2, K3 and K4): the producer
// thread's and each consumer's position in it.
template <int NS, int STAGE>
struct WRing {
  uint8_t* base;
  uint64_t* full;   // NS barriers: the producer's arrival with the stage's bytes
  uint64_t* empty;  // NS barriers: one arrival from each consumer warp
  int slot = 0;
  uint32_t ph = 0;

  __device__ __forceinline__ void advance() {
    if (++slot == NS) {
      slot = 0;
      ph ^= 1;
    }
  }
  // producer: move `bytes` from src into the next stage once it is free
  __device__ __forceinline__ void put(const void* src, uint32_t bytes) {
    wg::mbar_wait(&empty[slot], ph ^ 1);
    wg::mbar_arrive_tx(&full[slot], bytes);
    wg::bulk_g2s(base + slot * STAGE, src, bytes, &full[slot]);
    advance();
  }
  // producer: stay until every stage has been read (the last copies landed)
  __device__ __forceinline__ void drain() {
    for (int k = 0; k < NS; ++k) {
      wg::mbar_wait(&empty[slot], ph ^ 1);
      advance();
    }
  }
  // consumer: wait for the next stage, run(stage) on it, release it
  template <typename F>
  __device__ __forceinline__ void take(F&& run) {
    wg::mbar_wait(&full[slot], ph);
    run(static_cast<const uint8_t*>(base + slot * STAGE));
    __syncwarp();
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(&empty[slot]);
    advance();
  }
};

// The two input chunk buffers of NBYTES each: chunk g of a block's sequence
// goes to buffer g % 2. full[k]: one arrival from each producer x thread
// (its cp.async, or its stores); empty[k]: one from each consumer warp.
template <int NBYTES>
struct XRing {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int g = 0;

  __device__ __forceinline__ uint8_t* buf() const { return base + (g & 1) * NBYTES; }
  // producer: wait until chunk g's buffer is free (chunk g - 2 released)
  __device__ __forceinline__ uint8_t* claim() const {
    if (g >= 2) wg::mbar_wait(&empty[g & 1], ((g >> 1) - 1) & 1);
    return buf();
  }
  // consumer: wait until chunk g has landed
  __device__ __forceinline__ const uint8_t* wait() const {
    wg::mbar_wait(&full[g & 1], (g >> 1) & 1);
    return buf();
  }
  // consumer: this warp is done with chunk g's buffer
  __device__ __forceinline__ void release() const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(&empty[g & 1]);
  }
};

// A ring of NS stages of STAGE bytes (a multiple of 1024) that one producer
// thread fills with tensor-map boxes (K7's window rows, K10's weights):
// full[k] takes the producer's arrival with the box's bytes, empty[k] one
// arrival from each consumer warp. A consumer that multiplies one stage
// while the next one's products run keeps two positions in it: one it
// waits at, one it releases at.
template <int NS, int STAGE>
struct TRing {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int slot = 0;
  uint32_t ph = 0;

  __device__ __forceinline__ void advance() {
    if (++slot == NS) {
      slot = 0;
      ph ^= 1;
    }
  }
  // producer: copy the box at (c0, c1, c2) of map (bytes in all) into the
  // next stage once it is free
  __device__ __forceinline__ void put(const CUtensorMap* map, int c0, int c1, int c2,
                                      uint32_t bytes) {
    wg::mbar_wait(&empty[slot], ph ^ 1);
    wg::mbar_arrive_tx(&full[slot], bytes);
    tma::load_3d(base + slot * STAGE, map, c0, c1, c2, &full[slot]);
    advance();
  }
  // consumer: wait until the next stage has landed
  __device__ __forceinline__ const uint8_t* wait() {
    wg::mbar_wait(&full[slot], ph);
    const uint8_t* st = base + slot * STAGE;
    advance();
    return st;
  }
  // consumer: this warp is done with the next stage to release
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(&empty[slot]);
    advance();
  }
};

// Producer x thread xt of NXLOAD: stage 128 bytes of channels a pixel (from
// channel c0 of the NHWC 64-channel image src) of the rows x cols tile at
// (y0, x0) into dst, zeros outside the image; then arrive on bar when the
// copies have landed.
template <typename T>
__device__ __forceinline__ void stage_chunk_wg(uint8_t* dst, const T* src, int c0, int h, int w,
                                               int y0, int x0, int cols, int n, int xt,
                                               uint64_t* bar) {
  constexpr int VEC = 16 / sizeof(T);
  for (int k = xt; k < n * 8; k += NXLOAD) {
    const int q = k >> 3, j = k & 7, qy = q / cols;
    const int y = y0 + qy, xx = x0 + (q - qy * cols);
    const bool ok = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
    cp_async16(xpiece(dst, q, j), src + (ok ? (y * w + xx) * C + c0 + j * VEC : 0), ok);
  }
  wg::cp_async_mbar_arrive(bar);
}

// A fragments of one k-step for MG M-tiles: bf16 the rows as they are,
// float32 their TF32 head and tail
template <typename T, int MG> struct AFrag;
template <int MG> struct AFrag<__nv_bfloat16, MG> {
  uint32_t a[MG][4];
  __device__ __forceinline__ void hold() {
#pragma unroll
    for (int m = 0; m < MG; ++m) wg::hold(a[m]);
  }
};
template <int MG> struct AFrag<float, MG> {
  uint32_t hi[MG][4], lo[MG][4];
  __device__ __forceinline__ void hold() {
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      wg::hold(hi[m]);
      wg::hold(lo[m]);
    }
  }
};

// M-tiles a commit group multiplies: bf16 4 (16 fragment registers),
// float32 2 (head and tail, 16 registers), so that two groups' fragments
// and 128 sums fit a consumer's 232 registers
template <typename T> struct WGGroup { static constexpr int MG = 4; };
template <> struct WGGroup<float> { static constexpr int MG = 2; };

// One conv stage for a warpgroup's NM M-tiles: KS k-steps (4: a 128-byte
// chunk; 1: K2's lr part), A rows at pixels base + 2 XW m + off of the chunk
// buffer xb, B the stage's weight tiles at st: NW terms (bf16: 1, or K4's hi
// and lo; float32: 2, the TF32 head and tail), the second one tile further
// (BTILE, or LRTILE for the 32-byte swizzled SW32 tiles). The stage runs as
// a stream of commit groups, one a k-step and group of MG M-tiles, through
// two fragment buffers: each group loads its A while the one before
// multiplies, and waits only until the group two back, which read the
// buffer it overwrites, is done (K3's wg_stage). It ends with every group
// complete, so its weights may be released and its sums read.
template <typename T, int NM, int MG, int KS, int NW, bool SW32>
__device__ __forceinline__ void conv_stage(float (&acc)[NM][32], const uint8_t* xb, int base,
                                           int off, const uint8_t* st) {
  constexpr int NG = cdiv(NM, MG);
  constexpr int TAIL = SW32 ? LRTILE : BTILE;
  const int half = (threadIdx.x % 32) / 16;
  int q[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) q[m] = base + 2 * XW * m + off;
  const uint64_t dh = SW32 ? wg::desc_sw32(st) : wg::desc_sw128(st);
  AFrag<T, MG> f[2];
#pragma unroll
  for (int u = 0; u < KS * NG; ++u) {
    const int ks = u / NG, m0 = (u % NG) * MG;
    AFrag<T, MG>& cur = f[u % 2];
    if (u >= 2) {  // the group two back has read this buffer
      wg::wait<1>();
      cur.hold();
    }
    const uint64_t d0 = wg::desc_add(dh, ks * KSTEP_BYTES);
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      const int m = m0 + k;
      if (m >= NM) break;
      uint32_t af[4];
      ldmatrix_x4(af, xpiece(xb, q[m], 2 * ks + half));
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cur.a[k][r] = af[r];
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(af[r], cur.hi[k][r], cur.lo[k][r]);
      }
    }
    cur.hold();
#pragma unroll
    for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
    wg::fence();
#pragma unroll
    for (int k = 0; k < MG; ++k) {
      const int m = m0 + k;
      if (m >= NM) break;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if constexpr (NW == 2) wg::mma_bf16(acc[m], cur.a[k], wg::desc_add(d0, TAIL));  // lo first
        wg::mma_bf16(acc[m], cur.a[k], d0);
      } else {
        const uint64_t d1 = wg::desc_add(d0, TAIL);  // the weights' TF32 tail
        wg::mma_tf32(acc[m], cur.lo[k], d0);  // the small terms first, as mma.sync's kstep
        wg::mma_tf32(acc[m], cur.hi[k], d1);
        wg::mma_tf32(acc[m], cur.hi[k], d0);
      }
    }
    wg::commit();
  }
  wg::wait<0>();
#pragma unroll
  for (int m = 0; m < NM; ++m) wg::hold(acc[m]);
  f[0].hold();
  f[1].hold();
}

template <int NM>
__device__ __forceinline__ void zero(float (&acc)[NM][32]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[m][k] = 0.f;
}

// the SMs of the current device (the persistent grid's size)
inline cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace wgc
}  // namespace tc
}  // namespace pnp
