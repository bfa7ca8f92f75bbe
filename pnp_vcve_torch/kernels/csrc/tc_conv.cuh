// The tensor-core core of the model's convolutions: K2 (input_conv.cu), K3
// (drt_block.cu), K4 (head.cu) and K5 (conv3x3.cu), each a 3x3 convolution
// over a pixel tile as an implicit GEMM on mma.sync. K2, K4 and K5 share one
// GEMM loop, conv_tc below, with an epilogue of their own; K3 keeps its own
// loop for its partition taps and its second stage.
//
// GEMM view. Rows are the pixels of a region of the image (flattened, padded
// to the 16-row mma tile), columns a group of NB = 64 output channels, depth
// 9 taps x input channels. A is the input tile staged in shared memory one
// pixel a row (channels contiguous): the rows of a tap's A operand are the
// same pixels shifted by the tap, so ldmatrix takes a per-lane row address
// and a tap is an address offset, not a copy (K10's scheme, probe_tapconv.cu).
// B is one tap of one input chunk of the weights, staged transposed
// (Bt[n][k], the "col" operand). Input channels are staged in chunks of
// CHUNK_BYTES = 128 bytes a pixel (64 bf16 or 32 float channels); rows are
// PITCH = 144 bytes apart, an odd number of 16-byte units, so the eight rows
// an ldmatrix reads at once fall in different banks.
//
// Block and warps. NTHR = 256 threads, 8 warps: WM = 4 along the rows by
// WN = 2 along the channels. Warp (wm, wn) owns MT consecutive 16-row mma
// tiles (rows [16 MT wm, 16 MT (wm + 1))) by 32 channels ([32 wn, 32 wn + 32),
// four 8-column mma tiles): its sums are acc[MT][4][4] float32 in the mma
// accumulator layout (mma.cuh).
//
// Operand types (template parameter T):
// - bf16: m16n8k16 with float32 sums, one product per k-step of 16 channels;
//   with NW = 2 weight tiles a step (K4's W_hr) the weights arrive as two
//   bf16 terms, hi + lo, and each k-step takes both products, so the
//   weights keep ~16 bits of their float32 value;
// - float32: 3xTF32. Each operand is split into a TF32 head (the float's
//   low 13 mantissa bits zeroed) and a TF32 tail (the rest, rounded to
//   TF32), and the sum takes hi*hi + hi*lo + lo*hi on m16n8k8 (k-steps of 8
//   channels), three products, so float32 inputs keep about float32's
//   accuracy (the lo*lo term is below 2^-22 of the product). The weights
//   arrive split (the wrapper's tf32_split: NW = 2 staged tiles, head and
//   tail); A is split in registers after its ldmatrix.
// Single-pass TF32 would keep only ~3 decimal digits.
//
// Staging. Every step (one tap of one input chunk) runs behind a two-stage
// ring: the step's weight tile (and, when the step needs a new input chunk,
// that chunk, into the other of two chunk buffers) is requested with
// cp.async while the previous step computes, and one __syncthreads a step
// both publishes the data and frees the slot the next request overwrites.
// cp.async's zero fill (source size 0) gives the convolution's zero padding
// past the image edge and the zero channels past the width. An input whose
// pixels are not 16-byte aligned (c % 8 != 0: K2's 3-channel frame, any
// c_in of K5) is staged with scalar loads and plain stores instead, zeros
// filled the same way; its weight rows arrive zero-padded to whole 16-byte
// vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace pnp {
namespace tc {

constexpr int NTHR = 256;                          // threads a block
constexpr int WM = 4, WN = 2;                      // warps along rows, along channels
constexpr int NB = 64;                             // output channels of a group
constexpr int CHUNK_BYTES = 128;                   // staged bytes of one pixel's channel chunk
constexpr int PITCH = CHUNK_BYTES + 16;            // staged row pitch
constexpr int NVEC = CHUNK_BYTES / 16;             // 16-byte vectors of a staged row
constexpr int WTILE = NB * PITCH;                  // one staged weight tile
constexpr int TILE_H = 8, TILE_W = 16;             // output tile
constexpr int MT_OUT = TILE_H * TILE_W / (16 * WM);  // a warp's row tiles over the output tile: 2

template <typename T> struct Operand;
template <> struct Operand<__nv_bfloat16> {
  static constexpr int KC = 64;       // channels of a staged chunk
  static constexpr int NW = 1;        // staged weight tiles a step
  static constexpr int KSTEP_CH = 16; // channels of an mma k-step
};
template <> struct Operand<float> {
  static constexpr int KC = 32;
  static constexpr int NW = 2;  // TF32 head and tail
  static constexpr int KSTEP_CH = 8;
};

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// pitch of a region holding all c channels of a pixel: whole 32-byte
// k-steps plus 16 bytes (an odd number of 16-byte units, as PITCH)
__host__ __device__ constexpr int wide_pitch(int c, int elt) {
  return cdiv(c * elt, KSTEP_BYTES) * KSTEP_BYTES + 16;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage channels [c0, c0 + kc) of src (one image, h x w x cs, NHWC) over
// rows [y0, y0 + rows) and columns [x0, x0 + cols) into dst, one pixel a
// PITCH row (p = row * cols + col); zeros outside the image and past kc.
// cs, c0 and kc are multiples of 8 channels: each 16-byte vector lies wholly
// inside or outside.
template <typename T>
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const T* src, int cs, int c0, int kc,
                                            int h, int w, int y0, int x0, int rows, int cols) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * cols * NVEC; i += NTHR) {
    const int p = i / NVEC, v = i % NVEC;
    const int y = y0 + p / cols, x = x0 + p % cols;
    const bool ok = v * VEC < kc && y >= 0 && y < h && x >= 0 && x < w;
    cp_async16(dst + p * PITCH + v * 16, ok ? src + ((size_t)y * w + x) * cs + c0 + v * VEC : src,
               ok);
  }
}

// stage_chunk for a src whose pixels are not 16-byte aligned (cs % 8 != 0):
// each 16-byte vector is built from scalar loads (zeros outside the image
// and past kc) and written with a plain store, which the step's
// __syncthreads publishes as it does the cp.async data.
template <typename T>
__device__ __forceinline__ void stage_chunk_ragged(uint8_t* dst, const T* src, int cs, int c0,
                                                   int kc, int h, int w, int y0, int x0, int rows,
                                                   int cols) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * cols * NVEC; i += NTHR) {
    const int p = i / NVEC, v = i % NVEC;
    const int y = y0 + p / cols, x = x0 + p % cols;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (v * VEC < kc && y >= 0 && y < h && x >= 0 && x < w) {
      T* vals = reinterpret_cast<T*>(&u);
      const T* s = src + ((size_t)y * w + x) * cs + c0 + v * VEC;
      const int n = kc - v * VEC;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (k < n) vals[k] = s[k];
    }
    *reinterpret_cast<uint4*>(dst + p * PITCH + v * 16) = u;
  }
}

// Stage rows [co0, co0 + cw) and columns [c0, c0 + kc) of a row-major
// (cout, cin) matrix wt (one tap, transposed weights: wt[n][k]) into dst,
// one output channel a PITCH row; zeros past cw and kc.
template <typename T>
__device__ __forceinline__ void stage_w(uint8_t* dst, const T* wt, int cin, int c0, int kc,
                                        int co0, int cw) {
  constexpr int VEC = 16 / sizeof(T);
  for (int i = threadIdx.x; i < NB * NVEC; i += NTHR) {
    const int n = i / NVEC, v = i % NVEC;
    const bool ok = n < cw && v * VEC < kc;
    cp_async16(dst + n * PITCH + v * 16, ok ? wt + (size_t)(co0 + n) * cin + c0 + v * VEC : wt,
               ok);
  }
}

// One weight step: the head tile and, with NW = 2 (float32, or K4's bf16
// hi + lo), the tail tile, which lies lo_stride elements past the head in
// the wrapper's (2, ...) stack.
template <typename T, int NW = Operand<T>::NW>
__device__ __forceinline__ void stage_w_step(uint8_t* dst, const T* wt, size_t lo_stride, int cin,
                                             int c0, int kc, int co0, int cw) {
  stage_w<T>(dst, wt, cin, c0, kc, co0, cw);
  if constexpr (NW == 2) stage_w<T>(dst + WTILE, wt + lo_stride, cin, c0, kc, co0, cw);
}

// d += a (16 x 8) * b (8 x 8) in TF32 with float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi the float with its low 13 mantissa bits cleared, lo the
// rest rounded to TF32 (the wrapper's tf32_split on the weights).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = x & 0xffffe000u;
  const float r = __uint_as_float(x) - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// Scale this lane's A fragment by the per-row gates: registers 0 and 2 hold
// row g of the 16-row tile, 1 and 3 row g + 8 (gate[0], gate[1]). The
// product is rounded to T, as x * par is in the feature type.
__device__ __forceinline__ void gate_frag(uint32_t (&a)[4], const float (&gate)[2],
                                          __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&a[i]);
    const float2 f = __bfloat1622float2(v);
    v = __floats2bfloat162_rn(f.x * gate[i & 1], f.y * gate[i & 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}
__device__ __forceinline__ void gate_frag(uint32_t (&a)[4], const float (&gate)[2], float) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(__uint_as_float(a[i]) * gate[i & 1]);
}

// One k-step (32 bytes of depth) of a warp's MT x 4 mma tiles. a[m] is this
// lane's ldmatrix address of row tile m at the k-step, b that of the warp's
// first pair of 8-column tiles in the staged weight tile (the second pair
// 16 rows further; the tail tile, NW = 2, WTILE further).
template <typename T, int MT, bool GATED, int NW = Operand<T>::NW>
__device__ __forceinline__ void kstep(float (&acc)[MT][4][4], const uint8_t* const (&a)[MT],
                                      const uint8_t* b, const float (&gate)[MT][2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t bf[NW][2][4];  // bf16: the weights, or their hi and lo terms
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      ldmatrix_x4(bf[t][0], b + t * WTILE);
      ldmatrix_x4(bf[t][1], b + t * WTILE + 16 * PITCH);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t af[4];
      ldmatrix_x4(af, a[m]);
      if constexpr (GATED) gate_frag(af, gate[m], T());
#pragma unroll
      for (int t = 0; t < NW; ++t)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_step(acc[m][2 * p], af, bf[t][p][0], bf[t][p][1]);
          mma_step(acc[m][2 * p + 1], af, bf[t][p][2], bf[t][p][3]);
        }
    }
  } else {
    uint32_t bh[2][4], bl[2][4];
    ldmatrix_x4(bh[0], b);
    ldmatrix_x4(bh[1], b + 16 * PITCH);
    ldmatrix_x4(bl[0], b + WTILE);
    ldmatrix_x4(bl[1], b + WTILE + 16 * PITCH);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t af[4], ah[4], al[4];
      ldmatrix_x4(af, a[m]);
      if constexpr (GATED) gate_frag(af, gate[m], T());
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(af[i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = j / 2, q = 2 * (j % 2);
        mma_tf32(acc[m][j], al, bh[p][q], bh[p][q + 1]);
        mma_tf32(acc[m][j], ah, bl[p][q], bl[p][q + 1]);
        mma_tf32(acc[m][j], ah, bh[p][q], bh[p][q + 1]);
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
}

// One step: nks k-steps over A rows arow[m] (this lane's byte offsets, the
// 16-byte half of the k-step included) shifted by aoff bytes, against the
// weight tile at w (the slot's first tile). SPLIT (3xTF32 only): the step
// sums into zeroed registers and adds them to acc on the CUDA cores. The
// tensor cores' float32 accumulation truncates, and across the ~200 mma of
// a long sum (K2's 1755 terms a pixel, its output up to ~10 std) the bias
// grew to 1.1-1.5e-4 of the output std on an H100 (700 W); the step's own sum
// bounds it by its 12 mma. It costs MT x 16 registers.
template <typename T, int MT, bool GATED, bool SPLIT = false, int NW = Operand<T>::NW>
__device__ __forceinline__ void conv_step(float (&acc)[MT][4][4], const uint8_t* abuf,
                                          const int (&arow)[MT], int aoff, const uint8_t* w,
                                          int nks, const float (&gate)[MT][2]) {
  const int lane = threadIdx.x % 32, wn = threadIdx.x / 32 / WM;
  const uint8_t* b = w + (32 * wn + (lane / 16) * 8 + lane % 8) * PITCH + ((lane / 8) % 2) * 16;
  auto ksteps = [&](float (&sum)[MT][4][4]) {
#pragma unroll
    for (int ks = 0; ks < CHUNK_BYTES / KSTEP_BYTES; ++ks) {
      if (ks >= nks) break;
      const uint8_t* a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = abuf + arow[m] + aoff + ks * KSTEP_BYTES;
      kstep<T, MT, GATED, NW>(sum, a, b + ks * KSTEP_BYTES, gate);
    }
  };
  if constexpr (SPLIT && Operand<T>::NW == 2) {
    float part[MT][4][4];
    zero_acc(part);
    ksteps(part);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] += part[m][j][q];
  } else {
    ksteps(acc);
  }
}

// This lane's A row offsets for row tiles m of warp wm: row r = 16 (MT wm +
// m) + lane % 16 is region pixel r (past np: pixel 0, computed and dropped),
// region `cols` wide, read from a tile `tcols` wide with `pitch` bytes a
// pixel; the lane's 16-byte half of the k-step is added.
template <int MT>
__device__ __forceinline__ void row_offsets(int (&arow)[MT], int np, int cols, int tcols,
                                            int pitch) {
  const int lane = threadIdx.x % 32, wm = (threadIdx.x / 32) % WM;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    int p = 16 * (MT * wm + m) + lane % 16;
    p = p < np ? p : 0;
    arow[m] = ((p / cols) * tcols + p % cols) * pitch + (lane / 16) * 16;
  }
}

// Visit this lane's sums: f(row, col, v0, v1) for region row `row` and the
// channel pair (col, col + 1) of the group (col even), v0 and v1 their sums.
template <int MT, typename F>
__device__ __forceinline__ void for_each_pair(float (&acc)[MT][4][4], F&& f) {
  const int lane = threadIdx.x % 32, wm = (threadIdx.x / 32) % WM, wn = threadIdx.x / 32 / WM;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        f(16 * (MT * wm + m) + g + 8 * half, 32 * wn + 8 * j + 2 * t, acc[m][j][2 * half],
          acc[m][j][2 * half + 1]);
}

// Two channels of T at p (4-byte aligned for bf16, 8 for float).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// The pair as T stores it, back in float (for a select that must match).
__device__ __forceinline__ float2 rounded2(float a, float b, float) { return make_float2(a, b); }
__device__ __forceinline__ float2 rounded2(float a, float b, __nv_bfloat16) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The input chunk ring: which of the two chunk buffers holds which chunk.
// next(id) names the buffer step s + 1 reads while step s reads `cur`: the
// current one if it holds id, else the other, loading it there unless it
// already holds id. Every thread keeps the same state.
struct ChunkRing {
  int cur = 1, tag[2] = {-1, -1};
  template <typename Load>
  __device__ __forceinline__ int next(int id, Load&& load) {
    if (tag[cur] == id) return cur;
    const int o = cur ^ 1;
    if (tag[o] != id) {
      load(o);
      tag[o] = id;
    }
    return o;
  }
};

// The rows of a convolution's GEMM: the 8 x 16 output tile (HALO = 0) or
// the tile and a 1-pixel halo (HALO = 1: K4's hidden map, which conv_last
// reads around each output pixel), read from a staged input tile one pixel
// wider on each side.
template <int HALO>
struct Region {
  static constexpr int RH = TILE_H + 2 * HALO, RW = TILE_W + 2 * HALO, NR = RH * RW;
  static constexpr int XH = RH + 2, XW = RW + 2, NA = XH * XW;  // the staged input tile
  static constexpr int MT = cdiv(NR, 16 * WM);                  // a warp's row tiles: 2 or 3
};

// dynamic shared memory of conv_tc over the output tile (Region<0>): two
// chunk buffers and the weight ring of nw tiles a slot
__host__ __device__ constexpr size_t conv_tc_smem(int nw) {
  return (size_t)2 * Region<0>::NA * PITCH + (size_t)2 * nw * WTILE;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : 0.1f * v; }

// Visit this lane's sums over the output tile (Region<0>) of the block:
// f(px, n, v0, v1) for the channel pair (n, n + 1) of output group co0 at
// pixel px = y * w + x of the image, skipping what lies past cout or the
// image.
template <typename F>
__device__ __forceinline__ void for_each_out_pair(float (&acc)[Region<0>::MT][4][4], int co0,
                                                  int cout, int h, int w, F&& f) {
  const int y0 = blockIdx.y * TILE_H, x0 = blockIdx.x * TILE_W;
  for_each_pair<Region<0>::MT>(acc, [&](int p, int col, float& v0, float& v1) {
    const int n = co0 + col, y = y0 + p / TILE_W, x = x0 + p % TILE_W;
    if (n < cout && y < h && x < w) f((size_t)y * w + x, n, v0, v1);
  });
}

// One input of a convolution: x (b, h, w, c) NHWC and its taps w (NW, [b,]
// 9, cout, wc), each transposed (out, in), per sample or shared by the
// batch; wc >= c is a weight row's length (c padded to whole 16-byte
// vectors where c % 8 != 0).
template <typename T>
struct ConvIn {
  const T* x;
  const T* w;
  int c, wc;
};

// The GEMM loop of K2, K4 and K5: sum_k conv3x3(in[k].x[b]; in[k].w) over
// the region (Region<HALO>) of the block at (blockIdx.y, blockIdx.x), for
// output groups [g_lo, g_hi) of NB channels of cout. Its steps run group by
// group, input by input, chunk by chunk, tap by tap, through the chunk ring
// (xb: two buffers of NA rows) and the weight ring (wb: two slots of NW
// tiles). After a group's last step epi(co0, acc) takes its sums
// (for_each_pair); then they are zeroed. SPLIT: conv_step's, for long
// float32 sums. Every thread calls it with the same arguments.
template <typename T, int HALO, int NW, bool SPLIT, typename Epi>
__device__ __forceinline__ void conv_tc(const ConvIn<T>* in, int nin, bool per_sample, int bsz,
                                        int b, int h, int w, int cout, int g_lo, int g_hi,
                                        uint8_t* xb, uint8_t* wb, Epi&& epi) {
  using Op = Operand<T>;
  using R = Region<HALO>;
  struct Step {
    int tap, nks, co0, buf;
    bool last;  // the group's last step
  };
  const int y0 = blockIdx.y * TILE_H - HALO - 1, x0 = blockIdx.x * TILE_W - HALO - 1;
  const size_t img = (size_t)b * h * w;
  int S = 0;
  for (int k = 0; k < nin; ++k) S += 9 * cdiv(in[k].c, Op::KC);
  S *= g_hi - g_lo;

  ChunkRing ring;
  // the step to issue next: group g, input k, chunk ch, tap; id0 the
  // ring id of input k's first chunk
  int k = 0, ch = 0, tap = 0, g = g_lo, id0 = 0;
  auto issue = [&](int s) {
    const ConvIn<T>& p = in[k];
    const int nch = cdiv(p.c, Op::KC), c0 = ch * Op::KC, kc = imin(Op::KC, p.c - c0);
    const int co0 = g * NB, cw = imin(NB, cout - co0);
    const size_t taps = (size_t)9 * cout * p.wc;  // one sample's weights
    stage_w_step<T, NW>(wb + (s & 1) * NW * WTILE,
                        p.w + (per_sample ? b * taps : 0) + (size_t)tap * cout * p.wc,
                        (per_sample ? bsz : 1) * taps, p.wc, c0, kc, co0, cw);
    Step st;
    st.buf = ring.next(id0 + ch, [&](int o) {
      uint8_t* dst = xb + o * R::NA * PITCH;
      if (p.c % 8)
        stage_chunk_ragged<T>(dst, p.x + img * p.c, p.c, c0, kc, h, w, y0, x0, R::XH, R::XW);
      else
        stage_chunk<T>(dst, p.x + img * p.c, p.c, c0, kc, h, w, y0, x0, R::XH, R::XW);
    });
    cp_async_commit();
    st.tap = tap;
    st.nks = cdiv(kc, Op::KSTEP_CH);
    st.co0 = co0;
    st.last = tap == 8 && ch == nch - 1 && k == nin - 1;
    if (++tap == 9) {
      tap = 0;
      if (++ch == nch) {
        ch = 0;
        id0 += nch;
        if (++k == nin) {
          k = id0 = 0;
          ++g;
        }
      }
    }
    return st;
  };

  float acc[R::MT][4][4];
  int arow[R::MT];
  const float nogate[R::MT][2] = {};
  row_offsets<R::MT>(arow, R::NR, R::RW, R::XW, PITCH);
  zero_acc(acc);
  Step nxt = issue(0);
  for (int s = 0; s < S; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s's data is in; every warp is done with step s - 1
    const Step cur = nxt;
    ring.cur = cur.buf;
    if (s + 1 < S) nxt = issue(s + 1);
    conv_step<T, R::MT, false, SPLIT, NW>(acc, xb + cur.buf * R::NA * PITCH, arow,
                                          ((cur.tap / 3) * R::XW + cur.tap % 3) * PITCH,
                                          wb + (s & 1) * NW * WTILE, cur.nks, nogate);
    if (cur.last) {
      epi(cur.co0, acc);
      zero_acc(acc);
    }
  }
}

}  // namespace tc
}  // namespace pnp
