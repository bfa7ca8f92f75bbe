// Shared pieces of the port's Hopper kernels: feature-type conversion, 8-wide
// channel loads and stores, and the CUDA-core direct 3x3 convolution over a
// tile staged in shared memory that the head (K4) and K5 use (the input conv
// and the DRT block run on the tensor cores: tc_conv.cuh).
//
// Features are NHWC with c channels, c a multiple of 8 (the flagship's 64),
// stored as float or __nv_bfloat16. The CUDA-core convolution's weights are
// float32 and every sum is taken in float32.
//
// Conv thread layout: a block of NT = 256 threads computes a tile of pixels
// by one group of C = 64 output channels. Thread t owns output channels
// [8 * (t % 8), 8 * (t % 8) + 8) of the group and the pixels
// p = t / 8 + 32 * j of the tile (j = 0 .. PM-1), so each step of the
// reduction does PM shared-memory reads of the input, two float4 reads of
// the weights and 8 * PM FMAs. A width above 64 runs several groups; the
// last may be narrower (c % 64): its weights are staged zero-padded to 64
// columns and the threads past its width store nothing. Input channels are
// staged in chunks of up to 64. Staged inputs are channel-major
// (in[ci * plane + pixel]): the four pixels a warp reads at once are
// consecutive words, so the reads do not conflict.
//
// The kernels take the width as a template parameter CF: CF = 64 is the
// flagship's path with every loop bound known at compile time, CF = 0 any
// width read at run time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pnp {

constexpr int C = 64;        // channels of an output group and of a staged input chunk
constexpr int NT = 256;      // threads per conv block
constexpr int PN = 8;        // output channels per thread
constexpr int CG = C / PN;   // 8-channel groups of an output group (8)
constexpr int PG = NT / CG;  // pixel groups (32)
constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile columns
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory an H100 block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v as the feature type stores it (a no-op for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Eight consecutive channels. p must be 16-byte aligned (the wrappers check
// the base pointers; channel offsets are multiples of 8).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Stage channels [c0, c0 + kc) of src (one image, h x w x cs) over rows
// [y0, y0+rows) and columns [x0, x0+cols) into dst[ci * plane + p] as float,
// with zeros outside the image (the convolutions' zero padding).
// cs % 8 == 0 takes 16-byte loads (then c0 and kc are multiples of 8 too):
// consecutive threads take consecutive pixels of one 8-channel group, so the
// shared-memory writes do not conflict. Any other cs (the 3-channel lr
// frame) reads one value at a time.
template <typename T>
__device__ void load_tile(float* dst, int plane, const T* src, int cs, int c0, int kc, int h,
                          int w, int y0, int x0, int rows, int cols) {
  const int npix = rows * cols;
  if (cs % PN == 0) {
    for (int i = threadIdx.x; i < npix * (kc / PN); i += NT) {
      const int p = i % npix, g = i / npix;
      const int y = y0 + p / cols, x = x0 + p % cols;
      float v[8];
      if (y >= 0 && y < h && x >= 0 && x < w) {
        load8(src + ((size_t)y * w + x) * cs + c0 + g * PN, v);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[(g * PN + k) * plane + p] = v[k];
    }
  } else {
    for (int i = threadIdx.x; i < npix * kc; i += NT) {
      const int p = i % npix, ci = i / npix;
      const int y = y0 + p / cols, x = x0 + p % cols;
      const bool in = y >= 0 && y < h && x >= 0 && x < w;
      dst[ci * plane + p] = in ? to_f(src[((size_t)y * w + x) * cs + c0 + ci]) : 0.f;
    }
  }
}

// ws[ci * C + n] = wb[tap][c0 + ci][co0 + n] for n < cw, 0 for cw <= n < C:
// one tap of one input chunk of a (9, cin, cout) kernel, for the output
// group at co0 of width cw. cout, co0 and cw are multiples of 8, so each
// float4 lies wholly inside or outside the group.
__device__ __forceinline__ void stage_tap(float* ws, const float* wb, int tap, int cin, int cout,
                                          int c0, int kc, int co0, int cw) {
  for (int i = threadIdx.x * 4; i < kc * C; i += NT * 4) {
    const int ci = i / C, n = i % C;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < cw)
      v = __ldg(reinterpret_cast<const float4*>(wb + ((size_t)tap * cin + c0 + ci) * cout + co0 + n));
    *reinterpret_cast<float4*>(ws + i) = v;
  }
}

// Copy n floats (n % 4 == 0, both pointers 16-byte aligned) into shared memory.
__device__ __forceinline__ void copy_weights(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += NT * 4)
    *reinterpret_cast<float4*>(dst + i) = __ldg(reinterpret_cast<const float4*>(src + i));
}

// acc[j][n] += sum_ci in[ci * plane + base[j] + off] * wt[ci * C + 8 * tn + n]:
// one tap of a 3x3 convolution (off selects the tap) over cin channels.
template <int PM>
__device__ __forceinline__ void conv_tap(float (&acc)[PM][PN], const float* in, int plane,
                                         const int (&base)[PM], int off, const float* wt,
                                         int cin, int tn) {
#pragma unroll 4
  for (int ci = 0; ci < cin; ++ci) {
    const float* row = in + ci * plane + off;
    float a[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) a[j] = row[base[j]];
    const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * C + tn * PN);
    const float4 w1 = *reinterpret_cast<const float4*>(wt + ci * C + tn * PN + 4);
    const float wv[PN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < PM; ++j)
#pragma unroll
      for (int n = 0; n < PN; ++n) acc[j][n] = fmaf(a[j], wv[n], acc[j][n]);
  }
}

// The nine taps of a 3x3 convolution over one staged input chunk
// [c0, c0 + kc) of a (9, cin, cout) kernel wb, for the output group at co0
// of width cw: each tap's weights stream through ws. in is the chunk's tile,
// iw columns wide, whose pixel base[j] is the top-left tap of output pixel j.
template <int PM>
__device__ __forceinline__ void conv3x3(float (&acc)[PM][PN], const float* in, int plane,
                                        int iw, const int (&base)[PM], const float* wb,
                                        float* ws, int cin, int cout, int c0, int kc, int co0,
                                        int cw, int tn) {
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // every thread is done with the previous tap's weights
    stage_tap(ws, wb, tap, cin, cout, c0, kc, co0, cw);
    __syncthreads();
    conv_tap<PM>(acc, in, plane, base, (tap / 3) * iw + tap % 3, ws, kc, tn);
  }
}

// Pixel j of this thread in a region `cols` wide holding np pixels, as an
// index into a tile `iw` wide whose origin is the region's (0, 0). Pixels past
// the region read index 0 and are discarded by the caller.
template <int PM>
__device__ __forceinline__ void tile_bases(int (&base)[PM], int np, int cols, int iw) {
  const int pg = threadIdx.x / CG;
#pragma unroll
  for (int j = 0; j < PM; ++j) {
    const int p = pg + PG * j;
    base[j] = p < np ? (p / cols) * iw + p % cols : 0;
  }
}

template <int PM, int N>
__device__ __forceinline__ void zero(float (&acc)[PM][N]) {
#pragma unroll
  for (int j = 0; j < PM; ++j)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[j][n] = 0.f;
}

// Let kernel k use `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pnp
