// Shared pieces of the port's Hopper kernels: feature-type conversion, 8-wide
// channel loads and stores, and the direct 3x3 convolution over a tile staged
// in shared memory that the input conv, the DRT block and the head all use.
//
// Features are NHWC with C = 64 channels (the flagship width), stored as
// float or __nv_bfloat16. Weights are always float32 and every sum is taken
// in float32.
//
// Conv thread layout: a block of NT = 256 threads computes a tile of pixels
// by all 64 output channels. Thread t owns output channels
// [8 * (t % 8), 8 * (t % 8) + 8) and the pixels p = t / 8 + 32 * j of the
// tile (j = 0 .. PM-1), so each step of the reduction does PM shared-memory
// reads of the input, two float4 reads of the weights and 8 * PM FMAs.
// Staged inputs are channel-major (in[ci * plane + pixel]): the four pixels
// a warp reads at once are consecutive words, so the reads do not conflict.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pnp {

constexpr int C = 64;        // feature channels
constexpr int NT = 256;      // threads per conv block
constexpr int PN = 8;        // output channels per thread
constexpr int CG = C / PN;   // channel groups (8)
constexpr int PG = NT / CG;  // pixel groups (32)
constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile columns

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

// Stage src (one image, h x w x C) rows [y0, y0+rows) and columns [x0, x0+cols)
// into dst[ci * plane + r * cols + c] as float, with zeros outside the image
// (the convolutions' zero padding). Consecutive threads take consecutive
// pixels of one 8-channel group, so the shared-memory writes do not conflict.
template <typename T>
__device__ void load_tile(float* dst, int plane, const T* src, int h, int w,
                          int y0, int x0, int rows, int cols) {
  const int npix = rows * cols;
  for (int i = threadIdx.x; i < npix * CG; i += NT) {
    const int p = i % npix, g = i / npix;
    const int y = y0 + p / cols, x = x0 + p % cols;
    float v[8];
    if (y >= 0 && y < h && x >= 0 && x < w) {
      load8(src + ((size_t)y * w + x) * C + g * PN, v);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(g * PN + k) * plane + p] = v[k];
  }
}

// load_tile for a narrow part of cs < 8 channels (the 3-channel lr frame),
// read one value at a time: its rows are neither 16-byte aligned nor wide.
template <typename T>
__device__ void load_tile_narrow(float* dst, int plane, const T* src, int cs,
                                 int h, int w, int y0, int x0, int rows, int cols) {
  const int npix = rows * cols;
  for (int i = threadIdx.x; i < npix * cs; i += NT) {
    const int p = i % npix, ci = i / npix;
    const int y = y0 + p / cols, x = x0 + p % cols;
    const bool in = y >= 0 && y < h && x >= 0 && x < w;
    dst[ci * plane + p] = in ? to_f(src[((size_t)y * w + x) * cs + ci]) : 0.f;
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

// The nine taps of a 3x3 convolution whose per-tap weights (9, cin, C) are
// streamed through ws one tap at a time. in is a tile iw columns wide whose
// pixel base[j] is the top-left tap of output pixel j.
template <int PM>
__device__ __forceinline__ void conv3x3(float (&acc)[PM][PN], const float* in, int plane,
                                        int iw, const int (&base)[PM], const float* wg,
                                        float* ws, int cin, int tn) {
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // every thread is done with the previous tap's weights
    copy_weights(ws, wg + (size_t)tap * cin * C, cin * C);
    __syncthreads();
    conv_tap<PM>(acc, in, plane, base, (tap / 3) * iw + tap % 3, ws, cin, tn);
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
