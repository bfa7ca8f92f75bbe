// K1: bilinear flow warp, zero padding, align_corners=True semantics.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/warp_pf.py: warp_pf (:488),
// which warps the packed 64-channel carry by 8x8-block-constant motion vectors
// clamped to +-16 px through selection-matrix matmuls. Here the flow is read
// per pixel and not clamped, so the result equals
// grid_sample(align_corners=True, padding_mode='zeros') for any flow, and the
// JAX block8 warp on block-constant flows.
//
// Bound: device memory. Each output pixel reads 4 taps of c channels and
// writes c channels; at 720p and c = 64 that is ~0.5 GB per call in float32
// when the cache serves the overlapping taps. One thread per (pixel,
// 4 channels): the c / 4 threads of a pixel read each tap's channels as one
// coalesced run (256 bytes in float, 128 in bf16 at c = 64). The width is a
// template parameter CF (64, the flagship's, or 0: any multiple of 8 read at
// run time), so the flagship's index arithmetic divides by a constant.
#include "common.cuh"

namespace pnp {

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int CF>
__global__ void __launch_bounds__(256) warp_kernel(const T* __restrict__ x,
                                                   const T* __restrict__ flow,
                                                   T* __restrict__ out, int b, int h, int w,
                                                   int c_rt) {
  const int c = CF ? CF : c_rt;
  const int G = c / 4;  // channel vectors per pixel
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)b * h * w * G) return;
  const int g = idx % G;
  const size_t pix = idx / G;
  const int xo = pix % w;
  const int yo = (pix / w) % h;
  const size_t img = pix / ((size_t)w * h);

  // Sample position in pixels; a flow that arrives in bf16 is already
  // rounded, as on the JAX path. Positions beyond one pixel outside the
  // image give zero either way; the clamp keeps floor() in int range.
  float px = (float)xo + to_f(flow[pix * 2]);
  float py = (float)yo + to_f(flow[pix * 2 + 1]);
  px = fminf(fmaxf(px, -2.f), (float)w + 1.f);
  py = fminf(fmaxf(py, -2.f), (float)h + 1.f);
  const float fx0 = floorf(px), fy0 = floorf(py);
  const float wx = px - fx0, wy = py - fy0;  // floor of a negative fraction rounds down
  const int x0 = (int)fx0, y0 = (int)fy0;

  const T* base = x + img * h * w * c + g * 4;
  float v[2][2][4];  // [dy][dx][channel]; taps outside the image are zero
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int yy = y0 + dy, xx = x0 + dx;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        load4(base + ((size_t)yy * w + xx) * c, v[dy][dx]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[dy][dx][k] = 0.f;
      }
    }
  // blend order of the JAX warp (ops/warp.py _padgather_combine and
  // _warp_single_block8): rows first, then columns
  const float wy0 = 1.f - wy, wx0 = 1.f - wx;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r0 = v[0][0][k] * wy0 + v[1][0][k] * wy;
    const float r1 = v[0][1][k] * wy0 + v[1][1][k] * wy;
    o[k] = r0 * wx0 + r1 * wx;
  }
  store4(out + pix * c + g * 4, o);
}

template <typename T>
cudaError_t launch_warp(const void* x, const void* flow, void* out, int b, int h, int w, int c,
                        cudaStream_t stream) {
  if (c < PN || c % PN) return cudaErrorInvalidValue;
  const size_t n = (size_t)b * h * w * (c / 4);
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  auto k = c == C ? warp_kernel<T, C> : warp_kernel<T, 0>;
  k<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(flow), static_cast<T*>(out), b, h, w, c);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x, out: (b, h, w, c), c a multiple of 8;
// flow: (b, h, w, 2), x first.
extern "C" int pnp_warp(int dtype, const void* x, const void* flow, void* out, int b, int h,
                        int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pnp::launch_warp<float>(x, flow, out, b, h, w, c, s);
  if (dtype == 1) return (int)pnp::launch_warp<__nv_bfloat16>(x, flow, out, b, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// The message of an error code returned by any entry point of the library.
extern "C" const char* pnp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
