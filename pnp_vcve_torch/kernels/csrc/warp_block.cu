// K1b: bilinear warp by one flow per 8x8 block, zero padding, align_corners=True
// semantics (the serving warps 'pf' and 'block8').
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/warp_pf.py: warp_pf_compact
// (:552), which warps the packed 64-channel carry from a compact per-block
// table (build_warp_tables_compact :183) through selection-matrix matmuls.
// Here the table is what it means: fb (b, h/8, w/8, 2) float32, each block's
// flow at its top-left pixel, already clamped by the wrapper (+-16 px for
// 'pf', not at all for 'block8').
//
// A block's 64 pixels share one integer offset, floor(y + fy) = y + floor(fy)
// for integer y, so all their taps lie in one 9 x 9 source window at that
// offset (the (9, 9, C) slab of the JAX block8 warp, ops/warp.py:381-386).
// One CUDA block per 8x8 block: its 256 threads stage the window's 81 pixels
// x c channels into shared memory once (81 * c * 4 bytes, zeros outside the
// image, for any displacement), then blend the 64 outputs from there with
// the block's fractions. Channels are on the threads as in K1: the c / 4
// threads of a pixel read and write its c channels as one coalesced run.
// The width is a template parameter as in K1 (64, or 0: read at run time).
//
// Bound: device memory, the bytes of K1 without the per-pixel flow: the
// windows of neighbouring blocks overlap by one row and one column, which the
// cache serves.
#include "common.cuh"

namespace pnp {

constexpr int WB = 8;               // block edge
constexpr int WW = WB + 1;          // window edge
constexpr int WB_THREADS = 256;

// the window's shared memory at width c
constexpr size_t warp_block_smem(int c) { return sizeof(float4) * WW * WW * (c / 4); }
// the widest window that fits (launch.MAX_WIDTH holds the same number)
constexpr int WB_MAX_WIDTH = 712;
static_assert(warp_block_smem(WB_MAX_WIDTH) <= SMEM_MAX &&
                  warp_block_smem(WB_MAX_WIDTH + 8) > SMEM_MAX,
              "WB_MAX_WIDTH is the widest window that fits");

__device__ __forceinline__ void ld4(const float* p, float4& v) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float4& v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4& v) {
  uint2 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int CF>
__global__ void __launch_bounds__(WB_THREADS)
    warp_block_kernel(const T* __restrict__ x, const float* __restrict__ fb,
                      T* __restrict__ out, int h, int w, int c_rt) {
  extern __shared__ float4 win[];  // [window pixel][channel group]
  const int c = CF ? CF : c_rt;
  const int WG = c / 4;  // 4-channel groups per pixel

  const int bx = blockIdx.x, by = blockIdx.y, b = blockIdx.z;
  const int nbx = gridDim.x, nby = gridDim.y;
  const float* f = fb + (((size_t)b * nby + by) * nbx + bx) * 2;
  const float fx = f[0], fy = f[1];
  const float dxf = floorf(fx), dyf = floorf(fy);
  const float wx = fx - dxf, wy = fy - dyf;  // the block's fractions
  // integer offsets, clamped to where every tap lies outside the image
  // (weight zero either way); keeps the int conversion in range
  const int dx = (int)fminf(fmaxf(dxf, -(float)(w + 2 * WB)), (float)(w + 2 * WB));
  const int dy = (int)fminf(fmaxf(dyf, -(float)(h + 2 * WB)), (float)(h + 2 * WB));
  const int sx0 = bx * WB + dx, sy0 = by * WB + dy;  // window origin
  const size_t img = (size_t)b * h * w;

  for (int i = threadIdx.x; i < WW * WW * WG; i += WB_THREADS) {
    const int p = i / WG, g = i % WG;
    const int yy = sy0 + p / WW, xx = sx0 + p % WW;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) ld4(x + (img + (size_t)yy * w + xx) * c + g * 4, v);
    win[i] = v;
  }
  __syncthreads();

  // blend order of the JAX warp (ops/warp.py _warp_single_block8): rows
  // first, then columns
  const float wy0 = 1.f - wy, wx0 = 1.f - wx;
  for (int i = threadIdx.x; i < WB * WB * WG; i += WB_THREADS) {
    const int p = i / WG, g = i % WG;
    const int oy = p / WB, ox = p % WB;
    const float4 v00 = win[(oy * WW + ox) * WG + g];
    const float4 v01 = win[(oy * WW + ox + 1) * WG + g];
    const float4 v10 = win[((oy + 1) * WW + ox) * WG + g];
    const float4 v11 = win[((oy + 1) * WW + ox + 1) * WG + g];
    float4 o;
    o.x = (v00.x * wy0 + v10.x * wy) * wx0 + (v01.x * wy0 + v11.x * wy) * wx;
    o.y = (v00.y * wy0 + v10.y * wy) * wx0 + (v01.y * wy0 + v11.y * wy) * wx;
    o.z = (v00.z * wy0 + v10.z * wy) * wx0 + (v01.z * wy0 + v11.z * wy) * wx;
    o.w = (v00.w * wy0 + v10.w * wy) * wx0 + (v01.w * wy0 + v11.w * wy) * wx;
    const int y = by * WB + oy, xo = bx * WB + ox;
    st4(out + (img + (size_t)y * w + xo) * c + g * 4, o);
  }
}

template <typename T>
cudaError_t launch_warp_block(const void* x, const void* fb, void* out, int b, int h, int w,
                              int c, cudaStream_t stream) {
  if (h % WB || w % WB || c < PN || c % PN || c > WB_MAX_WIDTH) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const size_t smem = warp_block_smem(c);
  auto k = c == C ? warp_block_kernel<T, C> : warp_block_kernel<T, 0>;
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(w / WB, h / WB, b);
  k<<<grid, WB_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(fb), static_cast<T*>(out), h, w, c);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x, out: (b, h, w, c) with h, w multiples of
// 8 and c of 8; fb: (b, h/8, w/8, 2) float32, x first.
extern "C" int pnp_warp_block(int dtype, const void* x, const void* fb, void* out, int b, int h,
                              int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pnp::launch_warp_block<float>(x, fb, out, b, h, w, c, s);
  if (dtype == 1) return (int)pnp::launch_warp_block<__nv_bfloat16>(x, fb, out, b, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one block at width c, for the build report and
// chip_smoke.py's check of launch.MAX_WIDTH
extern "C" int pnp_warp_block_smem(int c) { return (int)pnp::warp_block_smem(c); }
