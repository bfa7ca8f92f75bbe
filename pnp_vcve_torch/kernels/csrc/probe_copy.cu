// K6: a scaled window copy in bf16,
//   out[b, r, x, :] = 2 * src[b, y0 + (period ? r % period : r), x0 + x, :]
// src (nb, hs, ws, lanes), out (nb, ho, wo, lanes), lanes % 8 == 0.
//
// Replaces the TPU probes that measure a band copy's floor:
// tools/warp_kernel_probe2.py: probe_floor128 (:77; period 0, y0 16, x0 16,
// 128 lanes), tools/warp_bisect.py: k_dma (:43; a 48-row band DMAed per 8
// output rows, y0 16, x0 32) and k_nodma (:67; the whole input as every grid
// step's block, so rows repeat with period 8). The TPU's 48-row band for 8
// output rows was an artefact of its layout; here each output element reads
// its one source element. Doubling a bf16 is exact (float32 in between).
//
// Bound: bytes. Each thread moves 16 bytes (8 lanes) of a row, consecutive
// threads on consecutive pieces, so reads and writes are whole sectors; no
// division per element, nothing else is done.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace pnp {

constexpr int WC_THREADS = 256;

// Block (x, y) copies 16-byte pieces [256 x, 256 x + 256) of output rows
// y, y + gridDim.y, ...: an output row's wo * lanes values are one
// contiguous run of its source row, from column x0 on.
__global__ void __launch_bounds__(WC_THREADS)
    window_copy_kernel(const __nv_bfloat16* __restrict__ src, __nv_bfloat16* __restrict__ out,
                       int nb, int hs, int ws, int ho, int row_vecs, int lanes, int y0, int x0,
                       int period) {
  const int j = blockIdx.x * WC_THREADS + threadIdx.x;
  if (j >= row_vecs) return;
  for (int br = blockIdx.y; br < nb * ho; br += gridDim.y) {
    const int b = br / ho, r = br % ho;
    const int y = y0 + (period ? r % period : r);
    const uint4* s = reinterpret_cast<const uint4*>(src + (((size_t)b * hs + y) * ws + x0) * lanes);
    uint4 u = __ldg(s + j);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      h[k] = __floats2bfloat162_rn(2.f * f.x, 2.f * f.y);
    }
    reinterpret_cast<uint4*>(out + (size_t)br * row_vecs * 8)[j] = u;
  }
}

}  // namespace pnp

// src (nb, hs, ws, lanes) and out (nb, ho, wo, lanes) bf16, lanes % 8 == 0;
// the window must lie inside src.
extern "C" int pnp_window_copy(const void* src, void* out, int nb, int hs, int ws, int ho, int wo,
                               int lanes, int y0, int x0, int period, void* stream) {
  if (nb < 1 || ho < 1 || wo < 1 || lanes < 8 || lanes % 8 || period < 0 || y0 < 0 || x0 < 0 ||
      y0 + (period ? std::min(period, ho) : ho) > hs || x0 + wo > ws)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = wo * lanes / 8;
  const dim3 grid((row_vecs + pnp::WC_THREADS - 1) / pnp::WC_THREADS, std::min(nb * ho, 65535));
  pnp::window_copy_kernel<<<grid, pnp::WC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(out), nb, hs, ws, ho,
      row_vecs, lanes, y0, x0, period);
  return (int)cudaGetLastError();
}
