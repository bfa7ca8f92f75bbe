// K12: per-block two-window averages in bf16, written block-major,
//   out_flat[64 j + 8 r + cc] = bf16((xp[ya + r, xa + cc] + xp[ya + 1 + r, xb + cc]) * 0.5)
// for each 8 x 8 block j (row-major over the (h/8, w/8) blocks) and r, cc in
// 0..7, the sum and the halving in float32, with the block's window origins
// ya = clamp(sy[j], 0, hp - 9), xa = clamp(sx[j], 0, wp - 8) and
// xb = clamp(sx[j] + 8, 0, wp - 8): a window reaching outside xp is moved
// inside it, as a dynamic slice is. xp (1, hp, wp, c) and out (1, h, w, c)
// bf16; sy, sx (h/8 * w/8,) int32.
//
// Replaces the TPU probe tools/warp_kernel_probe.py: probe_dma (:177,
// pallas_call :179), which DMAs two 9 x 8 windows a block (win_a at (sy, sx),
// win_b at (sy, sx + 8)) and stores win_a[0:8] + win_b[1:9], halved, in its
// block-major layout (:172): block j's 64 pixels row-major at flat pixel
// 64 j of the output, so row r' of band ri holds that band's blocks
// 20 r' .. 20 r' + 19 at w = 1280. Here the flat pixel index is the block's
// and the layout comes for free.
//
// Layout: one thread per (block, pixel, 8 channels): the eight threads of a
// pixel read its 64 channels (at c = 64) as one 128-byte run, a block's row
// of 8 pixels one 1 KB run. No staging: each value read is used once.
//
// Bound: bytes. The windows' 2 x 64 pixels a block in, 64 out, the tables.
#include "common.cuh"

namespace pnp {

constexpr int BW_EDGE = 8;  // block edge
constexpr int BW_THREADS = 256;

__global__ void __launch_bounds__(BW_THREADS)
    block_windows_kernel(const __nv_bfloat16* __restrict__ xp, const int* __restrict__ sy,
                         const int* __restrict__ sx, __nv_bfloat16* __restrict__ out, int nblk,
                         int hp, int wp, int c) {
  const int nv = c / PN;
  const size_t idx = (size_t)blockIdx.x * BW_THREADS + threadIdx.x;
  if (idx >= (size_t)nblk * BW_EDGE * BW_EDGE * nv) return;
  const int v = idx % nv;
  const size_t t = idx / nv;  // flat output pixel: block j, pixel (r, cc)
  const int j = t / (BW_EDGE * BW_EDGE), px = t % (BW_EDGE * BW_EDGE);
  const int r = px / BW_EDGE, cc = px % BW_EDGE;
  const int ya = min(max(sy[j], 0), hp - BW_EDGE - 1);
  const int xa = min(max(sx[j], 0), wp - BW_EDGE);
  const int xb = min(max(sx[j] + BW_EDGE, 0), wp - BW_EDGE);
  float a[PN], b[PN], o[PN];
  load8(xp + ((size_t)(ya + r) * wp + xa + cc) * c + v * PN, a);
  load8(xp + ((size_t)(ya + 1 + r) * wp + xb + cc) * c + v * PN, b);
#pragma unroll
  for (int n = 0; n < PN; ++n) o[n] = __fmul_rn(__fadd_rn(a[n], b[n]), 0.5f);
  store8(out + t * c + v * PN, o);
}

}  // namespace pnp

// xp (1, hp, wp, c) bf16 with hp >= 9, wp >= 16, c % 8 == 0; sy, sx
// (nblk,) int32; out (1, h, w, c) bf16 with h * w == 64 nblk.
extern "C" int pnp_block_windows(const void* xp, const void* sy, const void* sx, void* out,
                                 int nblk, int hp, int wp, int c, void* stream) {
  if (nblk < 1 || hp < pnp::BW_EDGE + 1 || wp < 2 * pnp::BW_EDGE || c < pnp::PN || c % pnp::PN)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)nblk * pnp::BW_EDGE * pnp::BW_EDGE * (c / pnp::PN);
  pnp::block_windows_kernel<<<(unsigned)((n + pnp::BW_THREADS - 1) / pnp::BW_THREADS),
                              pnp::BW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<__nv_bfloat16*>(out), nblk, hp, wp, c);
  return (int)cudaGetLastError();
}
