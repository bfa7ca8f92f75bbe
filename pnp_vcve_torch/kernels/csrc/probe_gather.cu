// K11: the two-pass, two-tap gather warp in bf16,
//   H pass, band ri (input rows from 8 ri), column x, band row j:
//     h[j, x] = bf16(fma(xp[8 ri + j, x + k + x0 + 1], a1, fma(xp[8 ri + j, x + k + x0], a0, 0)))
//   V pass:
//     out[8 ri + r, x] = bf16(fma(h[r + d + 1, x], b1, fma(h[r + d, x], b0, 0)))
// with k = shidx[ri, x], d = dyidx[ri, x]; a0 = wx0[ri, x] where 0 <= k < 35
// (else 0), a1 = wx1[ri, x] where -1 <= k < 34, and b0, b1 likewise from
// wy0, wy1 and d. xp (1, hp, wp, c) and out (1, 8 nb, w, c) bf16, the six
// tables (nb, w): shidx and dyidx int32, the weights float32.
//
// Replaces the TPU probe tools/warp_kernel_probe.py: probe_select (:123,
// pallas_call :124), whose two passes are masked sums over 35 shifts: shift
// s weighs band column x + s + x0 by where(k == s, wx0, 0) + where(k == s - 1,
// wx1, 0) (x0 = PADX - 17 = 15), and row d by wy0 / wy1 the same way. Only
// two of a pass's 35 terms are non-zero, so this is a gather, not a dense
// sum, and the zero terms add nothing. The two live terms are fused
// multiply-adds in the TPU kernel's order (the first shift's term, then the
// next), as XLA compiles its `acc + sl * w`; the H pass rounds to bf16, as
// the TPU kernel's hband holds it.
//
// Layout: one thread per (band, column, 8 channels). An output column's
// eight rows read h at band rows d .. d + 8 only, so the thread computes
// those nine rows of h in registers from two 16-byte loads a row: no band is
// staged, nothing is shared. The eight threads of a pixel read its 64
// channels (at c = 64) as one 128-byte run.
//
// Loads: a design that put each load behind its weight's test read as
// slowly with its input in the L2 as from device memory (the first 12
// bands, 39 MB, warm: 12/90 of its cold time), so neither the L2 nor device
// memory set its pace, but each thread's loads waiting on one another: a
// load behind its test went out after the ones before it. Here every tap is
// loaded, with no test: a dead tap's weight is zero and the wrapper keeps
// every live tap inside xp, so the address is clamped into xp (row and
// column) and its finite value times the zero weight adds +0, as in the
// plain version's clamped gather; a band row outside the 42 a V term can
// read gives h = 0 after the load. The 18 loads of a thread issue
// together, and only two h rows (packed bf16) stay live. The output is
// stored with an evict-first hint. (Streaming the rows into the L2 ahead of
// the bands, by bulk prefetches, measured slower and is not kept.)
//
// Bound: bytes. xp is read about once (neighbouring columns' taps overlap in
// the cache), out written once, the tables read once; 2 x 17 FMAs an output
// vector of 8 channels.
#include "common.cuh"

namespace pnp {

constexpr int GS_SHIFTS = 35;                          // the TPU kernel's shifts a pass
constexpr int GS_ROWS = 8;                             // output rows a band
constexpr int GS_TAPS = GS_ROWS + 1;                   // h rows an output column reads
constexpr int GS_BAND = GS_SHIFTS - 1 + GS_ROWS;       // band rows the V pass can reach (42)
constexpr int GS_THREADS = 256;

// 16-byte loads of 8 bf16 channels and the bf16 h rows as packed pairs
__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ float2 bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(GS_THREADS, 2)
    gather2_kernel(const __nv_bfloat16* __restrict__ xp, const int* __restrict__ shidx,
                   const float* __restrict__ wx0, const float* __restrict__ wx1,
                   const int* __restrict__ dyidx, const float* __restrict__ wy0,
                   const float* __restrict__ wy1, __nv_bfloat16* __restrict__ out, int nb,
                   int wp, int w, int c, int x0) {
  const int nv = c / PN;
  const size_t idx = (size_t)blockIdx.x * GS_THREADS + threadIdx.x;
  if (idx >= (size_t)nb * w * nv) return;
  const int v = idx % nv;
  const size_t t = idx / nv;  // (band, column) in the tables
  const int x = t % w, ri = t / w;
  const int k = shidx[t], d = dyidx[t];
  const float a0 = (k >= 0 && k < GS_SHIFTS) ? wx0[t] : 0.f;
  const float a1 = (k >= -1 && k < GS_SHIFTS - 1) ? wx1[t] : 0.f;
  const float b0 = (d >= 0 && d < GS_SHIFTS) ? wy0[t] : 0.f;
  const float b1 = (d >= -1 && d < GS_SHIFTS - 1) ? wy1[t] : 0.f;
  // the a0 and a1 taps' columns, clamped into xp (a live tap's never is)
  const int pc = min(max(x + k + x0, 0), wp - 1), qc = min(max(x + k + x0 + 1, 0), wp - 1);

  // every tap's load first, 18 in flight, at a clamped row and column: no
  // load waits behind a test
  const size_t rs = (size_t)wp * c;
  const __nv_bfloat16* band = xp + (size_t)ri * GS_ROWS * rs + v * PN;
  uint4 p[GS_TAPS], q[GS_TAPS];
#pragma unroll
  for (int i = 0; i < GS_TAPS; ++i) {
    const __nv_bfloat16* row = band + (size_t)min(max(d + i, 0), GS_BAND - 1) * rs;
    p[i] = ldg16(row + (size_t)pc * c);
    q[i] = ldg16(row + (size_t)qc * c);
  }
  // h at band row d + i as bf16 pairs, zero where the row lies outside the
  // 42 a live V term can read; two rows live at a time
  auto hrow = [&](int i, uint32_t (&h)[PN / 2]) {
    const bool live = (unsigned)(d + i) < (unsigned)GS_BAND;
    const uint32_t pw[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
    const uint32_t qw[4] = {q[i].x, q[i].y, q[i].z, q[i].w};
#pragma unroll
    for (int n = 0; n < PN / 2; ++n) {
      const float2 pf = bf2(pw[n]), qf = bf2(qw[n]);
      h[n] = live ? pack_bf2(__fmaf_rn(qf.x, a1, __fmaf_rn(pf.x, a0, 0.f)),
                             __fmaf_rn(qf.y, a1, __fmaf_rn(pf.y, a0, 0.f)))
                  : 0u;
    }
  };
  uint32_t h0[PN / 2], h1[PN / 2];
  hrow(0, h0);
#pragma unroll
  for (int r = 0; r < GS_ROWS; ++r) {
    hrow(r + 1, h1);
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int n = 0; n < PN / 2; ++n) {
      const float2 f0 = bf2(h0[n]), f1 = bf2(h1[n]);
      ow[n] = pack_bf2(__fmaf_rn(f1.x, b1, __fmaf_rn(f0.x, b0, 0.f)),
                       __fmaf_rn(f1.y, b1, __fmaf_rn(f0.y, b0, 0.f)));
      h0[n] = h1[n];
    }
    __stcs(reinterpret_cast<uint4*>(out + (((size_t)ri * GS_ROWS + r) * w + x) * c + v * PN), o);
  }
}

}  // namespace pnp

// xp (1, hp, wp, c) bf16, c % 8 == 0; shidx, dyidx (nb, w) int32; wx0, wx1,
// wy0, wy1 (nb, w) float32; out (1, 8 nb, w, c) bf16. The wrapper checks
// that every tap a live weight reads lies inside xp (x0 >= 1,
// wp >= w + x0 + 34, hp >= 8 nb + 34).
extern "C" int pnp_gather2(const void* xp, const void* shidx, const void* wx0, const void* wx1,
                           const void* dyidx, const void* wy0, const void* wy1, void* out, int nb,
                           int hp, int wp, int w, int c, int x0, void* stream) {
  using pnp::GS_SHIFTS;
  if (nb < 1 || w < 1 || c < pnp::PN || c % pnp::PN || x0 < 1 || wp < w + x0 + GS_SHIFTS - 1 ||
      hp < pnp::GS_ROWS * (nb - 1) + pnp::GS_BAND)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)nb * w * (c / pnp::PN);
  pnp::gather2_kernel<<<(unsigned)((n + pnp::GS_THREADS - 1) / pnp::GS_THREADS), pnp::GS_THREADS,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xp), static_cast<const int*>(shidx),
      static_cast<const float*>(wx0), static_cast<const float*>(wx1),
      static_cast<const int*>(dyidx), static_cast<const float*>(wy0),
      static_cast<const float*>(wy1), static_cast<__nv_bfloat16*>(out), nb, wp, w, c, x0);
  return (int)cudaGetLastError();
}
