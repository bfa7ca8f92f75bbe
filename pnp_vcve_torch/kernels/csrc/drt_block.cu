// K3: one fused DRT block (channel_first, one_layer, with_se):
//   h   = relu(conv3x3(x; W2[b] * gamma[b]) + b2[b] * gamma[b] + sum_r par_r * (x @ PK_r))
//   out = x + conv3x3(h; W1) + b1
// with h zero outside the image (conv1's zero padding). Out of place: the
// caller ping-pongs buffers because neighbouring tiles read x's halo.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: _drt_block_pf
// (:305, body _kernel_body :187). As there, h never leaves the chip: stage 1
// computes it on the output tile plus a 1-pixel halo into shared memory
// (the TPU kernel's VMEM `hmid`), stage 2 convolves it with W1. The per-sample
// gain gamma is folded into W2 and b2 by the wrapper (gamma * (conv + b2) ==
// conv(.; W2 * gamma) + b2 * gamma). The partition side path runs as three
// more "taps" of stage 1 that read the centre pixel scaled by par_r.
//
// K3s is the same kernel with the keyframe-carry select of the sweep folded
// into its epilogue (SELECT = true): it also writes
//   new_last_key = is_key[b] ? out : last_key
// while out is still in registers. It replaces the TPU kernel
// drt_stack.py: _kernel_select (:278, launched at :351), the last block of a
// step on the 'pf' serving path. The selected tile is the stored out tile
// itself (the same rounding to the feature type), so the select is exact;
// both outputs are fresh buffers, since at a sweep's first step last_key is
// the block's input carry. K3s is built and launched at 64 channels only,
// the pf path's width.
//
// Bound: CUDA-core float32 FMAs. The block needs ~158 GFLOP per 720p frame
// at c = 64; recomputing stage 1 on the 10 x 18 halo region of each 8 x 16
// output tile adds ~23% to that. Shared memory sets the tile. At c = 64 the
// 12 x 20 x 64 input tile (61 KB in float) is reused for h once stage 1 is
// done and the weights stream through 16 KB one tap at a time, so two blocks
// fit on an SM. Any other width (a multiple of 8) runs the output channels
// in groups of up to 64 and stages x in chunks of up to 64 channels (common.cuh),
// one group of h at a time, into an h region of its own that holds all c
// channels (c * 720 bytes: 92 KB at c = 128, one block an SM), since stage 2
// of every group reads all of them. The width is a template parameter CF
// (64, every bound known at compile time, or 0: read at run time).
#include "common.cuh"

namespace pnp {

constexpr int DB_HR = TH + 2, DB_HC = TW + 2, DB_NH = DB_HR * DB_HC;  // h region 10 x 18
constexpr int DB_XR = TH + 4, DB_XC = TW + 4, DB_NX = DB_XR * DB_XC;  // x tile 12 x 20
constexpr int DB_PM1 = (DB_NH + PG - 1) / PG;                         // 6 h pixels per thread
constexpr int DB_PM2 = TH * TW / PG;                                  // 4 out pixels per thread

// dynamic shared memory of one block at width c: the x chunk tile, one tap
// of weights, the partition gates and, at widths other than 64, the h region
constexpr size_t drt_block_smem(int c) {
  return sizeof(float) * (C * DB_NX + C * C + 3 * DB_NH + (c == C ? 0 : (size_t)c * DB_NH));
}
// the widest block that fits (launch.MAX_WIDTH holds the same number)
constexpr int DB_MAX_WIDTH = 208;
static_assert(drt_block_smem(DB_MAX_WIDTH) <= SMEM_MAX &&
                  drt_block_smem(DB_MAX_WIDTH + PN) > SMEM_MAX,
              "DB_MAX_WIDTH is the widest block that fits");

template <typename T, bool SELECT, int CF>
__global__ void __launch_bounds__(NT, 2)
    drt_block_kernel(const T* __restrict__ x, const T* __restrict__ par,
                     const float* __restrict__ w2g, const float* __restrict__ b2g,
                     const float* __restrict__ pk, const float* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ last_key,
                     const float* __restrict__ is_key, T* __restrict__ out,
                     T* __restrict__ new_last_key, int h, int w, int c_rt) {
  extern __shared__ float smem[];
  const int c = CF ? CF : c_rt;
  float* xs = smem;            // C x DB_NX input chunk tile
  float* ws = xs + C * DB_NX;  // one tap of weights
  float* ps = ws + C * C;      // 3 x DB_NH partition gates
  float* hs = CF == C ? xs : ps + 3 * DB_NH;  // c x DB_NH h region (the x tile at c = 64)

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG, pg = threadIdx.x / CG;
  const size_t img = (size_t)b * h * w;
  const float* w2b = w2g + (size_t)b * 9 * c * c;

  // ---- stage 1 on the h region: rows y0-1 .. y0+TH, cols x0-1 .. x0+TW
  for (int i = threadIdx.x; i < 3 * DB_NH; i += NT) {
    const int p = i % DB_NH, r = i / DB_NH;
    const int y = y0 - 1 + p / DB_HC, xx = x0 - 1 + p % DB_HC;
    const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
    ps[i] = in ? to_f(par[(img + (size_t)y * w + xx) * 3 + r]) : 0.f;
  }
  int base1[DB_PM1];
  tile_bases<DB_PM1>(base1, DB_NH, DB_HC, DB_XC);
  for (int co0 = 0; co0 < c; co0 += C) {  // output groups of h
    const int cw = min(C, c - co0);
    float acc[DB_PM1][PN];
    zero(acc);
    for (int c0 = 0; c0 < c; c0 += C) {  // input chunks of x
      const int kc = min(C, c - c0);
      __syncthreads();  // every thread is done with the previous chunk
      load_tile<T>(xs, DB_NX, x + img * c, c, c0, kc, h, w, y0 - 2, x0 - 2, DB_XR, DB_XC);
      conv3x3<DB_PM1>(acc, xs, DB_NX, DB_XC, base1, w2b, ws, c, c, c0, kc, co0, cw, tn);

      // partition side path: par_r * x at the h pixel itself (tile offset
      // DB_XC + 1 from the top-left tap), times PK_r, the "tap" r of pk
      for (int r = 0; r < 3; ++r) {
        __syncthreads();
        stage_tap(ws, pk, r, c, c, c0, kc, co0, cw);
        __syncthreads();
        float gate[DB_PM1];
#pragma unroll
        for (int j = 0; j < DB_PM1; ++j) {
          const int p = pg + PG * j;
          gate[j] = p < DB_NH ? ps[r * DB_NH + p] : 0.f;
        }
#pragma unroll 4
        for (int ci = 0; ci < kc; ++ci) {
          const float* row = xs + ci * DB_NX + DB_XC + 1;
          const float4 wa = *reinterpret_cast<const float4*>(ws + ci * C + tn * PN);
          const float4 wb = *reinterpret_cast<const float4*>(ws + ci * C + tn * PN + 4);
          const float wv[PN] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < DB_PM1; ++j) {
            const float a = row[base1[j]] * gate[j];
#pragma unroll
            for (int n = 0; n < PN; ++n) acc[j][n] = fmaf(a, wv[n], acc[j][n]);
          }
        }
      }
    }

    const bool live = tn * PN < cw;  // this thread's channels lie in the group
    float bv[PN];
#pragma unroll
    for (int n = 0; n < PN; ++n) bv[n] = live ? b2g[(size_t)b * c + co0 + tn * PN + n] : 0.f;
    __syncthreads();  // every thread is done reading x before h overwrites it (c = 64)
    if (live) {
#pragma unroll
      for (int j = 0; j < DB_PM1; ++j) {
        const int p = pg + PG * j;
        if (p >= DB_NH) continue;
        const int y = y0 - 1 + p / DB_HC, xx = x0 - 1 + p % DB_HC;
        const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
#pragma unroll
        for (int n = 0; n < PN; ++n) {
          // zero outside the image: conv1's zero padding; h is held in the
          // feature type, as the reference stores it
          const float v = in ? fmaxf(acc[j][n] + bv[n], 0.f) : 0.f;
          hs[(co0 + tn * PN + n) * DB_NH + p] = round_to<T>(v);
        }
      }
    }
  }

  // ---- stage 2: conv1 over h, + b1 + x, one output group at a time
  int base2[DB_PM2];
  tile_bases<DB_PM2>(base2, TH * TW, TW, DB_HC);
  const bool key = SELECT && is_key[b] > 0.5f;
  for (int co0 = 0; co0 < c; co0 += C) {
    const int cw = min(C, c - co0);
    float acc2[DB_PM2][PN];
    zero(acc2);
    for (int c0 = 0; c0 < c; c0 += C)  // conv3x3 syncs first: every h group is written
      conv3x3<DB_PM2>(acc2, hs + (size_t)c0 * DB_NH, DB_NH, DB_HC, base2, w1, ws, c, c, c0,
                      min(C, c - c0), co0, cw, tn);
    if (tn * PN >= cw) continue;  // past the last group's width
    float bv[PN];
#pragma unroll
    for (int n = 0; n < PN; ++n) bv[n] = b1[co0 + tn * PN + n];
#pragma unroll
    for (int j = 0; j < DB_PM2; ++j) {
      const int p = pg + PG * j;
      const int y = y0 + p / TW, xx = x0 + p % TW;
      if (y >= h || xx >= w) continue;
      const size_t o = (img + (size_t)y * w + xx) * c + co0 + tn * PN;
      float xv[PN], ov[PN];
      load8(x + o, xv);
#pragma unroll
      for (int n = 0; n < PN; ++n) ov[n] = xv[n] + (acc2[j][n] + bv[n]);
      store8(out + o, ov);
      if (SELECT) {
        if (!key) load8(last_key + o, ov);  // the feature type round-trips exactly
        store8(new_last_key + o, ov);
      }
    }
  }
}

template <typename T, bool SELECT>
cudaError_t launch_drt_block(const void* x, const void* par, const void* w2g, const void* b2g,
                             const void* pk, const void* w1, const void* b1,
                             const void* last_key, const void* is_key, void* out,
                             void* new_last_key, int b, int h, int w, int c,
                             cudaStream_t stream) {
  // K3s runs at 64 channels only, the pf path's width
  if (c < PN || c % PN || c > DB_MAX_WIDTH || (SELECT && c != C)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const size_t smem = drt_block_smem(c);
  auto k = drt_block_kernel<T, SELECT, C>;
  if constexpr (!SELECT) {
    if (c != C) k = drt_block_kernel<T, false, 0>;
  }
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  k<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(par), static_cast<const float*>(w2g),
      static_cast<const float*>(b2g), static_cast<const float*>(pk),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(last_key), static_cast<const float*>(is_key), static_cast<T*>(out),
      static_cast<T*>(new_last_key), h, w, c);
  return cudaGetLastError();
}

template <bool SELECT>
int drt_block_entry(int dtype, const void* x, const void* par, const void* w2g, const void* b2g,
                    const void* pk, const void* w1, const void* b1, const void* last_key,
                    const void* is_key, void* out, void* new_last_key, int b, int h, int w,
                    int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_drt_block<float, SELECT>(x, par, w2g, b2g, pk, w1, b1, last_key, is_key,
                                                out, new_last_key, b, h, w, c, s);
  if (dtype == 1)
    return (int)launch_drt_block<__nv_bfloat16, SELECT>(x, par, w2g, b2g, pk, w1, b1, last_key,
                                                        is_key, out, new_last_key, b, h, w, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x, out: (b, h, w, c), c a multiple of 8;
// par: (b, h, w, 3); w2g: (b, 9, c, c) and b2g: (b, c), gamma folded in;
// pk: (3, c, c); w1: (9, c, c); b1: (c,). Weights float32.
extern "C" int pnp_drt_block(int dtype, const void* x, const void* par, const void* w2g,
                             const void* b2g, const void* pk, const void* w1, const void* b1,
                             void* out, int b, int h, int w, int c, void* stream) {
  return pnp::drt_block_entry<false>(dtype, x, par, w2g, b2g, pk, w1, b1, nullptr, nullptr, out,
                                     nullptr, b, h, w, c, stream);
}

// K3s: pnp_drt_block's arguments plus last_key (b, h, w, c) of x's type and
// is_key (b,) float32 0/1; writes out and new_last_key = where(is_key, out,
// last_key), neither aliasing an input.
extern "C" int pnp_drt_block_select(int dtype, const void* x, const void* par, const void* w2g,
                                    const void* b2g, const void* pk, const void* w1,
                                    const void* b1, const void* last_key, const void* is_key,
                                    void* out, void* new_last_key, int b, int h, int w, int c,
                                    void* stream) {
  return pnp::drt_block_entry<true>(dtype, x, par, w2g, b2g, pk, w1, b1, last_key, is_key, out,
                                    new_last_key, b, h, w, c, stream);
}

// dynamic shared memory of one block at width c, for the build report and
// chip_smoke.py's check of launch.MAX_WIDTH
extern "C" int pnp_drt_block_smem(int c) { return (int)pnp::drt_block_smem(c); }
