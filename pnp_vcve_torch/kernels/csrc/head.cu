// K4: the reconstruction head, y = conv3x3(lrelu_0.1(conv3x3(x; W_hr) + b_hr); W_last) + b_last,
// c -> c -> 3 channels. The caller adds lr.
//
// Replaces the TPU kernel pnp_vcve_tpu/kernels/drt_stack.py: head_pf (:1058,
// kernel _head_kernel :977). Same two-stage structure as the DRT block (K3):
// stage 1 computes the c-channel hidden map on the output tile plus a
// 1-pixel halo into shared memory, zeroed outside the image (conv_last's
// zero padding), and stage 2 reduces it to 3 channels without it leaving
// the chip.
//
// Two-launch form. Above HD_ONE_LAUNCH channels the hidden region does not
// fit: the wrapper passes a float32 (b, h, w, c) scratch and the head runs
// as two launches, head_hidden_kernel (conv_hr + lReLU on the output tile,
// written there) and head_last_kernel (conv_last over the hidden map,
// staged back in chunks of 64 channels with W_last's rows for them).
//
// Bound: CUDA-core float32 FMAs, ~71 GFLOP per 720p frame at c = 64, nearly
// all in stage 1 (recomputed on the 10 x 18 halo region of each 8 x 16 tile).
// Stage 2 is 1/21 of the work: one thread per output pixel, all nine taps
// of W_last (6.9 KB at c = 64) held in shared memory. As in K3, c = 64 reuses
// the x tile for the hidden map; any other width (a multiple of 8) runs
// stage 1 in output groups and input chunks of up to 64 channels into a
// hidden region of its own (c * 720 bytes). The width is a template
// parameter CF (64, or 0: read at run time).
//
// The hidden map stays float32 in both feature types. The TPU kernel rounds
// its VMEM copy to the feature type (and the plain version does the same);
// here the buffer is float anyway, and in bfloat16 that second rounding put
// the head's mean error against float32 at 0.88-1.05 of its parity bound
// (0.002 std), where the output's own rounding alone is ~0.0012 std.
#include "common.cuh"

namespace pnp {

constexpr int HD_HR = TH + 2, HD_HC = TW + 2, HD_NH = HD_HR * HD_HC;  // hidden region 10 x 18
constexpr int HD_XR = TH + 4, HD_XC = TW + 4, HD_NX = HD_XR * HD_XC;  // x tile 12 x 20
constexpr int HD_PM = (HD_NH + PG - 1) / PG;                          // 6 pixels per thread
constexpr int HD_CO = 3;                                              // output channels

// dynamic shared memory of one block at width c: the x chunk tile, one tap
// of W_hr, W_last and, at widths other than 64, the hidden region
constexpr size_t head_smem(int c) {
  return sizeof(float) * (C * HD_NX + C * C + (size_t)9 * c * HD_CO +
                          (c == C ? 0 : (size_t)c * HD_NH));
}
// the widest one-launch block that fits (launch.ONE_LAUNCH_WIDTH holds the same number)
constexpr int HD_ONE_LAUNCH = 184;
static_assert(head_smem(HD_ONE_LAUNCH) <= SMEM_MAX && head_smem(HD_ONE_LAUNCH + PN) > SMEM_MAX,
              "HD_ONE_LAUNCH is the widest one-launch block that fits");
// the two-launch form: the x chunk tile and one tap of W_hr (launch 1); a
// chunk of the hidden map and W_last's rows for it (launch 2)
constexpr int HH_XR = TH + 2, HH_XC = TW + 2, HH_NX = HH_XR * HH_XC;  // x tile 10 x 18
constexpr int HH_PM = TH * TW / PG;                                   // 4 pixels per thread
constexpr size_t HH_SMEM = sizeof(float) * (C * HH_NX + C * C);
constexpr size_t HL_SMEM = sizeof(float) * (C * HD_NH + 9 * C * HD_CO);

template <typename T, int CF>
__global__ void __launch_bounds__(NT, 2)
    head_kernel(const T* __restrict__ x, const float* __restrict__ whr,
                const float* __restrict__ bhr, const float* __restrict__ wlast,
                const float* __restrict__ blast, T* __restrict__ out, int h, int w, int c_rt) {
  extern __shared__ float smem[];
  const int c = CF ? CF : c_rt;
  float* xs = smem;            // C x HD_NX input chunk tile
  float* ws = xs + C * HD_NX;  // one tap of W_hr
  float* wl = ws + C * C;      // W_last (9, c, 3)
  float* hs = CF == C ? xs : wl + 9 * c * HD_CO;  // c x HD_NH hidden map (the x tile at c = 64)

  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG, pg = threadIdx.x / CG;
  const size_t img = (size_t)b * h * w;

  copy_weights(wl, wlast, 9 * c * HD_CO);
  int base1[HD_PM];
  tile_bases<HD_PM>(base1, HD_NH, HD_HC, HD_XC);
  for (int co0 = 0; co0 < c; co0 += C) {  // output groups of the hidden map
    const int cw = min(C, c - co0);
    float acc[HD_PM][PN];
    zero(acc);
    for (int c0 = 0; c0 < c; c0 += C) {  // input chunks of x
      const int kc = min(C, c - c0);
      __syncthreads();  // every thread is done with the previous chunk
      load_tile<T>(xs, HD_NX, x + img * c, c, c0, kc, h, w, y0 - 2, x0 - 2, HD_XR, HD_XC);
      conv3x3<HD_PM>(acc, xs, HD_NX, HD_XC, base1, whr, ws, c, c, c0, kc, co0, cw, tn);
    }

    const bool live = tn * PN < cw;  // this thread's channels lie in the group
    float bv[PN];
#pragma unroll
    for (int n = 0; n < PN; ++n) bv[n] = live ? bhr[co0 + tn * PN + n] : 0.f;
    __syncthreads();  // every thread is done reading x before the hidden map overwrites it
    if (live) {
#pragma unroll
      for (int j = 0; j < HD_PM; ++j) {
        const int p = pg + PG * j;
        if (p >= HD_NH) continue;
        const int y = y0 - 1 + p / HD_HC, xx = x0 - 1 + p % HD_HC;
        const bool in = y >= 0 && y < h && xx >= 0 && xx < w;
#pragma unroll
        for (int n = 0; n < PN; ++n) {
          const float v = acc[j][n] + bv[n];
          hs[(co0 + tn * PN + n) * HD_NH + p] = in ? (v >= 0.f ? v : 0.1f * v) : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: one thread per output pixel
  const int p = threadIdx.x;
  if (p >= TH * TW) return;
  const int y = y0 + p / TW, xx = x0 + p % TW;
  if (y >= h || xx >= w) return;
  const int base = (p / TW) * HD_HC + p % TW;
  float o[HD_CO] = {blast[0], blast[1], blast[2]};
  for (int tap = 0; tap < 9; ++tap) {
    const float* row = hs + base + (tap / 3) * HD_HC + tap % 3;
    const float* wt = wl + tap * c * HD_CO;
#pragma unroll 8
    for (int ci = 0; ci < c; ++ci) {
      const float v = row[ci * HD_NH];
#pragma unroll
      for (int k = 0; k < HD_CO; ++k) o[k] = fmaf(v, wt[ci * HD_CO + k], o[k]);
    }
  }
  T* dst = out + (img + (size_t)y * w + xx) * HD_CO;
#pragma unroll
  for (int k = 0; k < HD_CO; ++k) dst[k] = from_f<T>(o[k]);
}

// Launch 1 of the two-launch form: hbuf = lrelu_0.1(conv3x3(x; W_hr) + b_hr)
// on the output tile, float32, in output groups and input chunks of 64.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    head_hidden_kernel(const T* __restrict__ x, const float* __restrict__ whr,
                       const float* __restrict__ bhr, float* __restrict__ hbuf, int h, int w,
                       int c) {
  extern __shared__ float smem[];
  float* xs = smem;            // C x HH_NX input chunk tile
  float* ws = xs + C * HH_NX;  // one tap of W_hr
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tn = threadIdx.x % CG, pg = threadIdx.x / CG;
  const size_t img = (size_t)b * h * w;
  int base[HH_PM];
  tile_bases<HH_PM>(base, TH * TW, TW, HH_XC);
  for (int co0 = 0; co0 < c; co0 += C) {
    const int cw = min(C, c - co0);
    float acc[HH_PM][PN];
    zero(acc);
    for (int c0 = 0; c0 < c; c0 += C) {
      const int kc = min(C, c - c0);
      __syncthreads();  // every thread is done with the previous chunk
      load_tile<T>(xs, HH_NX, x + img * c, c, c0, kc, h, w, y0 - 1, x0 - 1, HH_XR, HH_XC);
      conv3x3<HH_PM>(acc, xs, HH_NX, HH_XC, base, whr, ws, c, c, c0, kc, co0, cw, tn);
    }
    if (tn * PN >= cw) continue;
#pragma unroll
    for (int j = 0; j < HH_PM; ++j) {
      const int p = pg + PG * j;
      const int y = y0 + p / TW, xx = x0 + p % TW;
      if (y >= h || xx >= w) continue;
      float v[PN];
#pragma unroll
      for (int n = 0; n < PN; ++n) {
        const float a = acc[j][n] + bhr[co0 + tn * PN + n];
        v[n] = a >= 0.f ? a : 0.1f * a;
      }
      store8(hbuf + (img + (size_t)y * w + xx) * c + co0 + tn * PN, v);
    }
  }
}

// Launch 2: out = conv3x3(hbuf; W_last) + b_last, one thread per output
// pixel, the hidden map staged in chunks of 64 channels (zeros outside the
// image: conv_last's padding) with W_last's rows for the chunk.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    head_last_kernel(const float* __restrict__ hbuf, const float* __restrict__ wlast,
                     const float* __restrict__ blast, T* __restrict__ out, int h, int w, int c) {
  extern __shared__ float smem[];
  float* hs = smem;             // C x HD_NH hidden chunk
  float* wl = hs + C * HD_NH;   // (9, C, 3) rows of W_last
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const size_t img = (size_t)b * h * w;
  const int p = threadIdx.x;
  const int base = (p / TW) * HD_HC + p % TW;
  float o[HD_CO] = {blast[0], blast[1], blast[2]};
  for (int c0 = 0; c0 < c; c0 += C) {
    const int kc = min(C, c - c0);
    __syncthreads();  // every thread is done with the previous chunk
    load_tile<float>(hs, HD_NH, hbuf + img * c, c, c0, kc, h, w, y0 - 1, x0 - 1, HD_HR, HD_HC);
    for (int i = threadIdx.x; i < 9 * kc * HD_CO; i += NT) {
      const int tap = i / (kc * HD_CO), r = i % (kc * HD_CO);
      wl[i] = wlast[((size_t)tap * c + c0) * HD_CO + r];
    }
    __syncthreads();
    if (p >= TH * TW) continue;
    for (int tap = 0; tap < 9; ++tap) {
      const float* row = hs + base + (tap / 3) * HD_HC + tap % 3;
      const float* wt = wl + tap * kc * HD_CO;
#pragma unroll 8
      for (int ci = 0; ci < kc; ++ci) {
        const float v = row[ci * HD_NH];
#pragma unroll
        for (int k = 0; k < HD_CO; ++k) o[k] = fmaf(v, wt[ci * HD_CO + k], o[k]);
      }
    }
  }
  const int y = y0 + p / TW, xx = x0 + p % TW;
  if (p >= TH * TW || y >= h || xx >= w) return;
  T* dst = out + (img + (size_t)y * w + xx) * HD_CO;
#pragma unroll
  for (int k = 0; k < HD_CO; ++k) dst[k] = from_f<T>(o[k]);
}

template <typename T>
cudaError_t launch_head(const void* x, const void* whr, const void* bhr, const void* wlast,
                        const void* blast, void* hbuf, void* out, int b, int h, int w, int c,
                        cudaStream_t stream) {
  // one launch up to HD_ONE_LAUNCH, two through hbuf above it
  if (c < PN || c % PN || (c > HD_ONE_LAUNCH) != (hbuf != nullptr)) return cudaErrorInvalidValue;
  if ((size_t)b * h * w == 0) return cudaSuccess;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  const auto* xt = static_cast<const T*>(x);
  const auto* whrf = static_cast<const float*>(whr);
  const auto* bhrf = static_cast<const float*>(bhr);
  const auto* wlf = static_cast<const float*>(wlast);
  const auto* blf = static_cast<const float*>(blast);
  auto* o = static_cast<T*>(out);
  cudaError_t e;
  if (hbuf == nullptr) {
    const size_t smem = head_smem(c);
    auto k = c == C ? head_kernel<T, C> : head_kernel<T, 0>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return e;
    k<<<grid, NT, smem, stream>>>(xt, whrf, bhrf, wlf, blf, o, h, w, c);
    return cudaGetLastError();
  }
  auto* hb = static_cast<float*>(hbuf);
  if ((e = allow_smem(head_hidden_kernel<T>, HH_SMEM)) != cudaSuccess) return e;
  head_hidden_kernel<T><<<grid, NT, HH_SMEM, stream>>>(xt, whrf, bhrf, hb, h, w, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(head_last_kernel<T>, HL_SMEM)) != cudaSuccess) return e;
  head_last_kernel<T><<<grid, NT, HL_SMEM, stream>>>(hb, wlf, blf, o, h, w, c);
  return cudaGetLastError();
}

}  // namespace pnp

// dtype: 0 float32, 1 bfloat16. x: (b, h, w, c), c a multiple of 8;
// whr: (9, c, c); bhr: (c,); wlast: (9, c, 3); blast: (3,), weights float32;
// hbuf: null for the one-launch form, above HD_ONE_LAUNCH a float32 (b, h,
// w, c) scratch (two launches); out: (b, h, w, 3).
extern "C" int pnp_head(int dtype, const void* x, const void* whr, const void* bhr,
                        const void* wlast, const void* blast, void* hbuf, void* out, int b,
                        int h, int w, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pnp::launch_head<float>(x, whr, bhr, wlast, blast, hbuf, out, b, h, w, c, s);
  if (dtype == 1)
    return (int)pnp::launch_head<__nv_bfloat16>(x, whr, bhr, wlast, blast, hbuf, out, b, h, w,
                                                c, s);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of a one-launch block at width c, for the build
// report and chip_smoke.py's check of launch.ONE_LAUNCH_WIDTH
extern "C" int pnp_head_smem(int c) { return (int)pnp::head_smem(c); }
