// Warp-level tensor-core helpers: mma.sync in bf16 (m16n8k16, float32
// sums) and in int8 (m16n8k32, int32 sums), ldmatrix, and the fragment-to-
// thread maps of the PTX ISA ("Matrix Fragments for mma.m16n8k16" and
// "... mma.m16n8k32"). The probe kernels (K7, K8, K10) are built on them.
//
// One k-step is 32 bytes of depth in both types: 16 bf16 or 32 int8 values.
// Seen as bytes, the two types' fragments are laid out alike, so one
// ldmatrix address pattern serves both. Lane l of a warp, g = l / 4 and
// t = l % 4:
//
//   A, 16 rows x one k-step, row-major ("row"): a[0] row g, a[1] row g + 8,
//     a[2] row g, a[3] row g + 8; a[0] and a[1] hold bytes [4t, 4t + 4) of
//     the step's first 16 bytes (bf16 k = 2t, 2t + 1; int8 k = 4t .. 4t + 3),
//     a[2] and a[3] the same bytes of its second 16 bytes.
//   B, one k-step x 8 columns, stored column by column ("col", i.e. as
//     Bt[n][k]): b[0] column g, bytes [4t, 4t + 4) of the first 16 bytes;
//     b[1] the same of the second 16 bytes.
//   C and D, 16 x 8: c[0], c[1] row g, columns 2t, 2t + 1; c[2], c[3] row
//     g + 8, the same columns.
//
// The lower-indexed element of a pair (or quad) sits in the lower bits of
// its 32-bit register.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace pnp {

constexpr int KSTEP_BYTES = 32;  // depth of one mma k-step in bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit values, each row 16 contiguous bytes in
// shared memory: lanes 8i .. 8i + 7 give the addresses of matrix i's rows 0-7
// and r[i] receives matrix i. Without .trans lane l holds row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1; with .trans it holds column l / 4, rows
// 2 (l % 4) and 2 (l % 4) + 1. On int8 data the untransposed load gives lane
// l row l / 4, bytes [4 (l % 4), 4 (l % 4) + 4): the int8 fragments' layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// One k-step, chosen by the sum type: float32 sums take bf16 inputs,
// d += a (16 x 16) * b (16 x 8) ...
__device__ __forceinline__ void mma_step(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ... and int32 sums int8 inputs, d += a (16 x 32) * b (32 x 8) (wrapping,
// no saturation).
__device__ __forceinline__ void mma_step(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The sum type of each input type.
template <typename T> struct Acc;
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

// ldmatrix address of lane `lane` for an A fragment: 16 rows of `ld` bytes
// from `base` (row 0, the k-step's first byte).
__device__ __forceinline__ const uint8_t* a_frag_addr(const uint8_t* base, int ld, int lane) {
  return base + (lane % 16) * ld + (lane / 16) * 16;
}
// ldmatrix address for the B fragments of two 8-column tiles (columns n0 ..
// n0 + 15) stored as Bt[n][k], `ld` bytes a column, from `base` (column n0,
// the k-step's first byte): r[0], r[1] are the first tile's b[0], b[1] and
// r[2], r[3] the second tile's.
__device__ __forceinline__ const uint8_t* b_pair_addr(const uint8_t* base, int ld, int lane) {
  return base + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 16;
}

// One k-step of a warp's MT x 4 tiles of 16 x 8: acc[m][n] += A_m * B_n.
// a[m] is this lane's ldmatrix address of A tile m (a_frag_addr) and b that
// of the first pair of B tiles (b_pair_addr), both at the k-step's first
// byte; the second pair lies 16 columns (16 * b_ld bytes) further.
template <int MT, typename AccT>
__device__ __forceinline__ void warp_kstep(AccT (&acc)[MT][4][4], const uint8_t* const (&a)[MT],
                                           const uint8_t* b, int b_ld) {
  uint32_t bf[2][4];
  ldmatrix_x4(bf[0], b);
  ldmatrix_x4(bf[1], b + 16 * b_ld);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t af[4];
    ldmatrix_x4(af, a[m]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mma_step(acc[m][2 * p], af, bf[p][0], bf[p][1]);
      mma_step(acc[m][2 * p + 1], af, bf[p][2], bf[p][3]);
    }
  }
}

// Eight values of T from global memory (16 bytes of bf16, 8 of int8); p
// aligned to their size.
__device__ __forceinline__ void load8_raw(const __nv_bfloat16* p, __nv_bfloat16 (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = h[k];
}
__device__ __forceinline__ void load8_raw(const int8_t* p, int8_t (&v)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const int8_t* h = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = h[k];
}

// Stage 64 columns of rows [k0, k0 + kpad) of a row-major (rows, n) matrix
// b into shared memory transposed, bt[c * ld + k * sizeof(T)] = b[k0 + k][n0
// + c]: the "col" layout of the B fragments. Rows at or past k0 + kc and
// columns at or past n_end are zeros. n, n0 and n_end are multiples of 8;
// each thread reads eight columns of a row at once.
template <typename T, int NTHREADS>
__device__ __forceinline__ void stage_bt(uint8_t* bt, int ld, const T* b, int n, int k0, int kc,
                                         int kpad, int n0, int n_end) {
  for (int i = threadIdx.x; i < kpad * 8; i += NTHREADS) {
    const int k = i / 8, c = (i % 8) * 8;
    T v[8];
    if (k < kc && n0 + c < n_end) {
      load8_raw(b + (size_t)(k0 + k) * n + n0 + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = T();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) *reinterpret_cast<T*>(bt + (c + j) * ld + k * sizeof(T)) = v[j];
  }
}

}  // namespace pnp
