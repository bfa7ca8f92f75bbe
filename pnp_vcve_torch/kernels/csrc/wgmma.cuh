// Hopper's asynchronous pieces for the wgmma designs of K2-K5
// (input_conv.cu, drt_block.cu, head.cu, conv3x3.cu) and of the probes K7,
// K8 and K10 (probe_mmsel.cu, probe_matmul.cu, probe_tapconv.cu; K10 int8
// on the s8 form): the
// mbarriers of a producer / consumer ring, bulk and cp.async copies that
// complete on them,
// shared-memory matrix descriptors and warpgroup matrix multiplies (wgmma)
// with A from registers (K8: from shared memory too, in bf16 and in int8)
// and B from shared memory.
//
// wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply-Accumulate"):
// the four warps of a warpgroup multiply a 64-row A by a B of N columns. With
// A in registers, warp i of the warpgroup holds rows 16 i .. 16 i + 15 in
// mma.sync's m16n8k16 (bf16) / m16n8k8 (tf32) fragment layout (mma.cuh), so
// ldmatrix loads it as for mma.sync. The sums d[4 j + 0 .. 3] of lane l
// (g = l / 4, t = l % 4) are row g, columns 8 j + 2 t, + 1, then row g + 8,
// the same columns. B is K-major (each column's K values contiguous, the
// "col" layout of the weights), 128-byte swizzled: rows of 128 bytes, in
// atoms of 8 rows (1024 bytes, 1024-aligned) whose 16-byte chunk j of row r
// sits at chunk j ^ r; a k-step 32 bytes further is the descriptor's start
// address 32 bytes further. K7, K8 and K10 read B MN-major instead (desc_mn).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace pnp {
namespace wg {

// ---- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (bulk copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and expect `bytes` more of asynchronous copies this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one arrival on bar once this thread's earlier cp.async copies have landed
// (.noinc: the arrival is one of the barrier's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// bytes (a multiple of 16, both ends 16-byte aligned) from global memory to
// shared memory, completing on bar's transaction count
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// a barrier among `count` threads (a multiple of 32) under id (1-15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// move registers between warpgroups: each of the warpgroup's threads may use
// at most N (a multiple of 8) from here on; every warp of it executes this
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma --------------------------------------------------------------------

// descriptor of a K-major, 128-byte swizzled operand at p (1024-aligned
// atoms): stride 1024 bytes between 8-row groups; the leading offset is
// unused by swizzled K-major layouts
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// descriptor of a K-major, 64-byte swizzled operand at p: rows of 64 bytes
// in atoms of 8 rows (512 bytes, 512-aligned) whose 16-byte chunk j of row
// r sits at chunk j ^ ((r / 2) % 4); stride 512 bytes between 8-row groups
// (K10 int8's resident weights: 64 input channels a row, two k-steps of 32)
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}
// descriptor of a K-major, 32-byte swizzled operand at p: rows of 32 bytes
// (one k-step) in atoms of 8 rows (256 bytes, 256-aligned) whose 16-byte
// chunk j of row r sits at chunk j ^ ((r / 4) % 2); stride 256 bytes between
// 8-row groups (K2's 3-channel lr part, one k-step deep)
__device__ __forceinline__ uint64_t desc_sw32(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}
// descriptor of an MN-major operand at p (K7's window rows, K10's weights:
// each K row's SW bytes of N values contiguous, as they lie in device
// memory), SW-byte swizzled (SW 64 or 128): K rows of SW bytes in atoms of 8
// rows (8 SW bytes, 8 SW-aligned) whose 16-byte chunk j of row r sits at
// chunk j ^ ((SW r / 128) % (SW / 16)) (mn_chunk). The stride between 8-row
// groups along K is 8 SW bytes; N spans one atom, so the stride between
// atoms along N is never used and is given the same value. A k-step (16
// rows) is 16 SW bytes further.
template <int SW>
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  static_assert(SW == 64 || SW == 128, "64- or 128-byte swizzle");
  constexpr uint64_t grp = 8 * SW >> 4;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (grp << 16) | (grp << 32) |
         ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}
// the byte offset of chunk j (16 bytes) of K row r in an MN-major SW-byte
// swizzled operand (desc_mn)
__host__ __device__ constexpr int mn_chunk(int sw, int r, int j) {
  return sw * r + 16 * (j ^ ((sw * r >> 7) & (sw / 16 - 1)));
}
// the descriptor `bytes` further along K (a multiple of 16, inside the atom)
__device__ __forceinline__ uint64_t desc_add(uint64_t d, int bytes) { return d + (bytes >> 4); }
// order this thread's view of shared memory, written by other threads'
// stores or cp.async and acquired through an mbarrier, before its wgmma
// (the async proxy) read it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep registers where they are across an asynchronous wgmma: the compiler
// sees them read and written here, after the wait, and neither reuses nor
// moves them while the multiply may still read or write them
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]));
}

template <int N>
__device__ __forceinline__ void hold(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]));
}

// v, which the compiler may not assume it knows: values derived from it are
// computed after this point and not hoisted (and kept live) from before it
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

#define PNP_WG_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PNP_WG_DREGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (64 x 64, float32) += a (64 x 16 bf16, registers) * B (16 x 64 bf16 at desc)
__device__ __forceinline__ void mma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PNP_WG_DREGS
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : PNP_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (64 x 64, float32) += a (64 x 8 tf32, registers) * B (8 x 64 tf32 at desc)
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PNP_WG_DREGS
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : PNP_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// the same with B MN-major (desc_mn<128>; transposed, bf16 only)
__device__ __forceinline__ void mma_bf16_mn(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PNP_WG_DREGS
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : PNP_WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (64 x 64, float32) += A (64 x 16 bf16 at desc_a, K-major: desc_sw128)
// * B (16 x 64 bf16 at desc_b, MN-major: desc_mn<128>), both from shared
// memory (K8)
__device__ __forceinline__ void mma_bf16_ss_mn(float (&d)[32], uint64_t desc_a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PNP_WG_DREGS
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : PNP_WG_D32
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
#define PNP_WG_I32                                                                          \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),       \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), \
      "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),          \
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),          \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
// d (64 x 64, int32) += a (64 x 32 int8, registers: mma.sync's m16n8k32 A
// fragments, which ldmatrix loads as for bf16) * B (32 x 64 int8 at desc,
// K-major: the s8 form reads B K-major only); exact, wrapping
__device__ __forceinline__ void mma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PNP_WG_DREGS
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : PNP_WG_I32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (64 x 64, int32) += A (64 x 32 int8 at desc_a, K-major: desc_sw128) * B
// (32 x 64 int8 at desc_b, K-major: desc_sw128), both from shared memory
// (K8 int8); exact, wrapping
__device__ __forceinline__ void mma_s8_ss(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PNP_WG_DREGS
      "%32, %33, p;\n"
      "}\n"
      : PNP_WG_I32
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
#undef PNP_WG_I32
#undef PNP_WG_D32
#undef PNP_WG_DREGS

// d (64 x 32, float32) += a (64 x 16 bf16, registers) * B (16 x 32 bf16 at
// desc, MN-major: desc_mn<64>)
__device__ __forceinline__ void mma_bf16_n32_mn(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 32, float32) += a (64 x 8 tf32, registers) * B (8 x 32 tf32 at desc)
__device__ __forceinline__ void mma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

}  // namespace wg
}  // namespace pnp
