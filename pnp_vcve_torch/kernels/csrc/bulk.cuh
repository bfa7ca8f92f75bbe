// Hopper's bulk-copy engine for the copy probe K13 (probe_ring.cu): mbarriers, bulk loads from device memory into shared
// memory that complete on one (cp.async.bulk ... mbarrier::complete_tx), and
// bulk stores from shared memory to device memory tracked in bulk groups
// (cp.async.bulk ... bulk_group, commit_group, wait_group). Every size is a
// multiple of 16 bytes and every address 16-byte aligned. A bulk group
// belongs to the thread that commits it: the thread that stores from a stage
// is the one that waits before the stage is loaded again.
#pragma once

#include <stdint.h>

namespace pnp {
namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// make initialised barriers visible to the async proxy (the bulk copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;\n" ::
                   : "memory");
}
// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` from device memory into shared memory, completing on `bar`, with
// an L2 evict-first hint: the copies read each byte once
__device__ __forceinline__ void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 pol;\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], pol;\n"
      "}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` from shared memory to device memory, in this thread's open bulk group
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
// close this thread's open bulk group
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
}  // namespace bulk
}  // namespace pnp
