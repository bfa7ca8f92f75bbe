// Hopper's tensor memory accelerator (TMA) for the probes K7, K8 and K10
// (probe_mmsel.cu, probe_matmul.cu, probe_tapconv.cu): a tiled tensor map,
// encoded on the host by libcuda's encoder, looked up through the CUDA
// runtime (nothing links against libcuda); the tensor load that copies one box of it into
// shared memory, completing on an mbarrier's transaction count (the whole
// box's bytes, also where it passes the tensor), elements outside the
// tensor arriving as zeros; and the tensor store of a box back. With a swizzle of
// SW bytes (64 or 128) the box lands as rows of SW bytes whose 16-byte
// chunk j, at byte a of a 1024-byte aligned destination, sits at chunk j ^
// ((a / 128) % (SW / 16)): the layouts of wgmma.cuh: mn_chunk and
// wg_conv.cuh: xpiece.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace pnp {
namespace tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or null where it has none
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// map: a tensor of `type` (bf16, float32, int32 or uint8) at base of `rank` dimensions,
// dims[0] innermost and contiguous, strides[i] the bytes between steps of
// dimension i + 1 (each a multiple of 16), boxes of box[0] x ... elements,
// swizzled by `swizzle` bytes (0, 64 or 128; box[0] elements at most that)
inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          int rank, const uint64_t* dims, const uint64_t* strides,
                          const uint32_t* box, int swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, type, (cuuint32_t)rank,
                        const_cast<void*>(base), d, s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the box of `map` at element coordinates (c0, c1[, c2[, c3]]) into dst,
// completing on bar
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                        int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
// the box of `map` at (c0, c1) from src, in this thread's open bulk group
// (bulk.cuh: commit, wait_read); parts outside the tensor are not written
__device__ __forceinline__ void store_2d(const CUtensorMap* map, int c0, int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// the box of `map` at (c0, c1, c2) from src, in this thread's open bulk
// group (bulk.cuh: commit, wait_read); parts outside the tensor are not
// written
__device__ __forceinline__ void store_3d(const CUtensorMap* map, int c0, int c1, int c2,
                                         const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// wait until this thread's bulk groups have completed (their writes done)
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// fetch the map's descriptor ahead of its first use
__device__ __forceinline__ void prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

}  // namespace tma
}  // namespace pnp
