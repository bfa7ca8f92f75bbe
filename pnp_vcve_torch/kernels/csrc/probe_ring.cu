// K13: chunked copies of a (1, hp, wp, lanes) bf16 array in chunks of 8
// rows, through a ring of shared-memory stages fed by TMA bulk copies
// (ring_copy) or as a plain streamed copy (stream_copy). With write_out the
// output is the array itself; without, every chunk is still read and the
// output is only the last chunk's first row, pixels 0..7: (1, 8, lanes).
//
// Replaces the TPU probes tools/dma_probe.py: run (:86, pallas_call :104),
// a 10-slot VMEM ring of chunk DMAs started `depth` grid steps ahead, each
// split into `split` column segments with a semaphore each, and
// run_pipelined (:149, pallas_call :173), the same traffic through a
// pipelined BlockSpec.
//
// ring_copy: a TPU chunk (8 x 656 x 128 bf16 = 1.34 MB) fits in no
// shared memory, so each CTA owns a column strip of RC_STRIP pixels and
// walks all chunks in order through a ring of depth + 1 stages (8 rows x
// the strip). Thread 0 starts chunk k + depth as soon as the stage chunk
// k - 1 used is free (a block barrier after each step), as the TPU kernel
// starts rp + depth at step rp; each stage's copy is `split` column
// segments of the strip's rows, one cp.async.bulk a row, each segment with
// an mbarrier of its own that counts its bytes. Every thread waits on the
// chunk's barriers, then (write_out) stores its 16-byte pieces of the stage.
//
// stream_copy: one block per chunk, 16-byte loads and stores. Without
// write_out its loads feed an xor that an empty asm statement consumes, so
// the compiler keeps them.
//
// Bound: bytes, the array read once and the output written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pnp {

constexpr int RC_ROWS = 8;        // rows of a chunk (a TPU grid step)
constexpr int RC_STRIP = 4;       // pixels of a CTA's column strip
constexpr int RC_THREADS = 128;
constexpr int RC_MAX_STAGES = 10; // the TPU ring's NSLOT
constexpr int SC_THREADS = 1024;
constexpr size_t SMEM_MAX = 227 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
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
// a TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ inline size_t ring_bar_bytes(int stages, int split) {
  return ((size_t)stages * split * sizeof(uint64_t) + 127) / 128 * 128;
}
inline size_t ring_smem(int px_bytes, int stages, int split) {
  return ring_bar_bytes(stages, split) + (size_t)stages * RC_ROWS * RC_STRIP * px_bytes;
}

// px_bytes: one pixel's lanes in bytes (a multiple of 16); zrow: one image
// row in bytes
__global__ void __launch_bounds__(RC_THREADS)
    ring_copy_kernel(const uint8_t* __restrict__ z, uint8_t* __restrict__ out, int nchunks,
                     int wp, int px_bytes, int stages, int split, int write_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [stage][segment]
  uint8_t* ring = smem + ring_bar_bytes(stages, split);
  const int strip_bytes = RC_STRIP * px_bytes;  // a stage row's room
  const int stage_bytes = RC_ROWS * strip_bytes;
  const int px0 = blockIdx.x * RC_STRIP;
  const int nvec = min(RC_STRIP, wp - px0) * px_bytes / 16;  // this strip's row in 16 B pieces
  const size_t zrow = (size_t)wp * px_bytes;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages * split; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\nfence.proxy.async.shared::cta;" ::
                     : "memory");
  }
  __syncthreads();

  // thread 0: chunk k into its stage, `split` column segments, a barrier each
  auto issue = [&](int k) {
    const int st = k % stages;
    uint8_t* dst = ring + (size_t)st * stage_bytes;
    const uint8_t* src = z + (size_t)k * RC_ROWS * zrow + (size_t)px0 * px_bytes;
    for (int s = 0; s < split; ++s) {
      const int lo = 16 * (nvec * s / split), hi = 16 * (nvec * (s + 1) / split);
      uint64_t* bar = &bars[st * split + s];
      mbar_expect_tx(bar, RC_ROWS * (hi - lo));
      if (hi > lo)
        for (int r = 0; r < RC_ROWS; ++r)
          bulk_load(dst + r * strip_bytes + lo, src + r * zrow + lo, hi - lo, bar);
    }
  };

  if (threadIdx.x == 0)
    for (int k = 0; k < stages && k < nchunks; ++k) issue(k);
  for (int k = 0; k < nchunks; ++k) {
    // the stage of chunk k - 1 is free (the barrier closing the last step):
    // start chunk k + depth into it
    if (threadIdx.x == 0 && k >= 1 && k + stages - 1 < nchunks) issue(k + stages - 1);
    const int st = k % stages;
    const uint32_t parity = (k / stages) & 1;
    for (int s = 0; s < split; ++s) mbar_wait(&bars[st * split + s], parity);
    const uint8_t* stage = ring + (size_t)st * stage_bytes;
    if (write_out) {
      uint8_t* dst = out + (size_t)k * RC_ROWS * zrow + (size_t)px0 * px_bytes;
      for (int i = threadIdx.x; i < RC_ROWS * nvec; i += RC_THREADS) {
        const int r = i / nvec, v = i % nvec;
        reinterpret_cast<uint4*>(dst + r * zrow)[v] =
            reinterpret_cast<const uint4*>(stage + r * strip_bytes)[v];
      }
    } else if (k == nchunks - 1 && px0 < RC_ROWS) {
      // the last chunk's first row, pixels px0 .. 7 of out (8, lanes)
      const int nv = min(RC_ROWS - px0, min(RC_STRIP, wp - px0)) * px_bytes / 16;
      for (int v = threadIdx.x; v < nv; v += RC_THREADS)
        reinterpret_cast<uint4*>(out + (size_t)px0 * px_bytes)[v] =
            reinterpret_cast<const uint4*>(stage)[v];
    }
    __syncthreads();  // every thread is done with stage st before it is refilled
  }
}

// chunk_vecs: one chunk in 16 B pieces; tail_vecs: the last chunk's first
// row, pixels 0..7, in 16 B pieces
__global__ void __launch_bounds__(SC_THREADS)
    stream_copy_kernel(const uint4* __restrict__ z, uint4* __restrict__ out, size_t chunk_vecs,
                       int nchunks, int tail_vecs, int write_out) {
  const int k = blockIdx.x;
  const uint4* src = z + (size_t)k * chunk_vecs;
  if (write_out) {
    uint4* dst = out + (size_t)k * chunk_vecs;
#pragma unroll 4
    for (size_t i = threadIdx.x; i < chunk_vecs; i += SC_THREADS) dst[i] = src[i];
    return;
  }
  uint32_t acc = 0;
#pragma unroll 4
  for (size_t i = threadIdx.x; i < chunk_vecs; i += SC_THREADS) {
    const uint4 v = src[i];
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  asm volatile("" ::"r"(acc));  // keep the reads
  if (k == nchunks - 1)
    for (int i = threadIdx.x; i < tail_vecs; i += SC_THREADS) out[i] = src[i];
}

}  // namespace pnp

// z (1, hp, wp, lanes) bf16 with hp % 8 == 0, wp >= 8, lanes % 8 == 0; out
// the same shape (write_out) or (1, 8, lanes); split in {1, 2, 4}; depth in
// 0 .. 9 chunks started ahead (a ring of depth + 1 stages).
extern "C" int pnp_ring_copy(const void* z, void* out, int hp, int wp, int lanes, int split,
                             int depth, int write_out, void* stream) {
  const int px_bytes = lanes * 2, stages = depth + 1;
  if (hp < pnp::RC_ROWS || hp % pnp::RC_ROWS || wp < pnp::RC_ROWS || lanes < 8 || lanes % 8 ||
      (split != 1 && split != 2 && split != 4) || depth < 0 || stages > pnp::RC_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pnp::ring_smem(px_bytes, stages, split);
  if (smem > pnp::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pnp::ring_copy_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (wp + pnp::RC_STRIP - 1) / pnp::RC_STRIP;
  pnp::ring_copy_kernel<<<grid, pnp::RC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(z), static_cast<uint8_t*>(out), hp / pnp::RC_ROWS, wp,
      px_bytes, stages, split, write_out);
  return (int)cudaGetLastError();
}

// z and out as for pnp_ring_copy.
extern "C" int pnp_stream_copy(const void* z, void* out, int hp, int wp, int lanes, int write_out,
                               void* stream) {
  if (hp < pnp::RC_ROWS || hp % pnp::RC_ROWS || wp < pnp::RC_ROWS || lanes < 8 || lanes % 8)
    return (int)cudaErrorInvalidValue;
  const int nchunks = hp / pnp::RC_ROWS;
  const size_t chunk_vecs = (size_t)pnp::RC_ROWS * wp * lanes * 2 / 16;
  pnp::stream_copy_kernel<<<nchunks, pnp::SC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(z), static_cast<uint4*>(out), chunk_vecs, nchunks,
      pnp::RC_ROWS * lanes * 2 / 16, write_out);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one ring_copy block, for the build report and the
// wrapper's check
extern "C" int pnp_ring_copy_smem(int lanes, int depth, int split) {
  return (int)pnp::ring_smem(lanes * 2, depth + 1, split);
}
