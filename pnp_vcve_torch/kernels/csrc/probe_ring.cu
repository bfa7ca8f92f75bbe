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
// Bound: bytes, the array read once and the output written once. Both
// kernels only move data, so the design's one aim is to keep enough bytes
// in flight on every SM, with few instructions a byte.
//
// ring_copy: persistent blocks, one a SM, of one warp whose lane 0 issues
// every copy. The work is a list of items in chunk order: (chunk, column
// segment, row, byte range), each one row's part of one segment, cut into
// `pieces` equal ranges of at most one stage (48 KB where depth + 1 of
// them fit, less above depth 3; 16-byte aligned, a multiple of 16). Item i goes to block i % grid, so the blocks
// walk the chunks together, in order, as the TPU's ring does, and differ
// by at most one item. A block's ring has depth + 1 stages: while it stores
// item j it has items j + 1 .. j + depth in flight. Each item is one bulk
// load onto its stage's mbarrier (expect_tx of its bytes); once it has
// landed, one bulk store (write_out) from the stage to the output; each
// step closes a bulk group, empty where it stored nothing. The stage refilled then is item j - 1's, whose
// store has had a step to read it (wait_group.read 1), so that item j's
// store runs on while the thread waits (waiting for the newest store would
// keep one store at a time in flight). No byte passes through registers and
// no block-wide barrier closes a step. The thread keeps the item index's
// digits as a cursor, so a step costs no 64-bit division: one thread
// issues every copy of its SM, and a handful of 64-bit divisions a step
// (each a long subroutine) cost about as much as an item's copy. Without
// write_out the block holding a piece of the last chunk's first row stores
// the part of it that lies in pixels 0..7. `split` no longer sets how many
// copies a chunk takes: the segments only bound the items, each still one
// large copy.
//
// stream_copy: a grid of SC_BLOCKS_PER_SM blocks a SM walking the array in
// 16-byte pieces; each thread issues SC_UNROLL independent streaming loads
// (ld.global.cs) before their stores (st.global.cs). Without write_out the
// loads feed an xor, and block 0 copies the last chunk's first row. The
// xor is stored through `sink` where that pointer is not null (the C entry
// passes null), which keeps the loads: ptxas drops loads whose values only
// an empty asm statement consumes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk.cuh"

namespace pnp {

constexpr int RC_ROWS = 8;         // rows of a chunk (a TPU grid step)
constexpr int RC_THREADS = 32;     // one warp; lane 0 issues every copy
constexpr int RC_MAX_STAGES = 10;  // the TPU ring's NSLOT
constexpr int RC_STAGE_MAX = 49152;
constexpr int RC_BAR_BYTES = 256;  // RC_MAX_STAGES mbarriers and the items the stages hold
constexpr int SC_THREADS = 256;
constexpr int SC_BLOCKS_PER_SM = 8;
constexpr int SC_UNROLL = 8;
constexpr size_t SMEM_MAX = 227 * 1024;
static_assert(RC_MAX_STAGES * (8 + 16) <= RC_BAR_BYTES, "the barriers and items fit their room");

// a stage's bytes: at most RC_STAGE_MAX, and `stages` of them fit SMEM_MAX
__host__ __device__ inline int ring_stage_bytes(int stages) {
  const int fit = (int)((SMEM_MAX - RC_BAR_BYTES) / stages) / 128 * 128;
  return fit < RC_STAGE_MAX ? fit : RC_STAGE_MAX;
}
inline size_t ring_smem(int stages) {
  return RC_BAR_BYTES + (size_t)stages * ring_stage_bytes(stages);
}

// Item i = ((chunk split + s) 8 + r) pieces + p covers 16-byte pieces
// [lo, hi) of row 8 chunk + r, where segment s of a row's nvec pieces is
// [nvec s / split, nvec (s + 1) / split) and lo, hi cut it into `pieces`
// equal ranges (the mirror: kernels/probes.py: ring_items). A block walks
// i = blockIdx.x, + gridDim.x, ... with the digits of i kept as a cursor
// that adds the digits of gridDim.x: no division a step but the range's.
struct RingCursor {
  int p, r, s;
  int64_t chunk;
};
__device__ __forceinline__ RingCursor ring_digits(int64_t i, int split, int pieces) {
  RingCursor d;
  d.p = (int)(i % pieces);
  i /= pieces;
  d.r = (int)(i % RC_ROWS);
  i /= RC_ROWS;
  d.s = (int)(i % split);
  d.chunk = i / split;
  return d;
}
__device__ __forceinline__ void ring_advance(RingCursor& d, const RingCursor& g, int split,
                                             int pieces) {
  d.p += g.p;
  int carry = d.p >= pieces;
  d.p -= carry * pieces;
  d.r += g.r + carry;
  carry = d.r >= RC_ROWS;
  d.r -= carry * RC_ROWS;
  d.s += g.s + carry;
  carry = d.s >= split;
  d.s -= carry * split;
  d.chunk += g.chunk + carry;
}
// floor(a * b / c) for 0 <= b <= c: in 32 bits where a * b fits them
__device__ __forceinline__ int64_t muldiv(int a, int b, int c) {
  const uint64_t ab = (uint64_t)a * (uint32_t)b;
  return ab <= 0xffffffffull ? (uint32_t)ab / (uint32_t)c : ab / (uint64_t)c;
}

struct RingItem {
  int64_t off;  // bytes from the array's start
  int bytes;
};
__device__ __forceinline__ RingItem ring_item(const RingCursor& d, int nvec, int split,
                                              int pieces) {
  const int seg_lo = (int)muldiv(nvec, d.s, split);
  const int len = (int)muldiv(nvec, d.s + 1, split) - seg_lo;
  const int lo = seg_lo + (int)muldiv(len, d.p, pieces);
  const int hi = seg_lo + (int)muldiv(len, d.p + 1, pieces);
  return {((d.chunk * RC_ROWS + d.r) * nvec + lo) * 16, (hi - lo) * 16};
}

// tail: the last chunk's first row's first 8 pixels, bytes [tail, tail +
// tail_bytes) of the array (write_out == 0)
__global__ void __launch_bounds__(RC_THREADS)
    ring_copy_kernel(const uint8_t* __restrict__ z, uint8_t* __restrict__ out, int64_t n_items,
                     int nvec, int split, int pieces, int stages, int stage_bytes, int write_out,
                     int64_t tail, int tail_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  RingItem* held = reinterpret_cast<RingItem*>(smem + RC_MAX_STAGES * sizeof(uint64_t));
  uint8_t* ring = smem + RC_BAR_BYTES;
  if (threadIdx.x != 0) return;
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int mine = n_items > first ? (int)((n_items - first + step - 1) / step) : 0;
  for (int s = 0; s < stages; ++s) bulk::mbar_init(&bars[s], 1);
  bulk::fence_mbar_init();
  const RingCursor g = ring_digits(step, split, pieces);
  RingCursor next = ring_digits(first, split, pieces);  // the next item to load

  auto issue = [&](int j) {  // this block's item j (at `next`) into stage j % stages
    const RingItem it = ring_item(next, nvec, split, pieces);
    ring_advance(next, g, split, pieces);
    const int st = j % stages;
    held[st] = it;
    bulk::mbar_expect_tx(&bars[st], it.bytes);
    bulk::load(ring + (size_t)st * stage_bytes, z + it.off, it.bytes, &bars[st]);
  };
  for (int j = 0; j < stages && j < mine; ++j) issue(j);
  for (int j = 0; j < mine; ++j) {
    const int st = j % stages;
    bulk::mbar_wait(&bars[st], (j / stages) & 1);
    const RingItem it = held[st];
    const uint8_t* stage = ring + (size_t)st * stage_bytes;
    if (write_out) {
      bulk::store(out + it.off, stage, it.bytes);
    } else if (it.off < tail + tail_bytes && it.off + it.bytes > tail) {
      const int64_t a = it.off > tail ? it.off : tail;
      const int64_t b = it.off + it.bytes < tail + tail_bytes ? it.off + it.bytes
                                                               : tail + tail_bytes;
      bulk::store(out + (a - tail), stage + (a - it.off), (uint32_t)(b - a));
    }
    // every step closes a bulk group, an empty one where it stored nothing,
    // so that group j is item j's and wait_read<1> below has read item j - 1
    bulk::commit();
    // refill the stage of the item before this one, whose store has had a
    // step to read it, so that this item's store runs on meanwhile; a ring of
    // one stage waits for this item's store
    if (stages == 1) {
      bulk::wait_read<0>();
      if (j + 1 < mine) issue(j + 1);
    } else if (j >= 1 && j - 1 + stages < mine) {
      bulk::wait_read<1>();
      issue(j - 1 + stages);
    }
  }
  bulk::wait_read<0>();  // the stores have read the stages before the block's shared memory goes
}

// nvec: the array in 16-byte pieces; tail_src: the last chunk's first row,
// tail_vecs 16-byte pieces of it (write_out == 0)
__global__ void __launch_bounds__(SC_THREADS)
    stream_copy_kernel(const uint4* __restrict__ z, uint4* __restrict__ out, int64_t nvec,
                       const uint4* __restrict__ tail_src, int tail_vecs, int write_out,
                       uint32_t* sink) {
  const int64_t stride = (int64_t)gridDim.x * SC_THREADS;
  int64_t i = (int64_t)blockIdx.x * SC_THREADS + threadIdx.x;
  if (write_out) {
    for (; i + (SC_UNROLL - 1) * stride < nvec; i += SC_UNROLL * stride) {
      uint4 v[SC_UNROLL];
#pragma unroll
      for (int u = 0; u < SC_UNROLL; ++u) v[u] = __ldcs(z + i + u * stride);
#pragma unroll
      for (int u = 0; u < SC_UNROLL; ++u) __stcs(out + i + u * stride, v[u]);
    }
    for (; i < nvec; i += stride) __stcs(out + i, __ldcs(z + i));
    return;
  }
  uint32_t acc = 0;
  for (; i + (SC_UNROLL - 1) * stride < nvec; i += SC_UNROLL * stride) {
    uint4 v[SC_UNROLL];
#pragma unroll
    for (int u = 0; u < SC_UNROLL; ++u) v[u] = __ldcs(z + i + u * stride);
#pragma unroll
    for (int u = 0; u < SC_UNROLL; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; i < nvec; i += stride) {
    const uint4 v = __ldcs(z + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (sink) sink[blockIdx.x * SC_THREADS + threadIdx.x] = acc;  // keeps the reads
  if (blockIdx.x == 0)
    for (int t = threadIdx.x; t < tail_vecs; t += SC_THREADS) out[t] = tail_src[t];
}

inline bool copy_shape_ok(int hp, int wp, int lanes) {
  return hp >= RC_ROWS && hp % RC_ROWS == 0 && wp >= RC_ROWS && lanes >= 8 && lanes % 8 == 0;
}

}  // namespace pnp

// z (1, hp, wp, lanes) bf16 with hp % 8 == 0, wp >= 8, lanes % 8 == 0; out
// the same shape (write_out) or (1, 8, lanes); split in {1, 2, 4}; depth in
// 0 .. 9 items loading ahead of the one in use (a ring of depth + 1
// stages); grid blocks (one a SM); pieces: the ranges each row's segment
// is cut into, each at most a stage (kernels/probes.py: ring_schedule).
extern "C" int pnp_ring_copy(const void* z, void* out, int hp, int wp, int lanes, int split,
                             int depth, int write_out, int grid, int pieces, void* stream) {
  const int stages = depth + 1;
  if (!pnp::copy_shape_ok(hp, wp, lanes) || (split != 1 && split != 2 && split != 4) ||
      depth < 0 || stages > pnp::RC_MAX_STAGES || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int nvec = wp * lanes / 8, stage_bytes = pnp::ring_stage_bytes(stages);
  const int seg_max = (nvec + split - 1) / split;
  if (pieces < 1 || pieces > nvec / split || (int64_t)pieces * (stage_bytes / 16) < seg_max)
    return (int)cudaErrorInvalidValue;
  const size_t smem = pnp::ring_smem(stages);
  if (smem > pnp::SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pnp::ring_copy_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_items = (int64_t)hp / pnp::RC_ROWS * split * pnp::RC_ROWS * pieces;
  const int64_t tail = (int64_t)(hp - pnp::RC_ROWS) * nvec * 16;
  pnp::ring_copy_kernel<<<grid, pnp::RC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(z), static_cast<uint8_t*>(out), n_items, nvec, split, pieces,
      stages, stage_bytes, write_out, tail, pnp::RC_ROWS * lanes * 2);
  return (int)cudaGetLastError();
}

// z and out as for pnp_ring_copy; grid blocks (SC_BLOCKS_PER_SM a SM).
extern "C" int pnp_stream_copy(const void* z, void* out, int hp, int wp, int lanes, int write_out,
                               int grid, void* stream) {
  if (!pnp::copy_shape_ok(hp, wp, lanes) || grid < 1) return (int)cudaErrorInvalidValue;
  const int64_t nvec = (int64_t)hp * wp * lanes / 8;
  const uint4* zv = static_cast<const uint4*>(z);
  pnp::stream_copy_kernel<<<grid, pnp::SC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zv, static_cast<uint4*>(out), nvec, zv + (int64_t)(hp - pnp::RC_ROWS) * wp * lanes / 8,
      lanes, write_out, nullptr);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one ring_copy block (the stage does not depend on
// lanes or split), for the build report and the wrapper's check
extern "C" int pnp_ring_copy_smem(int lanes, int depth, int split) {
  (void)lanes;
  (void)split;
  return (int)pnp::ring_smem(depth + 1);
}
