// K5: stable, sort-free stream compaction.
//
// Replaces flash_hash_join_tpu/ops/pallas/stream_compact.py:
// pack_concat_blocks (kernel body _pack_kernel), which every materialize
// path ends in.  Same function: the rows of V u32 planes whose mask is set
// are written to the front of V output planes, in input order, at exact
// offsets.
//
// Two launches and a small scan between them, all on one stream:
//   1. compact_count_kernel: hits per tile of kTile rows (one block each);
//   2. the caller's exclusive scan of the tile counts (torch.cumsum over
//      n / kTile values, as the JAX package leaves its row counts to XLA);
//   3. compact_scatter_kernel: each block walks its tile in kRounds rounds
//      of one row per thread; __ballot_sync / __popc give each hit its rank
//      inside the warp, a shared-memory pass over the warp totals its rank
//      inside the round, and a running total carries the tile's offset from
//      round to round, so the output is stable.
//
// What bounds it on an H100: device-memory traffic.  It reads the 1-byte
// mask twice and the hit rows' V 4-byte values, and writes V 4-byte values
// per hit: at 1e8 rows, 4 planes and a 50 % hit rate, ~2.6 GB (the value
// reads fetch nearly every 32-byte sector), a floor of ~0.8 ms at the
// 3.35 TB/s peak.  Reads of a round are coalesced; writes are contiguous
// runs of the hits of a warp.
//
// What the design does about it, against the TPU kernel: the TPU kernel
// packs lanes with rotations and moves rows with an MXU permutation matmul
// over a lane-major count layout, because Mosaic cannot scatter; here each
// hit is written to its own address, so none of that, nor the staging and
// carry rows, is needed.
//
// K6: exact-offset concatenation of ragged blocks.  Replaces
// flash_hash_join_tpu/ops/pallas/stream_compact.py:concat_ragged_blocks
// (kernel body _concat_kernel), the second half of the FHJ_COMPACT=stream
// compaction: each block of block_elems words arrives with its valid
// elements already moved to its front (a blockwise torch.sort, in
// ops/compact.py), and the block's prefix of counts[b] elements goes to the
// running offset, the exclusive scan of the counts (torch.cumsum in the
// caller).  What bounds it: device-memory traffic, V 4-byte reads and
// writes per kept element.  The TPU kernel carries the running total across
// its sequential grid, rotates lanes, merges a carried partial row and
// orders overlapping DMA writes with semaphores, writing 8 rows of slack
// past the end, because Mosaic has no per-element addressing; here one CTA
// per block copies its prefix to its own offset, with no slack.
#include "common.cuh"

namespace {

constexpr int kRounds = 16;
constexpr int kTile = fhj::kThreads * kRounds;  // rows per block: 4096
constexpr int kMaxPlanes = 4;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

__global__ void __launch_bounds__(fhj::kThreads)
compact_count_kernel(const uint8_t* __restrict__ mask, int64_t n, int* __restrict__ counts) {
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  unsigned int hits = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * fhj::kThreads;
    hits += i < n && mask[i];
  }
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)total;
}

__global__ void __launch_bounds__(fhj::kThreads)
compact_scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
                       const long long* __restrict__ offsets, Planes planes, int n_planes,
                       int64_t n_out) {
  __shared__ int warp_hits[fhj::kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned int below = (1u << lane) - 1u;  // lanes before this one
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int64_t run = offsets[blockIdx.x];
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * fhj::kThreads;
    const bool hit = i < n && mask[i];
    const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, round_hits = 0;
#pragma unroll
    for (int w = 0; w < fhj::kThreads / 32; ++w) {
      const int h = warp_hits[w];
      before += w < warp ? h : 0;
      round_hits += h;
    }
    if (hit) {
      const int64_t dst = run + before + __popc(ballot & below);
      // unrolled over the fixed maximum, so the plane pointers are read
      // from the parameter space instead of a local copy of the struct
#pragma unroll
      for (int v = 0; v < kMaxPlanes; ++v)
        if (v < n_planes && dst < n_out) planes.out[v][dst] = __ldg(planes.in[v] + i);
    }
    run += round_hits;
    __syncthreads();  // warp_hits is rewritten by the next round
  }
}

// K6: one CTA per input block copies the block's counts[b] leading elements
// of each plane to out[offsets[b], offsets[b] + counts[b]).  Loads and
// stores are consecutive words across the threads of a warp.
__global__ void __launch_bounds__(fhj::kThreads)
concat_ragged_kernel(const int* __restrict__ counts, const long long* __restrict__ offsets,
                     int64_t block_elems, Planes planes, int n_planes) {
  const int64_t b = blockIdx.x;
  const int64_t count = counts[b];
  const int64_t src = b * block_elems;
  const int64_t dst = offsets[b];
#pragma unroll
  for (int v = 0; v < kMaxPlanes; ++v) {
    if (v >= n_planes) break;
    for (int64_t i = threadIdx.x; i < count; i += fhj::kThreads)
      planes.out[v][dst + i] = __ldg(planes.in[v] + src + i);
  }
}

int blocks_for(int64_t n) { return (int)((n + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// Rows per tile: the caller sizes the tile-count array with it.
int fhj_compact_tile_rows() { return kTile; }

// counts: ceil(n / tile_rows) int32, written in full.  Launches nothing when
// n == 0.  Returns cudaGetLastError().
int fhj_compact_count(const uint8_t* mask, int64_t n, int* counts, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  compact_count_kernel<<<blocks_for(n), fhj::kThreads, 0, stream>>>(mask, n, counts);
  return (int)cudaGetLastError();
}

// offsets: the exclusive scan of the tile counts, int64.  in0..in3 / out0..
// out3: the first n_planes (1..4) are used; output rows >= n_out are
// dropped.  Launches nothing when n == 0.  Returns cudaGetLastError().
int fhj_compact_scatter(const uint8_t* mask, int64_t n, const long long* offsets,
                        int n_planes, const uint32_t* in0, const uint32_t* in1,
                        const uint32_t* in2, const uint32_t* in3, uint32_t* out0,
                        uint32_t* out1, uint32_t* out2, uint32_t* out3, int64_t n_out,
                        cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_planes < 1 || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
  compact_scatter_kernel<<<blocks_for(n), fhj::kThreads, 0, stream>>>(
      mask, n, offsets, planes, n_planes, n_out);
  return (int)cudaGetLastError();
}

// K6.  counts: nblocks int32, each in [0, block_elems]; offsets: their
// exclusive scan, int64.  in0..in3: nblocks * block_elems words each, out0..
// out3 as long; the first n_planes (1..4) are used.  Launches nothing when
// nblocks == 0.  Returns cudaGetLastError().
int fhj_concat_ragged_blocks(const int* counts, const long long* offsets, int64_t nblocks,
                             int64_t block_elems, int n_planes, const uint32_t* in0,
                             const uint32_t* in1, const uint32_t* in2, const uint32_t* in3,
                             uint32_t* out0, uint32_t* out1, uint32_t* out2, uint32_t* out3,
                             cudaStream_t stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  if (n_planes < 1 || n_planes > kMaxPlanes || nblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
  concat_ragged_kernel<<<(unsigned int)nblocks, fhj::kThreads, 0, stream>>>(
      counts, offsets, block_elems, planes, n_planes);
  return (int)cudaGetLastError();
}

}  // extern "C"
