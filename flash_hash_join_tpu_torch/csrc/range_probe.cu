// K3 / K4: probe of the partitioned ("radix") tier, count and materialize.
//
// Replaces flash_hash_join_tpu/ops/pallas/range_probe.py:range_probe_count
// (kernel body _count_kernel) and :range_probe_materialize
// (_materialize_kernel).  Same function: for each valid probe row, does its
// u64 key occur among the valid build rows?  Count mode sums that;
// materialize mode writes, per probe row, the hit flag and the value of the
// FIRST build row of the key's run in the stably sorted table, which is the
// minimum build-row index with that key.
//
// The table is the valid build keys as sortable int64 (u64 key with its top
// bit flipped, utils/u64.py:sortable), sorted ascending by torch.sort
// outside the kernel, as lax.sort is in the JAX package.  Probes stay
// UNSORTED in input order; rows at or past np_valid never hit.
//
// What bounds it on an H100: each probe is a branch-free lower bound over
// nb keys, log2(nb) dependent 8-byte loads (27 at 1e8 build rows).  The top
// ~20 levels of every search touch few enough distinct keys to stay in the
// 50 MB L2; the last levels go to device memory as 32-byte sector reads.
// So the kernel is bound by the latency of those dependent loads, hidden by
// keeping many probes in flight (one thread per probe, full occupancy).
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel needs a rank-balanced (S, C, 128) transposed table, its
//    (S+1, 1, 128) column boundaries, a W-super-row window per tile with a
//    scalar-prefetched start, sorted and tile-padded probes and SMALL /
//    BLOCKWISE modes, because Mosaic has no per-element addressing.  Here
//    each probe addresses the sorted keys directly: all of that is gone, and
//    with it the window overflow, so this kernel never reports unresolved
//    probes and needs no sentinel (the u64-max key joins like any other).
//  * Count: each thread keeps its own hits; one warp-shuffle block reduction
//    and one 64-bit atomicAdd per block finish the count.
#include "common.cuh"

namespace {

__device__ __forceinline__ long long sortable_key(uint32_t hi, uint32_t lo) {
  return (long long)((((unsigned long long)hi << 32) | lo) ^ 0x8000000000000000ull);
}

// Index of the first key >= x in keys[0, n), n >= 1; branch-free (the loop
// count depends on n only, so a warp's searches stay converged).
__device__ __forceinline__ int64_t lower_bound(const long long* __restrict__ keys,
                                               int64_t n, long long x) {
  const long long* base = keys;
  while (n > 1) {
    const int64_t half = n >> 1;
    base = (__ldg(base + half) < x) ? base + half : base;
    n -= half;
  }
  return (base - keys) + (__ldg(base) < x);
}

// Position of x's run in keys[0, nb), or -1 when x is not a key.
__device__ __forceinline__ int64_t find(const long long* __restrict__ keys, int64_t nb,
                                        long long x) {
  const int64_t pos = lower_bound(keys, nb, x);
  return (pos < nb && __ldg(keys + pos) == x) ? pos : -1;
}

__global__ void __launch_bounds__(fhj::kThreads)
range_probe_count_kernel(const long long* __restrict__ keys, int64_t nb,
                         const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                         int64_t np, unsigned long long* __restrict__ count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int hits = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += stride)
    hits += find(keys, nb, sortable_key(__ldg(ph + i), __ldg(pl + i))) >= 0;
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

__global__ void __launch_bounds__(fhj::kThreads)
range_probe_materialize_kernel(const long long* __restrict__ keys, int64_t nb,
                               const uint32_t* __restrict__ tvh,
                               const uint32_t* __restrict__ tvl,
                               const uint32_t* __restrict__ ph,
                               const uint32_t* __restrict__ pl, int64_t n,
                               int64_t np_valid, uint8_t* __restrict__ hit,
                               uint32_t* __restrict__ vh, uint32_t* __restrict__ vl) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t pos = (i < np_valid && nb > 0)
                            ? find(keys, nb, sortable_key(__ldg(ph + i), __ldg(pl + i)))
                            : -1;
    hit[i] = pos >= 0;
    vh[i] = pos >= 0 ? __ldg(tvh + pos) : 0u;
    vl[i] = pos >= 0 ? __ldg(tvl + pos) : 0u;
  }
}

}  // namespace

extern "C" {

// keys: nb >= 1 sorted sortable keys; count: one zeroed u64.  Counts the
// probes (ph, pl)[0, np) found in keys, on `stream`.  Returns
// cudaGetLastError().
int fhj_range_probe_count(const long long* keys, int64_t nb, const uint32_t* ph,
                          const uint32_t* pl, int64_t np, unsigned long long* count,
                          cudaStream_t stream) {
  if (nb <= 0 || np <= 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t e = fhj::grid_for(range_probe_count_kernel, np, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  range_probe_count_kernel<<<grid, fhj::kThreads, 0, stream>>>(keys, nb, ph, pl, np,
                                                               count);
  return (int)cudaGetLastError();
}

// keys: nb >= 0 sorted sortable keys, tvh/tvl their value planes in the same
// order.  Writes hit/vh/vl for every probe row [0, n): rows at or past
// np_valid, and misses, get 0.  Launches nothing when n == 0.  Returns
// cudaGetLastError().
int fhj_range_probe_materialize(const long long* keys, int64_t nb, const uint32_t* tvh,
                                const uint32_t* tvl, const uint32_t* ph,
                                const uint32_t* pl, int64_t n, int64_t np_valid,
                                uint8_t* hit, uint32_t* vh, uint32_t* vl,
                                cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t e = fhj::grid_for(range_probe_materialize_kernel, n, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  range_probe_materialize_kernel<<<grid, fhj::kThreads, 0, stream>>>(
      keys, nb, tvh, tvl, ph, pl, n, np_valid, hit, vh, vl);
  return (int)cudaGetLastError();
}

}  // extern "C"
