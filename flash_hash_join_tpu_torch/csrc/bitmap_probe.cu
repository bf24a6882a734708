// K2: membership count of probe domain indices in a small bitmap.
//
// Replaces flash_hash_join_tpu/ops/pallas/bitmap_probe.py:probe_count_bitmap
// (kernel body _count_kernel): the scan band of the dense-domain count,
// bitmaps of d_rows <= 256 rows x 128 u32 words (<= 128 KB, spans <= 2^20).
//
// What bounds it on an H100: each probe index is 4 B read once from device
// memory and one bitmap word read; with the bitmap in shared memory the
// kernel is a pure stream of the indices, bound by device-memory bandwidth.
// On an NVIDIA H100 80GB HBM3 at 700 W, 4e7 indices (160 MB) took 0.064 ms
// of kernel time (2.5 TB/s of the 3.35 TB/s peak), 0.08-0.09 ms per
// wrapper call.
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel scans EVERY bitmap row for every tile (a lane gather
//    plus a row-match select per row) because Mosaic cannot address a
//    sublane-dynamic row.  Here each block copies the whole bitmap into
//    dynamic shared memory once and then tests each index with one direct
//    word read: the cost no longer grows with d_rows.
//  * Above 48 KB of dynamic shared memory (the 128- and 256-row rungs) the
//    launch is refused unless cudaFuncAttributeMaxDynamicSharedMemorySize
//    is raised first; the entry point does that.  The grid is capped at
//    the blocks that fit on the card, so each block's bitmap copy is
//    amortised over a grid-stride share of the indices.
//  * 16-byte index loads.  Each thread keeps its own hit count, so one
//    warp-shuffle block reduction and one 64-bit atomicAdd per block finish
//    the count.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(fhj::kThreads)
bitmap_probe_smem_kernel(const uint32_t* __restrict__ bitmap, int n_words,
                         const uint32_t* __restrict__ idx, int64_t n,
                         unsigned long long* __restrict__ count) {
  extern __shared__ uint4 smem[];
  const uint4* src = reinterpret_cast<const uint4*>(bitmap);
  for (int i = threadIdx.x; i < n_words / 4; i += blockDim.x) smem[i] = __ldg(src + i);
  __syncthreads();
  const uint32_t* bm = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t n_bits = (uint32_t)n_words * 32u;
  unsigned int hits = 0;
  fhj::for_each_index(idx, n, [&](uint32_t v) {
    if (v < n_bits) hits += fhj::bit_of(bm[v >> 5], v);
  });
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

}  // namespace

extern "C" {

// bitmap: d_rows * 128 words, 16-byte aligned; count: one zeroed u64.
// Launches one kernel over idx[0, n) on `stream` (none when n == 0).
// Returns cudaGetLastError().
int fhj_bitmap_probe_count(const uint32_t* bitmap, int d_rows,
                           const uint32_t* idx, int64_t n,
                           unsigned long long* count, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int n_words = d_rows * 128;
  const size_t smem = (size_t)n_words * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitmap_probe_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = fhj::grid_for(bitmap_probe_smem_kernel, n, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  bitmap_probe_smem_kernel<<<grid, fhj::kThreads, smem, stream>>>(bitmap, n_words, idx,
                                                                  n, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
