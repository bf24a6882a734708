// K1: dense-domain bitmap count join, build + probe.
//
// Replaces flash_hash_join_tpu/ops/pallas/dense_bitmap.py:fused_bitmap_join
// (kernel body _kernel).  Same function: OR every build domain index's bit
// into a d_rows x 128 u32 bitmap, then count the probe indices whose bit is
// set.  Indices are lo-relative u32 with sentinel 0xFFFFFFFF, unsorted.
//
// What bounds it on an H100: the probe streams 4 B per index from device
// memory and does one random 4 B bitmap read; the build does one random
// atomicOr per index.  The bitmap is at most 28672 x 128 x 4 B = 14.7 MB, so
// it stays resident in the 50 MB L2 and the random traffic never reaches
// device memory: the stream of indices (8 B per build+probe row pair) is
// the floor, and L2 atomic throughput limits the build.  On an NVIDIA H100
// 80GB HBM3 at 700 W, 4e7 + 4e7 indices into a 16384-row bitmap took
// 0.47 ms to build and 0.31 ms to probe, against 0.05 ms each for the
// index streams alone at the 3.35 TB/s peak.
//
// What the design does about it, against the TPU kernel:
//  * Every index addresses its bitmap word directly.  The TPU kernel
//    needed both sides block-sorted, a per-tile-row window of `sels` bitmap
//    rows (`rs`) and an in-row segmented OR, because Mosaic has no
//    per-element row addressing; all of that is dropped, and with it the
//    unresolved rows (window overflow) — this kernel has none.
//  * CUDA blocks run in no order, so the TPU's sequential grid (build
//    blocks, then probe blocks, over one scratch bitmap) becomes two
//    launches ordered on one stream.  The caller hands in a zeroed bitmap
//    (torch.zeros) and a zeroed 64-bit count.
//  * 16-byte index loads.  Each thread keeps its own hit count, so one
//    warp-shuffle block reduction and one 64-bit atomicAdd per block finish
//    the count (cheaper than a __ballot_sync/__popc per index step).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(fhj::kThreads)
bitmap_build_kernel(const uint32_t* __restrict__ idx, int64_t n,
                    uint32_t* __restrict__ bitmap, uint32_t n_bits) {
  fhj::for_each_index(idx, n, [&](uint32_t v) {
    if (v < n_bits) atomicOr(bitmap + (v >> 5), 1u << (v & 31u));
  });
}

__global__ void __launch_bounds__(fhj::kThreads)
bitmap_probe_kernel(const uint32_t* __restrict__ idx, int64_t n,
                    const uint32_t* __restrict__ bitmap, uint32_t n_bits,
                    unsigned long long* __restrict__ count) {
  unsigned int hits = 0;
  fhj::for_each_index(idx, n, [&](uint32_t v) {
    if (v < n_bits) hits += fhj::bit_of(__ldg(bitmap + (v >> 5)), v);
  });
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

}  // namespace

extern "C" {

// bitmap: d_rows * 128 zeroed words; count: one zeroed u64.  Launches the
// build over build_idx[0, nb) then the probe over probe_idx[0, np) on
// `stream`; an empty side launches nothing.  Returns cudaGetLastError().
int fhj_fused_bitmap_join(const uint32_t* build_idx, int64_t nb,
                          const uint32_t* probe_idx, int64_t np,
                          uint32_t* bitmap, int64_t d_rows,
                          unsigned long long* count, cudaStream_t stream) {
  const uint32_t n_bits = (uint32_t)(d_rows * 4096);
  int grid = 0;
  cudaError_t e;
  if (nb > 0) {
    e = fhj::grid_for(bitmap_build_kernel, nb, 0, &grid);
    if (e != cudaSuccess) return (int)e;
    bitmap_build_kernel<<<grid, fhj::kThreads, 0, stream>>>(build_idx, nb, bitmap,
                                                            n_bits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (np > 0) {
    e = fhj::grid_for(bitmap_probe_kernel, np, 0, &grid);
    if (e != cudaSuccess) return (int)e;
    bitmap_probe_kernel<<<grid, fhj::kThreads, 0, stream>>>(probe_idx, np, bitmap,
                                                            n_bits, count);
  }
  return (int)cudaGetLastError();
}

const char* fhj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
