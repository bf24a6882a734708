// K1: dense-domain bitmap count join, build + probe.
//
// Replaces flash_hash_join_tpu/ops/pallas/dense_bitmap.py:fused_bitmap_join
// (kernel body _kernel) together with the domain mapping that
// flash_hash_join_tpu/ops/direct_bitmap.py:direct_join_count_large does
// around it in XLA.  Same function: lo = the least low word of the valid
// build keys whose high word is 0 (0xFFFFFFFF when there is none); a valid
// build key is bad when it is not in the domain of d_rows * 4096 slots from
// lo (fhj::in_domain), else it sets its bit in a d_rows x 128 u32 bitmap;
// the count is the number of valid probe keys in the domain whose bit is
// set.  Exact: nothing is ever unresolved.
//
// Two entry points:
//  * fhj_fused_domain_bitmap_join, the path's: it reads the u32 key planes
//    (hi, lo) of both sides and maps them to domain indices in registers,
//    in three launches on one stream: the lo min over the build planes, the
//    build (bad-row count and atomicOr), the probe (bit test and count).
//    PyTorch runs a mapping eagerly, one pass over 4e7-row int64 tensors
//    per operation (about 25 of them, 77-84 % of the count's device time
//    on an H100 at J1 4e7 Q5, and 64 B of device memory a probe row); here
//    it costs no pass and no byte of its own.
//  * fhj_fused_bitmap_join, the index form: lo-relative u32 domain indices,
//    sentinel 0xFFFFFFFF, as the TPU kernel takes them.  No path launches
//    it; it stays as the TPU kernel's direct counterpart, held against it
//    in the CPU tests through its plain version.
//
// What bounds it on an H100: the planes are streamed from device memory,
// 8 B a row for each pass (16 B a build row: the lo pass and the build
// read the build planes; 8 B a probe row).  The bitmap is at most
// 28672 x 128 x 4 B = 14.7 MB, so it stays resident in the 50 MB L2 and
// its random traffic never reaches device memory; L2 atomic throughput
// limits the build (one atomicOr a row).  On an NVIDIA H100 80GB HBM3 at
// 700 W, J1 4e7 Q5 (4e7 + 4e7 rows, 16384-row bitmap) took 0.108 ms for
// the lo pass, 0.495 for the build and 0.334 for the probe.  A build that
// reads the word first and skips the atomicOr when the bit is set took
// 0.82 ms against 0.52 on the same keys, so every in-domain row issues
// its atomicOr.
//
// What the design does about it, against the TPU kernel:
//  * Every key addresses its bitmap word directly.  The TPU kernel needed
//    both sides block-sorted, a per-tile-row window of `sels` bitmap rows
//    (`rs`) and an in-row segmented OR, because Mosaic has no per-element
//    row addressing; all of that is dropped, and with it the unresolved
//    rows (window overflow).
//  * CUDA blocks run in no order, so the TPU's sequential grid (build
//    blocks, then probe blocks, over one scratch bitmap) becomes launches
//    ordered on one stream, and lo, which the build needs whole before its
//    first row, is a launch of its own: a warp __reduce_min_sync, a block
//    min and one atomicMin a block.
//  * 16-byte loads of both planes (fhj::for_each_pair).  Each thread keeps
//    its own bad-row or hit count, so one block reduction and one 64-bit
//    atomicAdd a block finish it.  The build's atomicOr returns nothing
//    (a RED).
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

// *lo = min(*lo, the low words of the keys whose high word is 0).
__global__ void __launch_bounds__(fhj::kThreads)
domain_lo_kernel(const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl,
                 int64_t n, uint32_t* __restrict__ lo) {
  uint32_t m = 0xFFFFFFFFu;
  fhj::for_each_pair(kh, kl, n, [&](uint32_t h, uint32_t l) {
    if (h == 0u && l < m) m = l;
  });
  m = fhj::block_min(m);
  if (threadIdx.x == 0 && m != 0xFFFFFFFFu) atomicMin(lo, m);
}

__global__ void __launch_bounds__(fhj::kThreads)
domain_build_kernel(const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl,
                    int64_t n, const uint32_t* __restrict__ lo, uint32_t n_bits,
                    uint32_t* __restrict__ bitmap,
                    unsigned long long* __restrict__ n_bad) {
  const uint32_t base = __ldg(lo);
  unsigned int bad = 0;
  fhj::for_each_pair(kh, kl, n, [&](uint32_t h, uint32_t l) {
    uint32_t v;
    if (fhj::in_domain(h, l, base, n_bits, &v))
      atomicOr(bitmap + (v >> 5), 1u << (v & 31u));
    else
      ++bad;
  });
  const unsigned long long total = fhj::block_sum(bad);
  if (threadIdx.x == 0 && total) atomicAdd(n_bad, total);
}

__global__ void __launch_bounds__(fhj::kThreads)
domain_probe_kernel(const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                    int64_t n, const uint32_t* __restrict__ lo, uint32_t n_bits,
                    const uint32_t* __restrict__ bitmap,
                    unsigned long long* __restrict__ count) {
  const uint32_t base = __ldg(lo);
  unsigned int hits = 0;
  fhj::for_each_pair(ph, pl, n, [&](uint32_t h, uint32_t l) {
    uint32_t v;
    if (fhj::in_domain(h, l, base, n_bits, &v))
      hits += fhj::bit_of(__ldg(bitmap + (v >> 5)), v);
  });
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int64_t n, cudaStream_t stream, Args... args) {
  int grid = 0;
  cudaError_t e = fhj::grid_for(kernel, n, 0, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, fhj::kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
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
  cudaError_t e = cudaSuccess;
  if (nb > 0) {
    e = launch(bitmap_build_kernel, nb, stream, build_idx, nb, bitmap, n_bits);
    if (e != cudaSuccess) return (int)e;
  }
  if (np > 0)
    e = launch(bitmap_probe_kernel, np, stream, probe_idx, np,
               (const uint32_t*)bitmap, n_bits, count);
  return (int)e;
}

// kh/kl: the build key planes, rows [0, nb) valid; ph/pl: the probe key
// planes, rows [0, np) valid.  bitmap: d_rows * 128 words; scratch: three
// u64 words, {count, n_bad, lo}.  On `stream`: zeroes the bitmap and
// scratch (lo = 0xFFFFFFFF), then launches the lo min and the build over
// a nonempty build, and the probe when both sides are nonempty.  Returns
// cudaGetLastError().
int fhj_fused_domain_bitmap_join(const uint32_t* kh, const uint32_t* kl, int64_t nb,
                                 const uint32_t* ph, const uint32_t* pl, int64_t np,
                                 uint32_t* bitmap, int64_t d_rows,
                                 unsigned long long* scratch, cudaStream_t stream) {
  const uint32_t n_bits = (uint32_t)(d_rows * 4096);
  unsigned long long* count = scratch;
  unsigned long long* n_bad = scratch + 1;
  uint32_t* lo = reinterpret_cast<uint32_t*>(scratch + 2);
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned long long), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(lo, 0xFF, sizeof(uint32_t), stream);
  if (e != cudaSuccess || nb <= 0) return (int)e;
  e = cudaMemsetAsync(bitmap, 0, (size_t)d_rows * 128 * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return (int)e;
  e = launch(domain_lo_kernel, nb, stream, kh, kl, nb, lo);
  if (e != cudaSuccess) return (int)e;
  e = launch(domain_build_kernel, nb, stream, kh, kl, nb, (const uint32_t*)lo,
             n_bits, bitmap, n_bad);
  if (e != cudaSuccess || np <= 0) return (int)e;
  return (int)launch(domain_probe_kernel, np, stream, ph, pl, np,
                     (const uint32_t*)lo, n_bits, (const uint32_t*)bitmap, count);
}

const char* fhj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
