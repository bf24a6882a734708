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
// The entry point, fhj_fused_domain_bitmap_join, reads the u32 key planes
// (hi, lo) of both sides and maps them to domain indices in registers, in
// three launches on one stream: the lo min over the build planes, the
// build (bad-row count and atomicOr), the probe (bit test and count); the
// first two are domain.cuh's domain build, which K2 shares.  PyTorch runs
// a mapping eagerly, one pass over 4e7-row int64 tensors per operation
// (about 25 of them, 77-84 % of the count's device time on an H100 at J1
// 4e7 Q5, and 64 B of device memory a probe row); here it costs no pass
// and no byte of its own.  The TPU kernel's index form (lo-relative u32
// indices) has no CUDA entry: no path ran it once the mapping moved into
// the kernel.  Its plain version stays (ops/cuda/dense_bitmap.py).
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
#include "domain.cuh"

namespace {

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

}  // namespace

extern "C" {

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
  cudaError_t e = fhj::domain_build(kh, kl, nb, false, bitmap, n_bits, scratch, stream);
  if (e != cudaSuccess || nb <= 0 || np <= 0) return (int)e;
  return (int)fhj::launch(domain_probe_kernel, np, stream, ph, pl, np,
                          (const uint32_t*)(scratch + 2), n_bits,
                          (const uint32_t*)bitmap, scratch);
}

const char* fhj_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
