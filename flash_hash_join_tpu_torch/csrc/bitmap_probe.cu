// K2: the scan band of the dense-domain count, straight from the key
// planes.
//
// Replaces flash_hash_join_tpu/ops/pallas/bitmap_probe.py:probe_count_bitmap
// (kernel body _count_kernel) together with the domain mapping and the
// bitmap pack that flash_hash_join_tpu/ops/direct_bitmap.py:
// direct_join_count does around it in XLA: bitmaps of d_rows <= 256 rows x
// 128 u32 words (<= 128 KB, spans <= 2^20).  Same function as K1's
// (dense_bitmap.cu) but for lo, which is the least low word of EVERY valid
// build key, high-word rows included (0xFFFFFFFF when there is none): a
// valid build key is bad when it is not in the domain of d_rows * 4096
// slots from lo (fhj::in_domain), else it sets its bit; the count is the
// number of valid probe keys in the domain whose bit is set.
//
// Four steps on one stream, no host sync: memsets of the bitmap and the
// scratch words, the lo min and the build (domain.cuh's domain build,
// shared with K1; over the build planes, 4e4 rows at J1 4e7 Q2), then the
// probe, K2 proper.
//
// What bounds the probe on an H100: each probe row is 8 B of key planes
// read once from device memory and one bitmap word read; with the bitmap
// in shared memory the kernel is a pure stream of the planes, bound by
// device-memory bandwidth (0.096 ms for 4e7 rows at 3.35 TB/s).
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel scans EVERY bitmap row for every tile (a lane gather
//    plus a row-match select per row) because Mosaic cannot address a
//    sublane-dynamic row.  Here each block copies the whole bitmap into
//    dynamic shared memory once and then tests each key with one direct
//    word read: the cost no longer grows with d_rows.
//  * The TPU kernel took lo-relative u32 indices that XLA mapped from the
//    planes in fused passes; PyTorch runs such a mapping one eager int64
//    pass an operation (2.75 ms of device time at J1 4e7 Q2 around a
//    0.075 ms index-form kernel on an H100), so the probe maps each key in
//    registers (fhj::in_domain) against the lo that the lo launch left in
//    device memory.
//  * Above 48 KB of dynamic shared memory (the 128- and 256-row rungs) the
//    launch is refused unless cudaFuncAttributeMaxDynamicSharedMemorySize
//    is raised first; the entry point does that.  The grid is capped at
//    the blocks that fit on the card, so each block's bitmap copy is
//    amortised over a grid-stride share of the rows.
//  * 16-byte loads of both planes (fhj::for_each_pair).  Each thread keeps
//    its own hit count, so one warp-shuffle block reduction and one 64-bit
//    atomicAdd per block finish the count.
//
// K7: membership plus value gather, the scan band of the dense-domain
// materialize.  Replaces flash_hash_join_tpu/ops/pallas/bitmap_probe.py:
// probe_gather_bitmap (kernel body _gather_kernel): per unsorted probe index,
// the 0/1 hit of its bitmap bit and the 1-2 dense value planes at its slot
// (row idx >> 7, lane idx & 127 of a (v_rows, 128) plane, i.e. word idx);
// an index at or past v_rows * 128 reads 0, as the TPU kernel's row scan
// matches no row for it.
//
// What bounds it: per probe 4 B read and 5-9 B written, so device-memory
// bandwidth, once the bitmap (4 KB in the scan band) and the planes (at
// most 2 x 64 KB at v_rows = 128) sit in dynamic shared memory.  The TPU
// kernel scans all v_rows value rows per tile (a lane gather and a
// row-match select each), so its cost grows with v_rows; here every probe
// reads its own word, one thread per probe, and the grid is capped at the
// blocks that fit on the card so each block stages the planes once.
#include "domain.cuh"

namespace {

// Copies n32 words (a multiple of 4, 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src,
                                      int n32) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n32 / 4; i += blockDim.x) d[i] = __ldg(s + i);
}

// K2: the bit test of every probe key in the domain from *lo.
__global__ void __launch_bounds__(fhj::kThreads)
scan_domain_probe_kernel(const uint32_t* __restrict__ bitmap, int n_words,
                         const uint32_t* __restrict__ ph,
                         const uint32_t* __restrict__ pl, int64_t n,
                         const uint32_t* __restrict__ lo,
                         unsigned long long* __restrict__ count) {
  extern __shared__ uint4 smem[];
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem);
  stage(bm, bitmap, n_words);
  __syncthreads();
  const uint32_t base = __ldg(lo);
  const uint32_t n_bits = (uint32_t)n_words * 32u;
  unsigned int hits = 0;
  fhj::for_each_pair(ph, pl, n, [&](uint32_t h, uint32_t l) {
    uint32_t v;
    if (fhj::in_domain(h, l, base, n_bits, &v)) hits += fhj::bit_of(bm[v >> 5], v);
  });
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// K7: hit flag and the value planes at each probe's slot.  Shared memory
// holds the bitmap, then plane 0, then plane 1 (when p1 is given).
__global__ void __launch_bounds__(fhj::kThreads)
bitmap_gather_kernel(const uint32_t* __restrict__ bitmap, int n_words,
                     const uint32_t* __restrict__ p0, const uint32_t* __restrict__ p1,
                     int v_slots, const uint32_t* __restrict__ idx, int64_t n,
                     uint8_t* __restrict__ hit, uint32_t* __restrict__ o0,
                     uint32_t* __restrict__ o1) {
  extern __shared__ uint4 smem[];
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s0 = bm + n_words;
  uint32_t* s1 = s0 + v_slots;
  stage(bm, bitmap, n_words);
  stage(s0, p0, v_slots);
  if (p1) stage(s1, p1, v_slots);
  __syncthreads();
  const uint32_t n_bits = (uint32_t)n_words * 32u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t v = __ldg(idx + i);
    const bool inside = v < (uint32_t)v_slots;
    hit[i] = v < n_bits ? (uint8_t)fhj::bit_of(bm[v >> 5], v) : (uint8_t)0;
    o0[i] = inside ? s0[v] : 0u;
    if (p1) o1[i] = inside ? s1[v] : 0u;
  }
}

}  // namespace

extern "C" {

// kh/kl: the build key planes, rows [0, nb) valid; ph/pl: the probe key
// planes, rows [0, np) valid.  bitmap: d_rows * 128 words, 16-byte
// aligned; scratch: three u64 words, {count, n_bad, lo}.  On `stream`:
// zeroes the scratch (lo = 0xFFFFFFFF) and, over a nonempty build, the
// bitmap, then launches the lo min and the build, and the probe when both
// sides are nonempty.  Returns cudaGetLastError().
int fhj_scan_domain_count(const uint32_t* kh, const uint32_t* kl, int64_t nb,
                          const uint32_t* ph, const uint32_t* pl, int64_t np,
                          uint32_t* bitmap, int d_rows, unsigned long long* scratch,
                          cudaStream_t stream) {
  const int n_words = d_rows * 128;
  cudaError_t e = fhj::domain_build(kh, kl, nb, true, bitmap, (uint32_t)n_words * 32u,
                                    scratch, stream);
  if (e != cudaSuccess || nb <= 0 || np <= 0) return (int)e;
  const size_t smem = (size_t)n_words * sizeof(uint32_t);
  e = cudaFuncSetAttribute(scan_domain_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = fhj::grid_for(scan_domain_probe_kernel, np, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  scan_domain_probe_kernel<<<grid, fhj::kThreads, smem, stream>>>(
      bitmap, n_words, ph, pl, np, reinterpret_cast<const uint32_t*>(scratch + 2),
      scratch);
  return (int)cudaGetLastError();
}

// bitmap: d_rows * 128 words; p0 and p1 (p1 may be null): v_rows * 128 words
// each; all 16-byte aligned, and bitmap plus planes at most the block's
// shared memory.  Writes hit[i], o0[i] and (with p1) o1[i] for every
// i < n on `stream` (no launch when n == 0).  Returns cudaGetLastError().
int fhj_bitmap_probe_gather(const uint32_t* bitmap, int d_rows, const uint32_t* p0,
                            const uint32_t* p1, int v_rows, const uint32_t* idx,
                            int64_t n, uint8_t* hit, uint32_t* o0, uint32_t* o1,
                            cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int n_words = d_rows * 128;
  const int v_slots = v_rows * 128;
  const size_t smem = (size_t)(n_words + v_slots * (p1 ? 2 : 1)) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      bitmap_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = fhj::grid_for(bitmap_gather_kernel, n, smem, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  bitmap_gather_kernel<<<grid, fhj::kThreads, smem, stream>>>(bitmap, n_words, p0, p1,
                                                              v_slots, idx, n, hit, o0, o1);
  return (int)cudaGetLastError();
}

}  // extern "C"
