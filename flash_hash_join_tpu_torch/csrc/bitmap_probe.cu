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
// materialize, straight from the probe key planes.  Replaces
// flash_hash_join_tpu/ops/pallas/bitmap_probe.py:probe_gather_bitmap
// (kernel body _gather_kernel) together with the probe-side domain mapping
// that flash_hash_join_tpu/ops/direct_bitmap.py:direct_join_materialize
// runs in front of it in XLA (_probe_idx).  Per probe row i: the row is
// inside when i < np_valid, its high word is 0 and its slot, (low word -
// base) mod 2^32, is below v_rows * 128 (fhj::in_domain; base = the least
// low word of the valid zero-high-word build rows, which the caller leaves
// in device memory); hit[i] is the slot's bit in the occupied slots'
// bitmap, and the 1-2 dense value planes are read at the slot (row s >> 7,
// lane s & 127 of a (v_rows <= 128, 128) plane, i.e. word s); a row that
// is not inside misses and reads 0, as the TPU kernel's scan matches no
// row for the sentinel index.
//
// What bounds it: per probe row 8 B of key planes read and 5-9 B written
// (13 B narrow: 0.388 ms for J1 1e8 Q1 at 3.35 TB/s), so device-memory
// bandwidth, once the bitmap (v_rows * 16 B) and the planes (at most
// 2 x 64 KB at v_rows = 128) sit in dynamic shared memory.
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel scans all v_rows value rows per tile (a lane gather
//    and a row-match select each), so its cost grows with v_rows; here
//    every row reads its own words from shared memory.
//  * The TPU kernel took lo-relative u32 indices that XLA mapped from the
//    planes; PyTorch runs that mapping one eager int64 pass an operation
//    (about 6.7 of 8.3 ms of device time at J1 1e8 Q1 around a 0.4 ms
//    index-form kernel on an H100), so each row is mapped in registers, as
//    K8 does (dense_values.cu), and nothing is written between the key
//    planes and K7's outputs.
//  * 16-byte loads of both key planes (fhj::for_each_pair_at); the grid is
//    capped at the blocks that fit on the card, so each block stages the
//    bitmap and planes once for a grid-stride share of the rows.
#include "domain.cuh"

namespace {

// K2: the bit test of every probe key in the domain from *lo.
__global__ void __launch_bounds__(fhj::kThreads)
scan_domain_probe_kernel(const uint32_t* __restrict__ bitmap, int n_words,
                         const uint32_t* __restrict__ ph,
                         const uint32_t* __restrict__ pl, int64_t n,
                         const uint32_t* __restrict__ lo,
                         unsigned long long* __restrict__ count) {
  extern __shared__ uint4 smem[];
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem);
  fhj::stage(bm, bitmap, n_words);
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

// K7: hit flag and the value planes at each probe row's slot.  Shared
// memory holds the occupied slots' bitmap (v_slots / 32 words), then plane
// 0, then plane 1 (when p1 is given).
__global__ void __launch_bounds__(fhj::kThreads)
scan_domain_gather_kernel(const uint32_t* __restrict__ bitmap,
                          const uint32_t* __restrict__ p0,
                          const uint32_t* __restrict__ p1, uint32_t v_slots,
                          const uint32_t* __restrict__ ph,
                          const uint32_t* __restrict__ pl, int64_t n,
                          int64_t np_valid, const long long* __restrict__ lo,
                          uint8_t* __restrict__ hit, uint32_t* __restrict__ o0,
                          uint32_t* __restrict__ o1) {
  extern __shared__ uint4 smem[];
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s0 = bm + v_slots / 32u;
  uint32_t* s1 = s0 + v_slots;
  fhj::stage(bm, bitmap, (int)(v_slots / 32u));
  fhj::stage(s0, p0, (int)v_slots);
  if (p1) fhj::stage(s1, p1, (int)v_slots);
  __syncthreads();
  const uint32_t base = (uint32_t)__ldg(lo);
  fhj::for_each_pair_at(ph, pl, n, [=](int64_t i, uint32_t h, uint32_t l) {
    uint32_t v;
    const bool inside = fhj::in_domain(h, l, base, v_slots, &v) && i < np_valid;
    hit[i] = inside && fhj::bit_of(bm[v >> 5], v) != 0u;
    o0[i] = inside ? s0[v] : 0u;
    if (p1) o1[i] = inside ? s1[v] : 0u;
  });
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

// bitmap: the occupied slots, at least v_rows * 4 words; p0 and p1 (p1
// may be null): v_rows * 128 words each (v_rows <= 128); all 16-byte
// aligned.  ph/pl: the probe key planes, n rows, [0, np_valid) valid; lo:
// the domain base, one int64 in device memory.  Writes hit[i], o0[i] and
// (with p1) o1[i] for every i < n on `stream` (no launch when n == 0).
// Returns cudaGetLastError().
int fhj_scan_domain_gather(const uint32_t* bitmap, const uint32_t* p0,
                           const uint32_t* p1, int v_rows, const uint32_t* ph,
                           const uint32_t* pl, int64_t n, int64_t np_valid,
                           const long long* lo, uint8_t* hit, uint32_t* o0,
                           uint32_t* o1, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const uint32_t v_slots = (uint32_t)v_rows * 128u;
  const size_t smem = (size_t)(v_slots / 32u + v_slots * (p1 ? 2u : 1u)) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      scan_domain_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = fhj::grid_for(scan_domain_gather_kernel, n, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  scan_domain_gather_kernel<<<grid, fhj::kThreads, smem, stream>>>(
      bitmap, p0, p1, v_slots, ph, pl, n, np_valid, lo, hit, o0, o1);
  return (int)cudaGetLastError();
}

}  // extern "C"
