// K8 and K9: the staged band of the dense-domain materialize.
//
// K8 replaces flash_hash_join_tpu/ops/pallas/dense_values.py:
// probe_gather_staged (kernel body _kernel) together with the probe-side
// domain mapping that flash_hash_join_tpu/ops/direct_bitmap.py:
// direct_join_materialize does in front of it in XLA (_probe_idx).  Per
// probe row i, straight from the u32 key planes: the row is in the domain
// when i < np_valid, its high word is 0 and its slot, (low word - base)
// mod 2^32, is below v_rows * 128 (fhj::in_domain; base = the least low
// word of the valid build rows with a zero high word, which the caller
// leaves in device memory); it hits when its slot is occupied; hit[i] and
// the 1-2 dense value planes at the slot are written in probe order (0 on
// a miss).
// Planes are (v_rows <= 8192, 128) u32 words, slot s at word s: at most
// 4 MB each.
//
// What bounds K8 on an H100: per probe row 8 B of key planes read, one
// random 4 B read of each value plane on a hit, and 5-9 B written.  The
// planes stay resident in the 50 MB L2, so the random reads are L2 sector
// reads and the stream of keys and outputs is bound by device-memory
// bandwidth: 13 B a row, 0.388 ms for J1 1e8 Q2 with narrow values.
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel block-sorts the probes (one u32 column), gives every
//    128-probe tile row a window of `sels` consecutive value rows (`rs`
//    starts, scalar-prefetched), stages those rows in VMEM with
//    dynamic-row copies and counts the probes that fall outside the window
//    as unresolved; it passes the sorted indices through as keys.  All of
//    that is there because Mosaic cannot address a row per element.  Here
//    each thread reads its own probe's words through L2: no sort, no
//    window, never unresolved, probe order kept.
//  * The TPU kernel took lo-relative u32 indices that XLA mapped from the
//    planes; PyTorch runs that mapping one eager int64 pass an operation
//    (about 7 ms of device time at J1 1e8 Q2 on an H100, with K9's copy of
//    its output), so each row is mapped in registers, and nothing is
//    written between the key planes and K8's outputs.
//  * 16-byte loads of both key planes (fhj::for_each_pair_at, which hands
//    the row index to the visitor); each thread writes its four rows.
//  * Presence is a bitmap of the occupied slots (v_rows x 4 words, at
//    most 128 KB) staged in each block's shared memory, as K2 stages its
//    bitmap, so a row's one dependent L2 read is its value.  Against the
//    0/1 presence plane read through L2 (the TPU kernel's plane 0) it ran
//    0.975 ms against 1.540 at J1 1e8 Q2 (v_rows 1024), 0.411 against
//    0.622 at 4e7 Q2 (v_rows 512) and 1.396 against 1.656 at the top rung
//    (v_rows 8192, one block an SM) on an NVIDIA H100 80GB HBM3 at 700 W
//    (PERF.md §6), so the plane layout went.
//
// K9 replaces dense_values.py:materialize_copy (_copy_kernel): an identity
// copy.  In the JAX package it is an XLA:TPU fusion barrier in front of the
// staged band's consumers; PyTorch runs eagerly and fuses nothing, and K8
// reads the key planes, so no path copies anything: K9 is on no path.  It
// stays as the TPU kernel's only counterpart.  Bound by bandwidth: 8 B per
// element moved.  A grid of the card's size (SMs x occupancy) looping over
// the copy ran slower than torch's clone on an H100, with one 16-byte load
// a step or four; a grid that covers the copy, one step a thread, ran 1-2 %
// faster than clone when launched alone, and at clone's speed through the
// Python wrapper (PERF.md §6).  So each thread moves kCopyUnroll 16-byte
// words, all loads before the stores, and the grid has one block per
// kCopyUnroll * 256 of them.  The loads and stores are streaming (__ldcs /
// __stcs, evict-first), so a copy does not push other data out of L2.
// Scalar head and tail for views that start off a 16-byte boundary or end
// ragged.  The loop is fhj::copy_planes (common.cuh), which K6 shares.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

// K8.  Shared memory holds the bitmap of the occupied slots.
__global__ void __launch_bounds__(fhj::kThreads)
staged_domain_gather_kernel(const uint32_t* __restrict__ bitmap,
                            const uint32_t* __restrict__ p0,
                            const uint32_t* __restrict__ p1, uint32_t v_slots,
                            const uint32_t* __restrict__ ph,
                            const uint32_t* __restrict__ pl, int64_t n,
                            int64_t np_valid, const long long* __restrict__ lo,
                            uint8_t* __restrict__ hit, uint32_t* __restrict__ o0,
                            uint32_t* __restrict__ o1) {
  extern __shared__ uint4 smem[];
  uint32_t* bm = reinterpret_cast<uint32_t*>(smem);
  fhj::stage(bm, bitmap, (int)(v_slots / 32u));
  __syncthreads();
  const uint32_t base = (uint32_t)__ldg(lo);
  fhj::for_each_pair_at(ph, pl, n, [=](int64_t i, uint32_t h, uint32_t l) {
    uint32_t v;
    const bool found = fhj::in_domain(h, l, base, v_slots, &v) && i < np_valid &&
                       fhj::bit_of(bm[v >> 5], v) != 0u;
    hit[i] = found;
    o0[i] = found ? __ldg(p0 + v) : 0u;
    if (p1) o1[i] = found ? __ldg(p1 + v) : 0u;
  });
}

// K9: fhj::copy_planes over one plane, shared by the whole grid.
__global__ void __launch_bounds__(fhj::kThreads)
copy_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int64_t n) {
  const uint32_t* s[1] = {src};
  uint32_t* d[1] = {dst};
  fhj::copy_planes<1>(s, d, 1, n, blockIdx.x, gridDim.x);
}

}  // namespace

extern "C" {

// bitmap: the occupied slots, v_rows * 4 words; p0 and p1 (p1 may be
// null): v_rows * 128 words each; all 16-byte aligned.  ph/pl: the probe
// key planes, n rows, [0, np_valid) valid; lo: the domain base, one int64
// in device memory.  Writes hit[i], o0[i] and (with p1) o1[i] for every
// i < n on `stream` (no launch when n == 0).  Returns cudaGetLastError().
int fhj_staged_domain_gather(const uint32_t* bitmap, const uint32_t* p0,
                             const uint32_t* p1, int v_rows, const uint32_t* ph,
                             const uint32_t* pl, int64_t n, int64_t np_valid,
                             const long long* lo, uint8_t* hit, uint32_t* o0,
                             uint32_t* o1, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const uint32_t v_slots = (uint32_t)v_rows * 128u;
  const size_t smem = (size_t)(v_slots / 32u) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      staged_domain_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = fhj::grid_for(staged_domain_gather_kernel, n, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  staged_domain_gather_kernel<<<grid, fhj::kThreads, smem, stream>>>(
      bitmap, p0, p1, v_slots, ph, pl, n, np_valid, lo, hit, o0, o1);
  return (int)cudaGetLastError();
}

// Copies src[0, n) to dst[0, n) (both 4-byte aligned, not overlapping) on
// `stream` (no launch when n == 0).  Returns cudaGetLastError().
int fhj_materialize_copy(const uint32_t* src, uint32_t* dst, int64_t n,
                         cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t per_block = 4LL * fhj::kCopyUnroll * fhj::kThreads;   // words
  const int64_t grid = std::min<int64_t>((n + per_block - 1) / per_block, INT_MAX);
  copy_kernel<<<(unsigned)grid, fhj::kThreads, 0, stream>>>(src, dst, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
