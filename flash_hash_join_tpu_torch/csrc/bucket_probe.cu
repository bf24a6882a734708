// K10 / K11: probe of the `vmem` tier's bucket table, count and
// materialize.
//
// Replaces flash_hash_join_tpu/ops/pallas/bucket_probe.py:probe_count_vmem
// (kernel body _count_kernel) and :probe_materialize_vmem
// (_materialize_kernel).  Same function: a probe row hits when its u64 key
// sits among the R slots of its bucket (the top 7 bits of hash_u64 of the
// key), and materialize writes, per probe row, the hit flag and the slot's
// value planes.  A u64-max probe key never hits (empty slots hold that
// pattern; the caller answers it from the table's `special`), and rows at
// or past np_valid never hit.
//
// Table layout, (R, 128) u32 planes, slot-major: word r * 128 + b is slot r
// of bucket b.  ops/bucket_table.py sorts the build by (bucket, key) and
// writes each bucket's kept keys at dense ranks, so column b is ascending by
// u64 key with the empty (u64-max) slots after the keys.
//
// What bounds it on an H100: the probe planes, 8 bytes read per row (K11
// writes 9 more), streamed once.  The table is at most 512 KB of keys (1 MB
// with K11's values) and stays in L2; the search is log2(R) + 1 dependent
// loads from it (10 at R = 512), hidden by one thread per probe at full
// occupancy.
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel scans all R slot rows of every probe tile, because
//    Mosaic gathers only within a vreg: R steps per probe.  Here each thread
//    addresses its bucket's column directly and runs a branch-free lower
//    bound over it: log2(R) steps.
//  * The TPU path hashes the probes and pads them into (M, 128) tiles in
//    XLA before the kernel; here the hash and bucket are computed in-kernel
//    in u32 arithmetic, so the probe planes are read once and nothing is
//    padded.
//  * The table is read through L1/L2 with __ldg rather than staged in
//    shared memory: at R = 512 the key planes alone are 512 KB, more than a
//    block's 227 KB, so every rung takes this one path.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kBucketBits = 7;

// murmur3's 32-bit finalizer and the two-word hash of ops/hashing.py.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t bucket_of(uint32_t hi, uint32_t lo, int pre_shift) {
  const uint32_t h = fmix32(fmix32(lo) ^ (hi * 0x9E3779B9u));
  return (h << pre_shift) >> (32 - kBucketBits);
}

__device__ __forceinline__ unsigned long long slot_key(const uint32_t* __restrict__ tk_hi,
                                                       const uint32_t* __restrict__ tk_lo,
                                                       int at) {
  return ((unsigned long long)__ldg(tk_hi + at) << 32) | __ldg(tk_lo + at);
}

// Slot row of probe i's key in its bucket's column, or -1 when it is not
// there (or is u64-max).
__device__ __forceinline__ int find_slot(const uint32_t* __restrict__ tk_hi,
                                         const uint32_t* __restrict__ tk_lo, int r_slots,
                                         uint32_t hi, uint32_t lo, int pre_shift,
                                         int* bucket) {
  const unsigned long long x = ((unsigned long long)hi << 32) | lo;
  const int b = (int)bucket_of(hi, lo, pre_shift);
  *bucket = b;
  if (x == ~0ull) return -1;
  // branch-free lower bound over rows [0, r_slots) of column b
  int base = 0, n = r_slots;
  while (n > 1) {
    const int half = n >> 1;
    base = slot_key(tk_hi, tk_lo, (base + half) * kLanes + b) < x ? base + half : base;
    n -= half;
  }
  const int pos = base + (slot_key(tk_hi, tk_lo, base * kLanes + b) < x);
  return (pos < r_slots && slot_key(tk_hi, tk_lo, pos * kLanes + b) == x) ? pos : -1;
}

__global__ void __launch_bounds__(fhj::kThreads)
bucket_probe_count_kernel(const uint32_t* __restrict__ tk_hi,
                          const uint32_t* __restrict__ tk_lo, int r_slots,
                          const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                          int64_t np, int pre_shift, unsigned long long* __restrict__ count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int hits = 0;
  int b;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += stride)
    hits += find_slot(tk_hi, tk_lo, r_slots, __ldg(ph + i), __ldg(pl + i), pre_shift, &b) >= 0;
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

__global__ void __launch_bounds__(fhj::kThreads)
bucket_probe_materialize_kernel(const uint32_t* __restrict__ tk_hi,
                                const uint32_t* __restrict__ tk_lo,
                                const uint32_t* __restrict__ tv_hi,
                                const uint32_t* __restrict__ tv_lo, int r_slots,
                                const uint32_t* __restrict__ ph,
                                const uint32_t* __restrict__ pl, int64_t n,
                                int64_t np_valid, int pre_shift, uint8_t* __restrict__ hit,
                                uint32_t* __restrict__ vh, uint32_t* __restrict__ vl) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    int b = 0;
    const int slot = i < np_valid ? find_slot(tk_hi, tk_lo, r_slots, __ldg(ph + i),
                                              __ldg(pl + i), pre_shift, &b)
                                  : -1;
    const int at = slot * kLanes + b;
    hit[i] = slot >= 0;
    vh[i] = slot >= 0 ? __ldg(tv_hi + at) : 0u;
    vl[i] = slot >= 0 ? __ldg(tv_lo + at) : 0u;
  }
}

}  // namespace

extern "C" {

// tk_hi, tk_lo: (r_slots, 128) planes; count: one zeroed u64.  Counts the
// probes (ph, pl)[0, np) found in their bucket, on `stream`.  Returns
// cudaGetLastError().
int fhj_bucket_probe_count(const uint32_t* tk_hi, const uint32_t* tk_lo, int r_slots,
                           const uint32_t* ph, const uint32_t* pl, int64_t np, int pre_shift,
                           unsigned long long* count, cudaStream_t stream) {
  if (np <= 0) return (int)cudaSuccess;
  if (r_slots < 1 || pre_shift < 0 || pre_shift > 32 - kBucketBits)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = fhj::grid_for(bucket_probe_count_kernel, np, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  bucket_probe_count_kernel<<<grid, fhj::kThreads, 0, stream>>>(tk_hi, tk_lo, r_slots, ph,
                                                                pl, np, pre_shift, count);
  return (int)cudaGetLastError();
}

// As above, plus tv_hi, tv_lo: the value planes, laid out like the keys.
// Writes hit/vh/vl for every probe row [0, n): rows at or past np_valid,
// and misses, get 0.  Launches nothing when n == 0.  Returns
// cudaGetLastError().
int fhj_bucket_probe_materialize(const uint32_t* tk_hi, const uint32_t* tk_lo,
                                 const uint32_t* tv_hi, const uint32_t* tv_lo, int r_slots,
                                 const uint32_t* ph, const uint32_t* pl, int64_t n,
                                 int64_t np_valid, int pre_shift, uint8_t* hit, uint32_t* vh,
                                 uint32_t* vl, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (r_slots < 1 || pre_shift < 0 || pre_shift > 32 - kBucketBits)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t e = fhj::grid_for(bucket_probe_materialize_kernel, n, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  bucket_probe_materialize_kernel<<<grid, fhj::kThreads, 0, stream>>>(
      tk_hi, tk_lo, tv_hi, tv_lo, r_slots, ph, pl, n, np_valid, pre_shift, hit, vh, vl);
  return (int)cudaGetLastError();
}

}  // extern "C"
