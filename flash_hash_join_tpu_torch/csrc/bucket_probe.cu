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
// u64 key with the empty (u64-max) slots after the keys.  Kept keys are
// distinct, so a key is found by equality alone.
//
// What bounds them on an H100: the probe planes, 8 bytes read per row (K11
// writes 9 more: 0.203 ms for J1 4e7 Q2), streamed once.  The table is at
// most 512 KB of keys (1 MB with K11's values) and stays in L2; what a
// probe costs beyond its stream is the L2 sectors its search touches.
//
// K10 (count) and K11 (materialize) search the same layouts, by rung:
//  * K11 up to R = 32 (kStagedMaxSlots), K10 up to R = 128
//    (kCountStagedMaxSlots): the whole table in each block's shared
//    memory, staged from the planes' contiguous 512-byte rows: the keys as
//    u64 (8 bytes a slot, K10's table; K11 adds the value as a (vh, vl)
//    pair, 16 bytes a slot, at most 64 KB); one thread a probe searches its
//    bucket's column there (log2(R) + 1 shared-memory steps), and K11 reads
//    its value there: no fences, no copy, one launch.  K10's keys alone
//    fit two blocks a SM up to R = 64 and one at R = 128, where the search
//    in shared memory still ran 0.25 against 0.49 ms (R 64) and 0.32
//    against 0.52 (R 128) for the fence path below (4e7 probes, back to
//    back, an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
//  * Above: a bucket-major copy of the table, built first in one
//    launch (bucket_major_kernel, at most 1 MB): keys as u64, (128, R), so
//    a run of kRun = 8 keys is one 64-byte line, and, for K11 only, values
//    as (vh, vl) pairs, so a hit is one 8-byte read (K10's table has no
//    values: its copy is the keys alone, 512 KB at R = 512).  Each block
//    stages the fences, the key of every 8th slot of every bucket ((R / 8,
//    128) u64, 64 KB at R = 512), from the planes' rows 0, 8, 16, ...; a
//    probe finds its run among its bucket's fences in shared memory
//    (log2(R / 8) steps), then 4 lanes read the run together and a ballot
//    finds the key (find_in_run, which both kernels call): one line (and
//    for K11 one value sector) of L2 traffic a probe.
// K10 first ran the slot-major search of the planes as they are: a
// branch-free lower bound down column b, log2(R) + 1 dependent steps (10
// at R = 512), each a 4-byte read of both planes 512 bytes from the last,
// about 20 scattered sector reads a probe: 0.889 ms at J1 4e7 Q2 (R 512)
// and 0.724 at 1e8 Q1 (R 16), against bounds of 0.096 and 0.239.
// K11's lines read one a lane were its first design: 16-byte loads of 32
// different lines a warp load, 8 of them a 128-byte run, ran at 1.59 ms at
// J1 4e7 Q2 (R 512) and 3.44 ms at 1e8 Q1 (R 16), against the old search's
// 1.91 and 0.83; read by 8 or 4 lanes together, runs of 16 and 8 keys ran
// 0.84 and 0.62 ms at R 512 and 1.72 and 1.21 at R 16 (back to back, an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md), so runs are 8 keys, and the
// small rungs, where the shuffles cost more than L1 saves, search shared
// memory instead (0.68 ms at R 16).  Blocks are 1024 threads of at most 32
// registers, two a SM, so an SM holds two copies of the fences and keeps
// the rest of its L1 for the lines.
//
// Both kernels hash the unpadded probe planes in-kernel in u32 arithmetic
// (bucket_of), where the TPU path hashes and pads them into (M, 128) tiles
// in XLA, and the TPU kernels scan all R slot rows of every tile (Mosaic
// gathers only within a vreg).
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

constexpr int kMatThreads = 1024;
constexpr int kStagedMaxSlots = 32;   // K11's tables up to here sit in shared memory
constexpr int kCountStagedMaxSlots = 128;  // and K10's keys alone, up to here
constexpr int kRun = 8;               // above: keys a run, one 64-byte line
constexpr unsigned kFullWarp = 0xffffffffu;

// The bucket-major copy K10 and K11 read above kStagedMaxSlots: keys[b * R
// + r] = slot r of bucket b as one u64 and, when vals is not null, vals[b *
// R + r] = its (vh, vl).  One thread a slot.
__global__ void __launch_bounds__(fhj::kThreads)
bucket_major_kernel(const uint32_t* __restrict__ tk_hi, const uint32_t* __restrict__ tk_lo,
                    const uint32_t* __restrict__ tv_hi, const uint32_t* __restrict__ tv_lo,
                    int r_slots, unsigned long long* __restrict__ keys,
                    uint2* __restrict__ vals) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= r_slots * kLanes) return;
  const int b = o / r_slots;
  const int at = (o - b * r_slots) * kLanes + b;
  keys[o] = slot_key(tk_hi, tk_lo, at);
  if (vals != nullptr) vals[o] = make_uint2(__ldg(tv_hi + at), __ldg(tv_lo + at));
}

// Stages the key of every stride-th slot of every bucket into shared memory
// as u64, slot-major like the planes: fences[j * 128 + b] = slot j * stride
// of bucket b, for j < rows.  Each j is a contiguous 512-byte row of both
// planes.
__device__ __forceinline__ void stage_fences(unsigned long long* fences,
                                             const uint32_t* __restrict__ tk_hi,
                                             const uint32_t* __restrict__ tk_lo, int rows,
                                             int stride) {
  for (int k = threadIdx.x; k < rows * kLanes; k += blockDim.x)
    fences[k] = slot_key(tk_hi, tk_lo, (k / kLanes) * stride * kLanes + k % kLanes);
}

// The last row j in [0, rows) (a power of two) with fences[j * 128 + b] <= x,
// branch-free: 0 when none is.
__device__ __forceinline__ int last_at_or_under(const unsigned long long* fences, int rows,
                                                int b, unsigned long long x) {
  int j = 0;
  for (int span = rows; span > 1; span >>= 1) {
    const int half = span >> 1;
    j = fences[(j + half) * kLanes + b] <= x ? j + half : j;
  }
  return j;
}

// At or under kStagedMaxSlots: where key x of bucket b sits in the whole
// table staged as fences of stride 1 (j * 128 + b), or -1 when it is not
// there (or is u64-max).
__device__ __forceinline__ int staged_at(const unsigned long long* table, int r_slots, int b,
                                         unsigned long long x) {
  const int at = last_at_or_under(table, r_slots, b, x) * kLanes + b;
  return table[at] == x && x != ~0ull ? at : -1;
}

// Above kStagedMaxSlots: the first slot, in the bucket-major copy, of the
// run that may hold key x of bucket b (by the R / kRun fences staged in
// shared memory), or -1 for a row that cannot hit (not live, or u64-max).
__device__ __forceinline__ int run_first(const unsigned long long* fences, int r_slots, int b,
                                         unsigned long long x, bool live) {
  return live && x != ~0ull
             ? b * r_slots + last_at_or_under(fences, r_slots / kRun, b, x) * kRun
             : -1;
}

// The slot of x inside the run that starts at keys[first] (0 .. kRun - 1),
// or -1 when it is not there or first is -1.  Every lane of the warp calls
// it together, each with its own row: kRun / 2 lanes read each run
// together, 16 bytes a lane, so one warp load covers 8 runs (8 lines,
// where a lane reading its own run in 16-byte loads touches 32 lines a
// load, 4 loads a run), and a ballot tells the row's owner which key
// matched.
__device__ __forceinline__ int find_in_run(const unsigned long long* __restrict__ keys,
                                           int first, unsigned long long x) {
  constexpr int kReaders = kRun / 2;           // lanes reading one run
  constexpr int kRuns = 32 / kReaders;         // runs one warp load reads
  const int lane = threadIdx.x & 31;
  int slot = -1;
#pragma unroll
  for (int r = 0; r < kReaders; ++r) {
    // lanes g * kReaders .. g * kReaders + kReaders - 1 read the run of
    // lane r * kRuns + g
    const int owner = r * kRuns + lane / kReaders;
    const int f = __shfl_sync(kFullWarp, first, owner);
    const unsigned long long y = __shfl_sync(kFullWarp, x, owner);
    bool m0 = false, m1 = false;
    if (f >= 0) {
      const ulonglong2 q =
          __ldg(reinterpret_cast<const ulonglong2*>(keys + f) + lane % kReaders);
      m0 = q.x == y;
      m1 = q.y == y;
    }
    const unsigned b0 = __ballot_sync(kFullWarp, m0);
    const unsigned b1 = __ballot_sync(kFullWarp, m1);
    if (lane / kRuns == r) {
      const int shift = (lane % kRuns) * kReaders;
      const unsigned g0 = (b0 >> shift) & ((1u << kReaders) - 1u);
      const unsigned g1 = (b1 >> shift) & ((1u << kReaders) - 1u);
      slot = g0 ? 2 * (__ffs(g0) - 1) : g1 ? 2 * (__ffs(g1) - 1) + 1 : -1;
    }
  }
  return slot;
}

// K10's result: the block's hits summed, one atomicAdd a block.
__device__ __forceinline__ void add_block_hits(unsigned int hits,
                                               unsigned long long* __restrict__ count) {
  const unsigned long long total = fhj::block_sum<kMatThreads>(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// K10 at R <= kCountStagedMaxSlots: the keys in shared memory (128 KB at
// R = 128: then one block a SM), one probe row a thread.
__global__ void __launch_bounds__(kMatThreads, 2)
bucket_count_staged_kernel(const uint32_t* __restrict__ tk_hi,
                           const uint32_t* __restrict__ tk_lo, int r_slots,
                           const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                           int64_t np, int pre_shift, unsigned long long* __restrict__ count) {
  extern __shared__ unsigned long long table[];
  stage_fences(table, tk_hi, tk_lo, r_slots, 1);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int hits = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += stride) {
    const uint32_t h = __ldg(ph + i), l = __ldg(pl + i);
    const unsigned long long x = ((unsigned long long)h << 32) | l;
    hits += staged_at(table, r_slots, (int)bucket_of(h, l, pre_shift), x) >= 0;
  }
  add_block_hits(hits, count);
}

// K10 above kCountStagedMaxSlots, on the keys-only bucket-major copy:
// fences in shared memory, one probe row a lane, find_in_run.
__global__ void __launch_bounds__(kMatThreads, 2)
bucket_count_runs_kernel(const uint32_t* __restrict__ tk_hi,
                         const uint32_t* __restrict__ tk_lo,
                         const unsigned long long* __restrict__ keys, int r_slots,
                         const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                         int64_t np, int pre_shift, unsigned long long* __restrict__ count) {
  extern __shared__ unsigned long long fences[];
  stage_fences(fences, tk_hi, tk_lo, r_slots / kRun, kRun);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int hits = 0;
  // warp-uniform trip count: every lane takes part in the shuffles
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane; base < np;
       base += stride) {
    const int64_t i = base + lane;
    const bool valid = i < np;
    const uint32_t h = valid ? __ldg(ph + i) : 0u;
    const uint32_t l = valid ? __ldg(pl + i) : 0u;
    const unsigned long long x = ((unsigned long long)h << 32) | l;
    const int first = run_first(fences, r_slots, (int)bucket_of(h, l, pre_shift), x, valid);
    hits += find_in_run(keys, first, x) >= 0;
  }
  add_block_hits(hits, count);
}

// K11 at R <= kStagedMaxSlots: the whole table in shared memory, the keys
// (as fences of stride 1) then the values as (vh, vl) pairs, 16 bytes a
// slot.  One probe row a thread: the search of its bucket's column runs in
// shared memory, and the row's value comes from there.
__global__ void __launch_bounds__(kMatThreads, 2)
bucket_probe_staged_kernel(const uint32_t* __restrict__ tk_hi,
                           const uint32_t* __restrict__ tk_lo,
                           const uint32_t* __restrict__ tv_hi,
                           const uint32_t* __restrict__ tv_lo, int r_slots,
                           const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                           int64_t n, int64_t np_valid, int pre_shift,
                           uint8_t* __restrict__ hit, uint32_t* __restrict__ vh,
                           uint32_t* __restrict__ vl) {
  extern __shared__ unsigned long long table[];
  uint2* vals = reinterpret_cast<uint2*>(table + r_slots * kLanes);
  stage_fences(table, tk_hi, tk_lo, r_slots, 1);
  for (int k = threadIdx.x; k < r_slots * kLanes; k += blockDim.x)
    vals[k] = make_uint2(__ldg(tv_hi + k), __ldg(tv_lo + k));
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t h = __ldg(ph + i), l = __ldg(pl + i);
    const unsigned long long x = ((unsigned long long)h << 32) | l;
    const int at = i < np_valid ? staged_at(table, r_slots, (int)bucket_of(h, l, pre_shift), x)
                                : -1;
    const uint2 v = at >= 0 ? vals[at] : make_uint2(0u, 0u);
    hit[i] = at >= 0;
    vh[i] = v.x;
    vl[i] = v.y;
  }
}

// K11 above kStagedMaxSlots, on the bucket-major copy: n_fences = R / kRun
// fences a bucket in shared memory (stage_fences), runs of kRun keys.  One
// probe row a lane, a warp's 32 rows consecutive (coalesced key loads and
// output stores); find_in_run, then the hit's value from the copy.
__global__ void __launch_bounds__(kMatThreads, 2)
bucket_probe_materialize_kernel(const uint32_t* __restrict__ tk_hi,
                                const uint32_t* __restrict__ tk_lo,
                                const unsigned long long* __restrict__ keys,
                                const uint2* __restrict__ vals, int r_slots,
                                const uint32_t* __restrict__ ph,
                                const uint32_t* __restrict__ pl, int64_t n,
                                int64_t np_valid, int pre_shift,
                                uint8_t* __restrict__ hit, uint32_t* __restrict__ vh,
                                uint32_t* __restrict__ vl) {
  extern __shared__ unsigned long long fences[];
  stage_fences(fences, tk_hi, tk_lo, r_slots / kRun, kRun);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // warp-uniform trip count: every lane takes part in the shuffles
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane; base < n;
       base += stride) {
    const int64_t i = base + lane;
    const bool valid = i < n;
    const uint32_t h = valid ? __ldg(ph + i) : 0u;
    const uint32_t l = valid ? __ldg(pl + i) : 0u;
    const unsigned long long x = ((unsigned long long)h << 32) | l;
    const int first = run_first(fences, r_slots, (int)bucket_of(h, l, pre_shift), x,
                                valid && i < np_valid);
    const int slot = find_in_run(keys, first, x);
    if (valid) {
      const uint2 v = slot >= 0 ? __ldg(vals + first + slot) : make_uint2(0u, 0u);
      hit[i] = slot >= 0;
      vh[i] = v.x;
      vl[i] = v.y;
    }
  }
}

// Launches a K10 or K11 kernel over n rows: blocks of kMatThreads, `smem`
// bytes of dynamic shared memory, the grid capped at what fits on the card.
template <typename Kernel, typename... Args>
cudaError_t launch_probe(Kernel kernel, int64_t n, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int grid = 0;
  e = fhj::grid_for(kernel, n, smem, &grid, 1, kMatThreads);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kMatThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_bucket_major(const uint32_t* tk_hi, const uint32_t* tk_lo,
                                const uint32_t* tv_hi, const uint32_t* tv_lo, int r_slots,
                                unsigned long long* keys, uint2* vals, cudaStream_t stream) {
  const int slots = r_slots * kLanes;
  bucket_major_kernel<<<(slots + fhj::kThreads - 1) / fhj::kThreads, fhj::kThreads, 0,
                        stream>>>(tk_hi, tk_lo, tv_hi, tv_lo, r_slots, keys, vals);
  return cudaGetLastError();
}

// Shared memory of the fences above kStagedMaxSlots.
size_t fence_bytes(int r_slots) {
  return (size_t)(r_slots / kRun) * kLanes * sizeof(unsigned long long);
}

bool vmem_rung(int r_slots) {
  return r_slots >= 8 && r_slots <= 512 && (r_slots & (r_slots - 1)) == 0;
}

}  // namespace

extern "C" {

// K10.  tk_hi, tk_lo: the (r_slots, 128) key planes, r_slots a power of two
// in [8, 512]; keys: r_slots * 128 u64 words of scratch, 16-byte aligned
// (unused up to 128 slot rows); count: one zeroed u64.  On `stream`: above
// 128 slot rows builds the keys-only bucket-major copy into keys; then adds
// to count the probes (ph, pl)[0, np) found in their bucket.  Returns
// cudaGetLastError().
int fhj_bucket_probe_count(const uint32_t* tk_hi, const uint32_t* tk_lo, int r_slots,
                           unsigned long long* keys, const uint32_t* ph, const uint32_t* pl,
                           int64_t np, int pre_shift, unsigned long long* count,
                           cudaStream_t stream) {
  if (np <= 0) return (int)cudaSuccess;
  if (!vmem_rung(r_slots) || pre_shift < 0 || pre_shift > 32 - kBucketBits)
    return (int)cudaErrorInvalidValue;
  if (r_slots <= kCountStagedMaxSlots)
    return (int)launch_probe(bucket_count_staged_kernel, np,
                             (size_t)r_slots * kLanes * sizeof(unsigned long long), stream,
                             tk_hi, tk_lo, r_slots, ph, pl, np, pre_shift, count);
  cudaError_t e = launch_bucket_major(tk_hi, tk_lo, nullptr, nullptr, r_slots, keys, nullptr,
                                      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_probe(bucket_count_runs_kernel, np, fence_bytes(r_slots), stream, tk_hi,
                           tk_lo, (const unsigned long long*)keys, r_slots, ph, pl, np,
                           pre_shift, count);
}

// K11.  tk_hi, tk_lo, tv_hi, tv_lo: the (r_slots, 128) key and value
// planes, r_slots a power of two in [8, 512]; keys, vals: r_slots * 128 u64
// words each of scratch, 16-byte aligned (unused when r_slots <= 32).  On
// `stream`: above 32 slot rows builds the bucket-major copy into keys and
// vals; then writes hit/vh/vl for every probe row [0, n): rows at or past
// np_valid, and misses, get 0.  Launches nothing when n == 0.  Returns
// cudaGetLastError().
int fhj_bucket_probe_materialize(const uint32_t* tk_hi, const uint32_t* tk_lo,
                                 const uint32_t* tv_hi, const uint32_t* tv_lo, int r_slots,
                                 unsigned long long* keys, unsigned long long* vals,
                                 const uint32_t* ph, const uint32_t* pl, int64_t n,
                                 int64_t np_valid, int pre_shift, uint8_t* hit, uint32_t* vh,
                                 uint32_t* vl, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (!vmem_rung(r_slots) || pre_shift < 0 || pre_shift > 32 - kBucketBits)
    return (int)cudaErrorInvalidValue;
  if (r_slots <= kStagedMaxSlots)
    return (int)launch_probe(bucket_probe_staged_kernel, n,
                             (size_t)r_slots * kLanes * 2 * sizeof(unsigned long long),
                             stream, tk_hi, tk_lo, tv_hi, tv_lo, r_slots, ph, pl, n,
                             np_valid, pre_shift, hit, vh, vl);
  uint2* pairs = reinterpret_cast<uint2*>(vals);
  cudaError_t e = launch_bucket_major(tk_hi, tk_lo, tv_hi, tv_lo, r_slots, keys, pairs,
                                      stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_probe(bucket_probe_materialize_kernel, n, fence_bytes(r_slots), stream,
                           tk_hi, tk_lo, (const unsigned long long*)keys,
                           (const uint2*)pairs, r_slots, ph, pl, n, np_valid, pre_shift,
                           hit, vh, vl);
}

// The bucket-major copy alone (the first launch of K11, and of K10 above
// its staged rungs), for its checks: as above, into keys and, when tv_hi,
// tv_lo and vals are not null, vals.  Returns cudaGetLastError().
int fhj_bucket_major(const uint32_t* tk_hi, const uint32_t* tk_lo, const uint32_t* tv_hi,
                     const uint32_t* tv_lo, int r_slots, unsigned long long* keys,
                     unsigned long long* vals, cudaStream_t stream) {
  if (!vmem_rung(r_slots) || (vals != nullptr && (tv_hi == nullptr || tv_lo == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_bucket_major(tk_hi, tk_lo, tv_hi, tv_lo, r_slots, keys,
                                  reinterpret_cast<uint2*>(vals), stream);
}

}  // extern "C"
