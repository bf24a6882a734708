// K3 / K4: probe of the partitioned ("radix") tier, count and materialize,
// and the bucket directory that both search through.
//
// Replaces flash_hash_join_tpu/ops/pallas/range_probe.py:range_probe_count
// (kernel body _count_kernel) and :range_probe_materialize
// (_materialize_kernel).  Same function: for each valid probe row, does its
// u64 key occur among the valid build rows?  Count mode sums that;
// materialize mode writes, per probe row, the hit flag and the value of the
// FIRST build row of the key's run in the stably sorted table, which is the
// minimum build-row index with that key.
//
// The table (ops/range_table.py) is the valid build keys as sortable int64
// (u64 key with its top bit flipped, utils/u64.py:sortable), sorted
// ascending by the build kernels (range_build.cu), where the JAX package
// runs a plain lax.sort; the values permuted the same way as one
// interleaved (vh, vl) plane; and, above ops/cuda/range_probe.py:SMALL_TABLE keys, a bucket
// directory: bucket b holds the keys whose (u64)(key - keys[0]) >> shift
// equals b, and dir[b] is the first index at or past bucket b, for b in
// [0, 2^p] (p >= 1, so 0 <= shift < 64).  Probes stay UNSORTED in input
// order; rows at or past np_valid never hit.
//
// What bounds it on an H100: the random 32-byte sector reads a probe needs,
// 8 bytes used of each.  A lower bound over all nb keys touches log2(nb) of
// them (27 at 1e8 keys), each step about 2-2.5 ms per 1e8 probes (PERF.md).
// The bytes bound is 0.5-1 ms.
//
// What the design does about it, against the TPU kernel:
//  * The TPU kernel searches in two levels: the (S+1, 1, 128) column
//    boundaries place each probe (range_probe.py:_search), then it scans
//    the column's C keys (_scan_hits).  Here the first level is the
//    directory.  A probe outside [keys[0], keys[nb - 1]] misses without a
//    table read; otherwise one read of dir[b], dir[b + 1] (adjacent), then
//    the sector of the bucket where x would sit if its keys were evenly
//    spread (an interpolation guess: on uniform keys the lower bound is
//    inside it, so one key sector a probe), and only if not, a branch-free
//    lower bound over the side of the bucket left.  A crowded bucket costs
//    the whole-table search plus two reads.
//  * A table with no directory (a small build, in L1), or of fewer than 4
//    keys, is one branch-free lower bound over all its keys: fewer
//    instructions than the directory and the guess where every step hits
//    L1.
//  * The guessed sector's four scalar loads are unconditional, so they are
//    in flight together, and the sector answers the probe itself when the
//    lower bound is inside it.  The sector is moved down to end at the
//    table's last key where it would pass it, so no load needs a bounds
//    check.  Measured on the H100 (PERF.md §6): loads behind branches 1.4x
//    slower; a clamp of each load's index 12 % slower on K3; two 16-byte
//    loads no faster over K3 and K4 together; 2 or 4 probes a thread
//    slower than one at full occupancy.
//  * The TPU layout's window, transposed table, probe sort and tile padding
//    serve Mosaic's lack of per-element addressing and are gone, and with
//    them the window overflow: these kernels never report unresolved probes
//    and need no sentinel (the u64-max key joins like any other).
//  * K4 reads the winner's (vh, vl) as one 8-byte load: one value sector a
//    hit, not two.
//  * Positions and offsets are 32-bit below 2^31 keys (Dir = int32_t):
//    on the same table and probes, 64-bit ones measured K3 43 % and K4 6 %
//    slower (chip_smoke.py's offset_widths, PERF.md §6).
//  * Count: each thread keeps its own hits; one warp-shuffle block reduction
//    and one 64-bit atomicAdd per block finish the count.
//  * The directory build is one thread a bucket: the lower bound of the
//    bucket's start key, computed in the kernel.  It beat torch.searchsorted
//    of the start keys made beforehand (PERF.md).
#include "common.cuh"

namespace {

__device__ __forceinline__ long long sortable_key(uint32_t hi, uint32_t lo) {
  return (long long)((((unsigned long long)hi << 32) | lo) ^ 0x8000000000000000ull);
}

template <typename Dir>
__global__ void __launch_bounds__(fhj::kThreads)
range_directory_kernel(const long long* __restrict__ keys, int64_t nb, int p,
                       Dir* __restrict__ dir, int64_t* __restrict__ shift_out) {
  const long long lo = __ldg(keys), hi = __ldg(keys + nb - 1);
  const unsigned long long span = (unsigned long long)hi - (unsigned long long)lo;
  const int bits = span ? 64 - __clzll((long long)span) : 0;
  const int shift = bits > p ? bits - p : 0;  // < 64, as p >= 1
  const int64_t last = (int64_t)(span >> shift);  // the last key's bucket
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid == 0) *shift_out = shift;
  for (int64_t b = tid; b <= ((int64_t)1 << p); b += (int64_t)gridDim.x * blockDim.x) {
    if (b > last) {
      dir[b] = (Dir)nb;
      continue;
    }
    // the first key at or past the bucket's start lo + (b << shift) <= hi
    const long long start = (long long)((unsigned long long)lo + ((unsigned long long)b << shift));
    int64_t base = 0, n = nb;
    while (n > 1) {
      const int64_t half = n >> 1;
      base = __ldg(keys + base + half - 1) < start ? base + half : base;
      n -= half;
    }
    dir[b] = (Dir)base;
  }
}

// Positions are computed in Dir, the offsets' own type.
template <typename Dir>
struct Table {
  const long long* keys;
  Dir nb;
  const Dir* dir;    // null: no directory, one search of all nb keys
  long long lo, hi;  // keys[0], keys[nb - 1]; lo > hi for an empty table
  int shift;
};

template <typename Dir>
__device__ __forceinline__ Table<Dir> load_table(const long long* keys, int64_t nb,
                                                 const Dir* dir, const int64_t* shift) {
  if (nb <= 0) return {keys, 0, nullptr, 1, 0, 0};
  if (nb < 4) dir = nullptr;  // fewer keys than a sector: searched whole
  return {keys, (Dir)nb, dir, __ldg(keys), __ldg(keys + nb - 1),
          dir ? (int)__ldg(shift) : 0};
}

// floor(f * n) for f the fraction of d within its bucket (of width
// 2^shift), from its top 32 bits when Dir is 32-bit.
template <typename Dir>
__device__ __forceinline__ Dir scaled_fraction(unsigned long long d, int shift, Dir n) {
  const unsigned long long f = shift ? d << (64 - shift) : 0ull;
  if constexpr (sizeof(Dir) == 4)
    return (Dir)__umulhi((unsigned)(f >> 32), (unsigned)n);
  else
    return (Dir)__umul64hi(f, (unsigned long long)n);
}

// Index of the first key equal to x, or -1 when x is not a key.
template <typename Dir>
__device__ __forceinline__ Dir find(const Table<Dir>& t, long long x) {
  if (x < t.lo || x > t.hi) return -1;  // outside the keys: no table read
  Dir base = 0, end = t.nb;
  Dir n = t.nb;  // the lower bound is one of the n candidates [base, base + n)
  if (t.dir) {
    const unsigned long long d = (unsigned long long)x - (unsigned long long)t.lo;
    const Dir b = (Dir)(d >> t.shift);
    base = __ldg(t.dir + b);
    end = __ldg(t.dir + b + 1);
    if (base == end) return -1;  // an empty bucket
    // Interpolation guess: the 32-byte sector (4 keys) where x would sit if
    // the bucket's keys were evenly spread, from x's offset within its
    // bucket (of width 2^shift); moved down to end at the table's last key
    // where it would pass it (nb >= 4 here), so its loads need no bounds
    // check.  Keys below the bucket count as < x and keys past it as > x.
    // If the lower bound is inside the sector, the sector answers;
    // otherwise the candidates shrink to one side.
    const Dir guess = (base + scaled_fraction(d, t.shift, (Dir)(end - base))) & ~(Dir)3;
    const Dir s = guess < t.nb - 4 ? guess : t.nb - 4;
    int below = 0;
    bool equal = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Dir at = s + i;
      const long long key = __ldg(t.keys + at);
      const bool in_bucket = at >= base && at < end;
      below += at < base || (in_bucket && key < x);
      equal |= in_bucket && key == x;
    }
    if (below == 4) {  // past the sector: candidates [s + 4, end]
      n = end - s - 3;
      base = s + 4;
    } else if (below > 0 || s == base) {
      return equal ? s + below : -1;
    } else {  // before the sector: candidates [base, s]
      n = s - base + 1;
    }
  }
  // branch-free: each step halves the candidates with one load,
  // keys[base + half - 1] < x meaning "past it"
  while (n > 1) {
    const Dir half = n >> 1;
    base = __ldg(t.keys + base + half - 1) < x ? base + half : base;
    n -= half;
  }
  return base < end && __ldg(t.keys + base) == x ? base : -1;
}

template <typename Dir>
__global__ void __launch_bounds__(fhj::kThreads)
range_probe_count_kernel(const long long* __restrict__ keys, int64_t nb,
                         const Dir* __restrict__ dir, const int64_t* __restrict__ shift,
                         const uint32_t* __restrict__ ph, const uint32_t* __restrict__ pl,
                         int64_t np, unsigned long long* __restrict__ count) {
  const Table<Dir> t = load_table(keys, nb, dir, shift);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned int hits = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += stride)
    hits += find(t, sortable_key(__ldg(ph + i), __ldg(pl + i))) >= 0;
  const unsigned long long total = fhj::block_sum(hits);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

template <typename Dir>
__global__ void __launch_bounds__(fhj::kThreads)
range_probe_materialize_kernel(const long long* __restrict__ keys, int64_t nb,
                               const Dir* __restrict__ dir,
                               const int64_t* __restrict__ shift,
                               const uint2* __restrict__ values,
                               const uint32_t* __restrict__ ph,
                               const uint32_t* __restrict__ pl, int64_t n,
                               int64_t np_valid, uint8_t* __restrict__ hit,
                               uint32_t* __restrict__ vh, uint32_t* __restrict__ vl) {
  const Table<Dir> t = load_table(keys, nb, dir, shift);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const Dir pos = i < np_valid ? find(t, sortable_key(__ldg(ph + i), __ldg(pl + i))) : -1;
    const uint2 v = pos >= 0 ? __ldg(values + pos) : make_uint2(0u, 0u);
    hit[i] = pos >= 0;
    vh[i] = v.x;
    vl[i] = v.y;
  }
}

template <typename Dir>
int directory(const long long* keys, int64_t nb, int p, void* dir, int64_t* shift,
              cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = fhj::grid_for(range_directory_kernel<Dir>, ((int64_t)1 << p) + 1, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  range_directory_kernel<Dir><<<grid, fhj::kThreads, 0, stream>>>(keys, nb, p,
                                                                  static_cast<Dir*>(dir), shift);
  return (int)cudaGetLastError();
}

template <typename Dir>
int probe_count(const long long* keys, int64_t nb, const void* dir, const int64_t* shift,
                const uint32_t* ph, const uint32_t* pl, int64_t np, unsigned long long* count,
                cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = fhj::grid_for(range_probe_count_kernel<Dir>, np, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  range_probe_count_kernel<Dir><<<grid, fhj::kThreads, 0, stream>>>(
      keys, nb, static_cast<const Dir*>(dir), shift, ph, pl, np, count);
  return (int)cudaGetLastError();
}

template <typename Dir>
int probe_materialize(const long long* keys, int64_t nb, const void* dir, const int64_t* shift,
                      const uint32_t* values, const uint32_t* ph, const uint32_t* pl, int64_t n,
                      int64_t np_valid, uint8_t* hit, uint32_t* vh, uint32_t* vl,
                      cudaStream_t stream) {
  int grid = 0;
  cudaError_t e = fhj::grid_for(range_probe_materialize_kernel<Dir>, n, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  range_probe_materialize_kernel<Dir><<<grid, fhj::kThreads, 0, stream>>>(
      keys, nb, static_cast<const Dir*>(dir), shift, reinterpret_cast<const uint2*>(values), ph,
      pl, n, np_valid, hit, vh, vl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// keys: nb >= 1 sorted sortable keys, 1 <= p <= 30.  Writes the directory
// dir[0, 2^p] (int32 when dir_bytes is 4, int64 when 8) and its shift, on
// `stream`.  Returns cudaGetLastError().
int fhj_range_directory(const long long* keys, int64_t nb, int p, void* dir, int dir_bytes,
                        int64_t* shift, cudaStream_t stream) {
  if (nb <= 0 || p < 1 || p > 30) return (int)cudaErrorInvalidValue;
  return dir_bytes == 8 ? directory<int64_t>(keys, nb, p, dir, shift, stream)
                        : directory<int32_t>(keys, nb, p, dir, shift, stream);
}

// keys: nb >= 1 sorted sortable keys; dir / shift their directory (dir_bytes
// its offsets' width), or both null for none, searched then with 32-bit
// positions (nb < 2^31); count: one zeroed u64.  Counts the probes
// (ph, pl)[0, np) found in keys, on `stream`.  Returns cudaGetLastError().
int fhj_range_probe_count(const long long* keys, int64_t nb, const void* dir, int dir_bytes,
                          const int64_t* shift, const uint32_t* ph, const uint32_t* pl,
                          int64_t np, unsigned long long* count, cudaStream_t stream) {
  if (nb <= 0 || np <= 0) return (int)cudaSuccess;
  return dir_bytes == 8 ? probe_count<int64_t>(keys, nb, dir, shift, ph, pl, np, count, stream)
                        : probe_count<int32_t>(keys, nb, dir, shift, ph, pl, np, count, stream);
}

// keys: nb >= 0 sorted sortable keys, dir / dir_bytes / shift as above,
// values their (vh, vl) pairs in the same order.  Writes hit/vh/vl for every
// probe row [0, n): rows at or past np_valid, and misses, get 0.  Launches
// nothing when n == 0.  Returns cudaGetLastError().
int fhj_range_probe_materialize(const long long* keys, int64_t nb, const void* dir,
                                int dir_bytes, const int64_t* shift, const uint32_t* values,
                                const uint32_t* ph, const uint32_t* pl, int64_t n,
                                int64_t np_valid, uint8_t* hit, uint32_t* vh, uint32_t* vl,
                                cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  return dir_bytes == 8
             ? probe_materialize<int64_t>(keys, nb, dir, shift, values, ph, pl, n, np_valid,
                                          hit, vh, vl, stream)
             : probe_materialize<int32_t>(keys, nb, dir, shift, values, ph, pl, n, np_valid,
                                          hit, vh, vl, stream);
}

}  // extern "C"
