// The `global` tier's table build: a counting sort by home group in place
// of the sorts, the row-wise cummax and the segmented bloom scan.
//
// Replaces flash_hash_join_tpu/ops/hash_table.py:74 build_table: plain XLA
// (jax.lax.sort of (home, key) rows, a cumsum and a cummax for the slots,
// a segmented Hillis-Steele scan for the bloom words, scatters), not a
// Pallas kernel.  Its plain version is ops/hash_table.build_table_plain,
// which the CPU takes.
//
// The contract is the JAX table, bit for bit (keys, vals, bloom, special):
//  * rows [0, n_valid) take part; a u64-max key is never placed, and the
//    value of its minimum row rides special[0:3];
//  * rows are ordered by (home group, u64 key, row); of equal keys the
//    first, the minimum row, is kept with its value;
//  * a kept row's slot follows linear-probe insertion in that order:
//    slot_i = max(home_i * G, slot_{i-1} + 1).  Within a home group b the
//    k_b kept rows take consecutive slots from
//        start_b = max(end_{b-1}, b * G),   end_b = start_b + k_b,
//    a max-plus scan over the groups (an empty group passes end on, or
//    raises it to b * G, which no later start can fall below anyway);
//  * a slot at or past total_groups * G is not written and counts in
//    special[3]; with max_iters >= 0 a written row whose group lies
//    max_iters or more past its home counts too;
//  * bloom[b] is the OR of bloom_word(h, k) over the valid, non-max rows of
//    home b, duplicates included; 0 elsewhere.
//
// The work, on the current stream, with no host sync:
//   count_kernel   a pass over the rows: hash, home, atomicAdd of the
//                  group's count, atomicOr of the bloom tag (OR commutes:
//                  exact), atomicMin of the first u64-max row;
//   sum_tiles_kernel, scan_tiles_kernel, offsets_kernel
//                  the exclusive sum of the 2^gbits counts (tiles of
//                  kTileGroups groups, one block a tile, then one block over
//                  the tiles' sums, then the tiles again);
//   scatter_kernel a second pass: each row's id at its group's cursor
//                  (atomicAdd), so a group's rows are contiguous in `perm`,
//                  in no fixed order;
//   order_kernel   each group's rows ordered by (key, row) and cut to their
//                  first occurrences, written back to the front of the
//                  group's range; k_b kept.  A group of at most kSmall rows
//                  (nearly all: ~3 a group at the tier's load) is one
//                  thread's insertion sort; a larger one is sorted by its
//                  tile's whole block, in chunks of kChunk rows (a bitonic
//                  sort in shared memory) merged pairwise in device memory,
//                  so no group is O(k^2) and nothing depends on the order
//                  the atomics left.  The block also sums its tile's
//                  max-plus step;
//   scan_tiles_kernel  the max-plus scan over the tiles;
//   place_kernel   each group's start from its tile's and the block's scan,
//                  its kept rows' key and value words written to their
//                  slots (the large groups by the whole block), the drops
//                  counted, special[0:3] set from the first u64-max row.
// Scans are tile-wise and deterministic; every group is independent, so
// the table is the same whatever order the atomics took.
//
// What bounds it on an H100: device memory.  Each input byte read once
// and each plane word written once: at J1 1e8 Q5 1.6 GB of build planes
// and 4.3 GB of key and value planes (2^25 + 64 groups of 8), 1.76 ms at
// 3.35 TB/s.  This design reads the key planes twice (count, scatter),
// gathers each row's key again by its id to order its group (8 B, two
// 32-byte sectors) and its key and value to place it (16 B, four
// sectors), scatters the row ids (4 B each to a random address) and makes
// two passes of random atomics into the 2^gbits counts; right and simple
// first, so it sits several times above that bound (PERF.md).
#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kPer = 8;                         // groups a thread in a tile
constexpr int kTileGroups = fhj::kThreads * kPer;  // groups a tile: 2048
constexpr int kScanThreads = 1024;              // scan_tiles_kernel's block
constexpr int kSmall = 32;    // rows a group that one thread orders alone
constexpr int kChunk = 2048;  // rows a large group's block sorts in shared memory
constexpr int kItems = 8;     // merged rows a thread a step
constexpr uint32_t kNone = 0xFFFFFFFFu;

// x -> max(x + a, c): one group's step of the max-plus scan is
// {k_b, b * G + k_b}; a plain sum is {v, kNeg}.
struct MaxPlus {
  long long a, c;
};
constexpr long long kNeg = -(1ll << 62);

__device__ __forceinline__ MaxPlus identity() { return {0, kNeg}; }

// f, then g.
__device__ __forceinline__ MaxPlus then(MaxPlus f, MaxPlus g) {
  const long long c = f.c + g.a;
  return {f.a + g.a, c > g.c ? c : g.c};
}

__device__ __forceinline__ long long apply(MaxPlus f, long long x) {
  const long long y = x + f.a;
  return y > f.c ? y : f.c;
}

__device__ __forceinline__ MaxPlus shfl_up(MaxPlus f, int o) {
  return {__shfl_up_sync(0xffffffffu, f.a, o), __shfl_up_sync(0xffffffffu, f.c, o)};
}

// Exclusive scan of f over the block (kBlock threads, in thread order);
// *total gets the whole block's composition.  Every thread calls it.
template <int kBlock>
__device__ MaxPlus block_exclusive(MaxPlus f, MaxPlus* total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ long long wa[kWarps], wc[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  MaxPlus x = f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const MaxPlus y = shfl_up(x, o);
    if (lane >= o) x = then(y, x);
  }
  if (lane == 31) wa[warp] = x.a, wc[warp] = x.c;
  __syncthreads();
  if (warp == 0) {
    MaxPlus w = lane < kWarps ? MaxPlus{wa[lane], wc[lane]} : identity();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const MaxPlus y = shfl_up(w, o);
      if (lane >= o) w = then(y, w);
    }
    if (lane < kWarps) wa[lane] = w.a, wc[lane] = w.c;
  }
  __syncthreads();
  MaxPlus ex = shfl_up(x, 1);
  if (lane == 0) ex = identity();
  if (warp > 0) ex = then(MaxPlus{wa[warp - 1], wc[warp - 1]}, ex);
  *total = MaxPlus{wa[kWarps - 1], wc[kWarps - 1]};
  __syncthreads();  // the warp totals are read before another call rewrites them
  return ex;
}

struct Build {
  const uint32_t* kh;   // build planes, rows [0, n_valid)
  const uint32_t* kl;
  const uint32_t* vh;
  const uint32_t* vl;
  int64_t n_valid;
  int64_t groups;       // 2^gbits home groups
  int64_t total_groups; // groups + overflow groups
  int G, gbits, pre_shift, bloom_k, max_iters;  // max_iters < 0: no bound
  uint32_t* keys;       // (total_groups, 2G) planes
  uint32_t* vals;
  unsigned long long* bloom;    // (total_groups,) words, or null (no bloom)
  unsigned long long* special;  // (4,)
  uint32_t* count;      // (groups,): counts, then offsets, then range ends
  uint32_t* kept;       // (groups,): k_b
  uint32_t* perm;       // (n_valid,): row ids by group
  uint32_t* spare;      // (n_valid,): the large groups' merge buffer
  MaxPlus* tile_step;   // (tiles,)
  long long* tile_in;   // (tiles,): the scan's value before each tile
  uint32_t* max_row;    // the first u64-max row, or kNone
};

__device__ __forceinline__ bool is_max(uint32_t h, uint32_t l) {
  return (h & l) == 0xFFFFFFFFu;
}

__device__ __forceinline__ unsigned long long key_of(const Build& a, uint32_t r) {
  return ((unsigned long long)__ldg(a.kh + r) << 32) | __ldg(a.kl + r);
}

// (key, row) order, as the JAX package's stable sort by (home, key) leaves it
__device__ __forceinline__ bool before(unsigned long long ka, uint32_t ra,
                                      unsigned long long kb, uint32_t rb) {
  return ka < kb || (ka == kb && ra < rb);
}

// The rows of group b: [lo, hi) of perm, once scatter_kernel has run.
__device__ __forceinline__ void range_of(const uint32_t* count, int64_t b, int64_t* lo,
                                         int64_t* hi) {
  *lo = b ? count[b - 1] : 0;
  *hi = count[b];
}

__global__ void __launch_bounds__(fhj::kThreads) count_kernel(const Build a) {
  uint32_t first_max = kNone;
  fhj::for_each_pair_at(a.kh, a.kl, a.n_valid, [&](int64_t i, uint32_t h, uint32_t l) {
    if (is_max(h, l)) {
      first_max = min(first_max, (uint32_t)i);
      return;
    }
    const uint32_t x = fhj::hash_u64(h, l);
    const int64_t b = fhj::home_group(x, a.gbits, a.pre_shift);
    atomicAdd(a.count + b, 1u);
    if (a.bloom != nullptr) atomicOr(a.bloom + b, (unsigned long long)fhj::bloom_word(x, a.bloom_k));
  });
  first_max = __reduce_min_sync(0xffffffffu, first_max);
  if ((threadIdx.x & 31) == 0 && first_max != kNone) atomicMin(a.max_row, first_max);
}

// Each thread's kPer groups of the block's tile, composed in order.
template <typename Step>
__device__ __forceinline__ MaxPlus thread_steps(const Build& a, Step step) {
  MaxPlus f = identity();
  const int64_t b0 = (int64_t)blockIdx.x * kTileGroups + (int64_t)threadIdx.x * kPer;
  for (int q = 0; q < kPer && b0 + q < a.groups; ++q) f = then(f, step(b0 + q));
  return f;
}

__device__ __forceinline__ MaxPlus count_step(const Build& a, int64_t b) {
  return {(long long)a.count[b], kNeg};
}

__device__ __forceinline__ MaxPlus kept_step(const Build& a, int64_t b) {
  const long long k = a.kept[b];
  return {k, b * a.G + k};
}

__global__ void __launch_bounds__(fhj::kThreads) sum_tiles_kernel(const Build a) {
  MaxPlus total;
  block_exclusive<fhj::kThreads>(thread_steps(a, [&](int64_t b) { return count_step(a, b); }),
                                 &total);
  if (threadIdx.x == 0) a.tile_step[blockIdx.x] = total;
}

// One block: tile_in[t] = the scan's value before tile t, from 0.
__global__ void __launch_bounds__(kScanThreads) scan_tiles_kernel(const Build a, int64_t tiles) {
  const int64_t per = (tiles + kScanThreads - 1) / kScanThreads;
  const int64_t t0 = threadIdx.x * per;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  MaxPlus f = identity();
  for (int64_t t = t0; t < t1; ++t) f = then(f, a.tile_step[t]);
  MaxPlus total;
  long long x = apply(block_exclusive<kScanThreads>(f, &total), 0);
  for (int64_t t = t0; t < t1; ++t) {
    a.tile_in[t] = x;
    x = apply(a.tile_step[t], x);
  }
}

// The counts become exclusive offsets, in place.
__global__ void __launch_bounds__(fhj::kThreads) offsets_kernel(const Build a) {
  MaxPlus total;
  const MaxPlus ex = block_exclusive<fhj::kThreads>(
      thread_steps(a, [&](int64_t b) { return count_step(a, b); }), &total);
  long long x = apply(ex, a.tile_in[blockIdx.x]);
  const int64_t b0 = (int64_t)blockIdx.x * kTileGroups + (int64_t)threadIdx.x * kPer;
  for (int q = 0; q < kPer && b0 + q < a.groups; ++q) {
    const uint32_t c = a.count[b0 + q];
    a.count[b0 + q] = (uint32_t)x;
    x += c;
  }
}

__global__ void __launch_bounds__(fhj::kThreads) scatter_kernel(const Build a) {
  fhj::for_each_pair_at(a.kh, a.kl, a.n_valid, [&](int64_t i, uint32_t h, uint32_t l) {
    if (is_max(h, l)) return;
    const int64_t b = fhj::home_group(fhj::hash_u64(h, l), a.gbits, a.pre_shift);
    a.perm[atomicAdd(a.count + b, 1u)] = (uint32_t)i;
  });
}

// A group of s <= kSmall rows, ordered by one thread: its first
// occurrences go to the front of rows[]; returns their number.
__device__ int order_small(const Build& a, uint32_t* rows, int s) {
  unsigned long long key[kSmall];
  uint32_t row[kSmall];
  for (int i = 0; i < s; ++i) row[i] = rows[i];
  for (int i = 0; i < s; ++i) key[i] = key_of(a, row[i]);
  for (int i = 1; i < s; ++i) {     // insertion sort
    const unsigned long long k = key[i];
    const uint32_t r = row[i];
    int j = i;
    for (; j > 0 && before(k, r, key[j - 1], row[j - 1]); --j) {
      key[j] = key[j - 1];
      row[j] = row[j - 1];
    }
    key[j] = k;
    row[j] = r;
  }
  int n = 0;
  for (int i = 0; i < s; ++i)
    if (i == 0 || key[i] != key[i - 1]) rows[n++] = row[i];
  return n;
}

struct SortSmem {
  unsigned long long key[kChunk];
  uint32_t row[kChunk];
};

// rows[0, s), s <= kChunk, sorted by (key, row) in place by the block: a
// bitonic sort in shared memory over the next power of two, padded with
// (u64-max, kNone), which no placed row has.
__device__ void sort_chunk(const Build& a, uint32_t* rows, int s, SortSmem& sm) {
  int n2 = 1;
  while (n2 < s) n2 <<= 1;
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const uint32_t r = i < s ? rows[i] : kNone;
    sm.row[i] = r;
    sm.key[i] = i < s ? key_of(a, r) : ~0ull;
  }
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const bool up = (i & k) == 0;
          const bool later = before(sm.key[p], sm.row[p], sm.key[i], sm.row[i]);
          if (later == up) {
            const unsigned long long tk = sm.key[i];
            const uint32_t tr = sm.row[i];
            sm.key[i] = sm.key[p], sm.row[i] = sm.row[p];
            sm.key[p] = tk, sm.row[p] = tr;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < s; i += blockDim.x) rows[i] = sm.row[i];
  __syncthreads();
}

// How many of the first `diag` rows of the merge of x[0, nx) and
// y[0, ny) come from x (merge path).
__device__ int merge_split(const Build& a, const uint32_t* x, int nx, const uint32_t* y, int ny,
                           int diag) {
  int lo = diag > ny ? diag - ny : 0, hi = diag < nx ? diag : nx;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint32_t rx = x[mid], ry = y[diag - 1 - mid];
    if (before(key_of(a, rx), rx, key_of(a, ry), ry))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// src[0, s), sorted in runs of w rows, merged pairwise into dst: runs of 2w.
__device__ void merge_pass(const Build& a, const uint32_t* src, uint32_t* dst, int s,
                           long long w) {
  for (long long p = 0; p < s; p += 2 * w) {
    const uint32_t* x = src + p;
    const int nx = (int)(w < s - p ? w : s - p);
    const uint32_t* y = x + nx;
    const int ny = (int)(w < s - p - nx ? w : s - p - nx);
    for (int d = threadIdx.x * kItems; d < nx + ny; d += blockDim.x * kItems) {
      int i = merge_split(a, x, nx, y, ny, d), j = d - i;
      const int end = d + kItems < nx + ny ? d + kItems : nx + ny;
      for (int o = d; o < end; ++o) {
        bool take_x = j >= ny;
        if (!take_x && i < nx) {
          const uint32_t rx = x[i], ry = y[j];
          take_x = before(key_of(a, rx), rx, key_of(a, ry), ry);
        }
        dst[p + o] = take_x ? x[i++] : y[j++];
      }
    }
  }
  __syncthreads();
}

// The first occurrences of the sorted rows src[0, s), in order, to
// dst[0, k) (dst may be src: a row moves to a place at or before its
// own, after its block's reads); returns k.
__device__ int first_occurrences(const Build& a, const uint32_t* src, uint32_t* dst, int s,
                                 SortSmem& sm) {
  __shared__ unsigned long long last;  // the key before the block's rows
  int k = 0;
  for (int base = 0; base < s; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const uint32_t r = i < s ? src[i] : kNone;
    const unsigned long long key = i < s ? key_of(a, r) : ~0ull;
    sm.key[threadIdx.x] = key;
    __syncthreads();
    const unsigned long long prev = threadIdx.x ? sm.key[threadIdx.x - 1] : last;
    const int first = i < s && (i == 0 || key != prev);
    MaxPlus total;  // a plain sum: {first, kNeg}
    const long long at = block_exclusive<fhj::kThreads>({first, kNeg}, &total).a;
    if (first) dst[k + at] = r;
    if (threadIdx.x == blockDim.x - 1) last = key;
    k += (int)total.a;
    __syncthreads();
  }
  return k;
}

// A group of s > kSmall rows at rows[0, s), ordered and cut to its first
// occurrences by the whole block (spare[0, s) the merge buffer); returns k.
__device__ int order_large(const Build& a, uint32_t* rows, uint32_t* spare, int s,
                           SortSmem& sm) {
  for (int c = 0; c < s; c += kChunk) sort_chunk(a, rows + c, kChunk < s - c ? kChunk : s - c, sm);
  uint32_t *src = rows, *dst = spare;
  for (long long w = kChunk; w < s; w <<= 1) {
    merge_pass(a, src, dst, s, w);
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  return first_occurrences(a, src, rows, s, sm);
}

// One block a tile of kTileGroups groups: each group's rows ordered and cut
// to their first occurrences (k_b into kept), then the tile's max-plus step.
__global__ void __launch_bounds__(fhj::kThreads) order_kernel(const Build a) {
  __shared__ SortSmem sm;
  __shared__ uint32_t large[kTileGroups];
  __shared__ int n_large;
  if (threadIdx.x == 0) n_large = 0;
  __syncthreads();
  const int64_t b0 = (int64_t)blockIdx.x * kTileGroups + (int64_t)threadIdx.x * kPer;
  for (int q = 0; q < kPer && b0 + q < a.groups; ++q) {
    int64_t lo, hi;
    range_of(a.count, b0 + q, &lo, &hi);
    if (hi - lo <= kSmall)
      a.kept[b0 + q] = order_small(a, a.perm + lo, (int)(hi - lo));
    else
      large[atomicAdd(&n_large, 1)] = (uint32_t)(b0 + q - (int64_t)blockIdx.x * kTileGroups);
  }
  __syncthreads();
  for (int e = 0; e < n_large; ++e) {
    const int64_t b = (int64_t)blockIdx.x * kTileGroups + large[e];
    int64_t lo, hi;
    range_of(a.count, b, &lo, &hi);
    const int k = order_large(a, a.perm + lo, a.spare + lo, (int)(hi - lo), sm);
    if (threadIdx.x == 0) a.kept[b] = k;
  }
  __syncthreads();
  MaxPlus total;
  block_exclusive<fhj::kThreads>(thread_steps(a, [&](int64_t b) { return kept_step(a, b); }),
                                 &total);
  if (threadIdx.x == 0) a.tile_step[blockIdx.x] = total;
}

// Row r of home group b at `slot`: its key and value words, or a drop.
__device__ __forceinline__ void place(const Build& a, uint32_t r, int64_t b, long long slot,
                                      unsigned long long* drops) {
  if (slot >= a.total_groups * a.G) {
    ++*drops;
    return;
  }
  const int64_t g = slot / a.G;
  const int64_t at = g * 2 * a.G + (slot - g * a.G);
  a.keys[at] = __ldg(a.kh + r);
  a.keys[at + a.G] = __ldg(a.kl + r);
  a.vals[at] = __ldg(a.vh + r);
  a.vals[at + a.G] = __ldg(a.vl + r);
  if (a.max_iters >= 0 && g - b >= a.max_iters) ++*drops;  // out of the walk's reach
}

// One block a tile: each group's start from the scan, its kept rows
// placed (a large group's by the whole block), the drops added into
// special[3]; block 0 also sets special[0:3].
__global__ void __launch_bounds__(fhj::kThreads) place_kernel(const Build a) {
  __shared__ uint32_t large[kTileGroups];
  __shared__ long long large_start[kTileGroups];
  __shared__ int n_large;
  if (threadIdx.x == 0) n_large = 0;
  MaxPlus total;
  const MaxPlus ex = block_exclusive<fhj::kThreads>(
      thread_steps(a, [&](int64_t b) { return kept_step(a, b); }), &total);
  long long x = apply(ex, a.tile_in[blockIdx.x]);
  unsigned long long drops = 0;
  const int64_t t0 = (int64_t)blockIdx.x * kTileGroups;
  const int64_t b0 = t0 + (int64_t)threadIdx.x * kPer;
  for (int q = 0; q < kPer && b0 + q < a.groups; ++q) {
    const int64_t b = b0 + q;
    const long long start = x > b * a.G ? x : b * a.G;
    const uint32_t k = a.kept[b];
    int64_t lo, hi;
    range_of(a.count, b, &lo, &hi);
    if (hi - lo <= kSmall) {
      for (uint32_t j = 0; j < k; ++j) place(a, a.perm[lo + j], b, start + j, &drops);
    } else {
      const int e = atomicAdd(&n_large, 1);
      large[e] = (uint32_t)(b - t0);
      large_start[e] = start;
    }
    x = start + k;
  }
  __syncthreads();
  for (int e = 0; e < n_large; ++e) {
    const int64_t b = t0 + large[e];
    const uint32_t k = a.kept[b];
    int64_t lo, hi;
    range_of(a.count, b, &lo, &hi);
    for (uint32_t j = threadIdx.x; j < k; j += blockDim.x)
      place(a, a.perm[lo + j], b, large_start[e] + j, &drops);
  }
  const unsigned long long s = fhj::block_sum(drops);
  if (threadIdx.x == 0 && s) atomicAdd(a.special + 3, s);
  if (blockIdx.x == 0 && threadIdx.x == 0 && *a.max_row != kNone) {
    a.special[0] = 1;
    a.special[1] = __ldg(a.vh + *a.max_row);
    a.special[2] = __ldg(a.vl + *a.max_row);
  }
}

int64_t tiles_of(int gbits) { return ((1ll << gbits) + kTileGroups - 1) / kTileGroups; }

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The scratch layout: count, kept, perm, tile_step, tile_in, max_row.
size_t scratch_bytes(int gbits, int64_t n_valid) {
  const size_t groups = (size_t)1 << gbits;
  return 2 * align16(groups * 4) + align16((size_t)n_valid * 4) +
         (size_t)tiles_of(gbits) * (sizeof(MaxPlus) + 8) + 16;
}

}  // namespace

extern "C" {

// Bytes of device scratch fhj_global_build needs.
int64_t fhj_global_build_scratch_bytes(int gbits, int64_t n_valid) {
  return (int64_t)scratch_bytes(gbits, n_valid);
}

// The global tier's table from the build planes (kh, kl, vh, vl)[0,
// n_valid): keys and vals (total_groups, 2G) u32 planes, bloom
// (bloom_words,) u64 words (total_groups with bloom, 1 without), special
// (4,) int64: [has_max, max_vh, max_vl, n_dropped].  max_iters < 0: no
// probe bound.  scratch: fhj_global_build_scratch_bytes(gbits, n_valid)
// bytes; spare: n_valid u32 words, read and written before vals is
// cleared, so it may be vals itself when that is large enough.  On
// `stream`, no sync; returns cudaGetLastError().
int fhj_global_build(const uint32_t* kh, const uint32_t* kl, const uint32_t* vh,
                     const uint32_t* vl, int64_t n_valid, int gbits, int group_size,
                     int64_t total_groups, int pre_shift, int bloom_k, int max_iters,
                     uint32_t* keys, uint32_t* vals, unsigned long long* bloom,
                     int64_t bloom_words, int with_bloom, unsigned long long* special,
                     void* scratch, int64_t scratch_size, uint32_t* spare, cudaStream_t stream) {
  const int64_t groups = 1ll << (gbits < 0 ? 0 : gbits);
  if (gbits < 0 || gbits > 30 || pre_shift < 0 || pre_shift > 32 || group_size < 1 ||
      group_size > 32 || total_groups < groups || n_valid < 0 || n_valid > 0x7fffffff ||
      bloom_words < 1 || (with_bloom && bloom_words != total_groups) ||
      scratch_size < (int64_t)scratch_bytes(gbits, n_valid))
    return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)total_groups * 2 * group_size;
  char* p = static_cast<char*>(scratch);
  Build a{kh, kl, vh, vl, n_valid, groups, total_groups, group_size, gbits, pre_shift,
          bloom_k, max_iters, keys, vals, with_bloom ? bloom : nullptr, special};
  a.count = reinterpret_cast<uint32_t*>(p);
  p += align16(groups * 4);
  a.kept = reinterpret_cast<uint32_t*>(p);
  p += align16(groups * 4);
  a.perm = reinterpret_cast<uint32_t*>(p);
  p += align16((size_t)n_valid * 4);
  const int64_t tiles = tiles_of(gbits);
  a.tile_step = reinterpret_cast<MaxPlus*>(p);
  p += tiles * sizeof(MaxPlus);
  a.tile_in = reinterpret_cast<long long*>(p);
  p += tiles * 8;
  a.max_row = reinterpret_cast<uint32_t*>(p);
  a.spare = spare;

  cudaError_t e = cudaMemsetAsync(special, 0, 4 * sizeof(*special), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(bloom, 0, bloom_words * sizeof(*bloom), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(keys, 0xFF, words * 4, stream);
  if (e != cudaSuccess || n_valid == 0)
    return (int)(e == cudaSuccess ? cudaMemsetAsync(vals, 0, words * 4, stream) : e);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.count, 0, groups * 4, stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.max_row, 0xFF, 4, stream);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)tiles;
  if ((e = fhj::launch(count_kernel, n_valid, stream, a)) != cudaSuccess) return (int)e;
  sum_tiles_kernel<<<grid, fhj::kThreads, 0, stream>>>(a);
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(a, tiles);
  offsets_kernel<<<grid, fhj::kThreads, 0, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = fhj::launch(scatter_kernel, n_valid, stream, a)) != cudaSuccess) return (int)e;
  order_kernel<<<grid, fhj::kThreads, 0, stream>>>(a);
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(a, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = cudaMemsetAsync(vals, 0, words * 4, stream)) != cudaSuccess) return (int)e;
  place_kernel<<<grid, fhj::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
