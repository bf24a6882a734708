// The `global` tier's table build: the rows, carried with their key and
// value words, partitioned by home group into tiles that fit in shared
// memory, and each tile finished there, its carry from the tiles before it
// by a decoupled look-back.  In place of the sorts, the row-wise cummax and
// the segmented bloom scan.
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
// The work, on the current stream, with no host sync; the plan (how many
// levels, their bits, blocks a parent partition) comes from the wrapper
// (ops/cuda/hash_build.plan), which sizes a tile to at most 3/4 of kCap
// rows on average:
//   one or two partition levels, each three launches (partition.cuh):
//     hist_kernel    a block a slice of a parent partition: the rows'
//                    digits (the next bits of their home group) counted in
//                    shared memory, one count a digit written out; level 0
//                    reads the build planes, skips u64-max rows and takes
//                    their first row by a block minimum and one atomic;
//     scan_kernel    the exclusive sums of the counts (parent, digit,
//                    block), a single pass with a decoupled look-back:
//                    each block's offset a digit, and each child
//                    partition's start;
//     scatter_kernel the slice again, kChunkRows rows at a time: ranked a
//                    digit by a shared atomic, staged in shared memory by
//                    digit as 20-byte records (kh, kl, vh, vl, row), then
//                    written out a word a thread, each digit's run of
//                    records at its cursor, so no later pass gathers a word
//                    by row id.  A level of 0 bits is a compaction of the
//                    placeable rows;
//   finish_kernel   a block a tile, taken from a ticket counter: the tile's
//                    records loaded into shared memory by one bulk copy
//                    (cp.async.bulk on an mbarrier); its rows counted a
//                    group (the bloom word ORed in on the way, a duplicate
//                    having its key's word), listed by group, and each
//                    group ordered by (key, row) and cut to its first
//                    occurrences: a group of at most kSmall rows ranked a
//                    thread a row (a row is its key's first when no row of
//                    its group has its key and a smaller row id; its place
//                    is the number of first rows with a smaller key), a
//                    larger one by a bitonic sort of the block; the tile's
//                    max-plus step composed over its groups, its carry-in
//                    found by a decoupled look-back over the tiles before
//                    it (max-plus composition is associative, not
//                    commutative: it composes in tile order; each state a
//                    64-bit word that carries its own flag, so one round of
//                    loads reads 32 tiles), and every slot of [R_{t-1}, R_t)
//                    written once, in order, a kept row or the empty
//                    sentinel, R_t = max(end_t, (last group of t + 1) * G);
//                    the last tile runs on to total_groups * G.  Drops and
//                    out-of-reach rows: one atomic a block.  A tile of more
//                    than kCap rows (an oversize tile: many equal keys, many
//                    keys homed to few groups) is finished the same way from
//                    device memory, its order and merge buffers scratch of
//                    their own: a small group ordered by one thread, a
//                    larger one sorted in chunks of kChunk rows (a bitonic
//                    sort in shared memory) merged pairwise, so no case is
//                    O(k^2).
// 3 x levels + 1 launches and three memsets (special, the scratch's
// counters and look-back words, the bloom word when bloom is off); no
// memset of the key or value planes and no per-row atomic to device memory.
//
// What bounds it on an H100: device memory.  Each input byte read once
// and each plane word written once: at J1 1e8 Q5 1.6 GB of build planes
// and 4.3 GB of key and value planes (2^25 + 64 groups of 8), 1.76 ms at
// 3.35 TB/s.  Two levels move about 14 GB in order (the build planes'
// keys twice and all four once, 20 B a row written and read back twice,
// the planes written once): about 4.2 ms at that rate.  It runs at 11.9 ms
// there (PERF.md): the finish 5.5 ms, latency-bound a tile (three blocks an
// SM; more tiles at once did not help, fewer hurt, larger tiles helped),
// each scatter 2.5-2.6 ms (1.4-1.5 TB/s), the counts 1.0 ms.
#include "common.cuh"
#include "hash.cuh"
#include "partition.cuh"  // the levels: hist, scan, scatter; the look-back

namespace {

constexpr int kCap = 2048;                   // rows a tile finished in shared memory
constexpr int kMaxTileBits = 9;              // groups a tile: at most 512
constexpr int kMaxGroups = 1 << kMaxTileBits;
constexpr int kGroupsPer = kMaxGroups / kBlock;  // groups a thread composes
constexpr int kSmall = 32;    // rows a group that one thread orders alone
constexpr int kChunk = 2048;  // rows an oversize group's block sorts in shared memory
constexpr int kItems = 8;     // merged rows a thread a step
constexpr int kWords = BuildRecords::kWords;  // a carried row: kh, kl, vh, vl, row

// ---- the finish ------------------------------------------------------------------

struct Finish {
  const uint32_t* data; // the tiles' rows: the last level's records
  uint32_t* order;      // an oversize tile's row order (at its rows' positions)
  uint32_t* merge;      // and its merge buffer
  const uint32_t* tile_start;  // (tiles + 1,)
  int64_t tiles;
  int tile_bits, gbits, pre_shift, G, gshift, bloom_k, max_iters;
  int64_t total_groups;
  uint32_t* keys;       // (total_groups, 2G) planes
  uint32_t* vals;
  unsigned long long* bloom;    // (total_groups,) words, or null (no bloom)
  unsigned long long* special;  // (4,)
  const uint32_t* vh0;  // the build planes' values, for special[1:3]
  const uint32_t* vl0;
  const unsigned* max_row;
  Chain chain;
};

// A tile's rows, kWords-word records in shared memory or (oversize) device
// memory; index i is the row's position in the tile.
struct View {
  const uint32_t* rec;
  __device__ __forceinline__ uint32_t word(uint32_t i, int q) const {
    return rec[(size_t)kWords * i + q];
  }
  __device__ __forceinline__ unsigned long long key(uint32_t i) const {
    return ((unsigned long long)word(i, 0) << 32) | word(i, 1);
  }
  __device__ __forceinline__ uint32_t row(uint32_t i) const { return word(i, 4); }
  // (key, row) order, as the JAX package's stable sort by (home, key)
  // leaves it inside a group
  __device__ __forceinline__ bool less(uint32_t i, uint32_t j) const {
    const unsigned long long a = key(i), b = key(j);
    return a < b || (a == b && row(i) < row(j));
  }
};

struct SortSmem {  // an oversize group's chunk: (key, row, position)
  unsigned long long key[kChunk];
  uint32_t row[kChunk];
  uint32_t pos[kChunk];
};

struct FinishSmem {
  union {
    uint32_t rec[kWords * kCap + 8];  // the tile's rows, from a 16-byte boundary
    SortSmem sort;
  } u;
  uint32_t bloom[kMaxGroups];    // the groups' bloom words
  uint32_t off[kMaxGroups + 1];  // the groups' rows in `perm`
  uint32_t kept[kMaxGroups];     // counts, cursors, then k_b
  uint32_t start[kMaxGroups];    // a group's first slot, from the tile's first
  uint32_t perm[kCap];           // the rows by group, kept rows first
  uint32_t tmp[kCap];            // a large group's bitonic order; the slot map
  uint8_t first[kCap];           // a row of a small group is its key's first
  unsigned long long bar;        // the load's mbarrier
};

// A bitonic sort of n2 (a power of two) entries by the block: swap(i, p)
// where less(p, i) disagrees with the direction.
template <typename Less, typename Swap>
__device__ void bitonic(int n2, Less less, Swap swap) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kBlock) {
        const int p = i ^ j;
        if (p > i && less(p, i) == ((i & k) == 0)) swap(i, p);
      }
      __syncthreads();
    }
  }
}

// rows[0, s), s <= kCap, positions in a tile in shared memory, sorted by
// the block through tmp, padded with kNone (last).
__device__ void sort_in_place(const View& v, uint32_t* rows, int s, uint32_t* tmp) {
  int n2 = 1;
  while (n2 < s) n2 <<= 1;
  for (int i = threadIdx.x; i < n2; i += kBlock) tmp[i] = i < s ? rows[i] : kNone;
  __syncthreads();
  bitonic(
      n2,
      [&](int x, int y) {
        const uint32_t a = tmp[x], b = tmp[y];
        return b == kNone ? a != kNone : a != kNone && v.less(a, b);
      },
      [&](int x, int y) {
        const uint32_t t = tmp[x];
        tmp[x] = tmp[y];
        tmp[y] = t;
      });
  for (int i = threadIdx.x; i < s; i += kBlock) rows[i] = tmp[i];
  __syncthreads();
}

// rows[0, s), s <= kChunk, positions in an oversize tile in device memory,
// sorted by the block with their keys and rows copied into shared memory,
// padded with (u64-max, kNone), which no placed row has.
__device__ void sort_chunk(const View& v, uint32_t* rows, int s, SortSmem& sm) {
  int n2 = 1;
  while (n2 < s) n2 <<= 1;
  for (int i = threadIdx.x; i < n2; i += kBlock) {
    const uint32_t r = i < s ? rows[i] : kNone;
    sm.pos[i] = r;
    sm.key[i] = i < s ? v.key(r) : ~0ull;
    sm.row[i] = i < s ? v.row(r) : kNone;
  }
  __syncthreads();
  bitonic(
      n2,
      [&](int x, int y) {
        return sm.key[x] < sm.key[y] || (sm.key[x] == sm.key[y] && sm.row[x] < sm.row[y]);
      },
      [&](int x, int y) {
        const unsigned long long tk = sm.key[x];
        const uint32_t tr = sm.row[x], tp = sm.pos[x];
        sm.key[x] = sm.key[y], sm.row[x] = sm.row[y], sm.pos[x] = sm.pos[y];
        sm.key[y] = tk, sm.row[y] = tr, sm.pos[y] = tp;
      });
  for (int i = threadIdx.x; i < s; i += kBlock) rows[i] = sm.pos[i];
  __syncthreads();
}

// How many of the first `diag` rows of the merge of x[0, nx) and y[0, ny)
// come from x (merge path).
__device__ uint32_t merge_split(const View& v, const uint32_t* x, uint32_t nx, const uint32_t* y,
                                uint32_t ny, uint32_t diag) {
  uint32_t lo = diag > ny ? diag - ny : 0, hi = diag < nx ? diag : nx;
  while (lo < hi) {
    const uint32_t mid = (lo + hi) >> 1;
    if (v.less(x[mid], y[diag - 1 - mid]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// src[0, s), sorted in runs of w rows, merged pairwise into dst: runs of 2w.
__device__ void merge_pass(const View& v, const uint32_t* src, uint32_t* dst, uint32_t s,
                           uint32_t w) {
  for (uint32_t p = 0; p < s; p += 2 * w) {
    const uint32_t* x = src + p;
    const uint32_t nx = w < s - p ? w : s - p;
    const uint32_t* y = x + nx;
    const uint32_t ny = w < s - p - nx ? w : s - p - nx;
    for (uint32_t d = threadIdx.x * kItems; d < nx + ny; d += kBlock * kItems) {
      uint32_t i = merge_split(v, x, nx, y, ny, d), j = d - i;
      const uint32_t end = d + kItems < nx + ny ? d + kItems : nx + ny;
      for (uint32_t o = d; o < end; ++o) {
        const bool take_x = j >= ny || (i < nx && v.less(x[i], y[j]));
        dst[p + o] = take_x ? x[i++] : y[j++];
      }
    }
  }
  __syncthreads();
}

// The first occurrences of the sorted rows src[0, s), in order, to dst[0,
// k) (dst may be src: a row moves to a place at or before its own, after
// the block's reads); returns k.
__device__ uint32_t first_occurrences(const View& v, const uint32_t* src, uint32_t* dst,
                                      uint32_t s) {
  __shared__ unsigned long long keys[kBlock];
  __shared__ unsigned long long last;  // the key before the block's rows
  uint32_t k = 0;
  for (uint32_t base = 0; base < s; base += kBlock) {
    const uint32_t i = base + threadIdx.x;
    const uint32_t r = i < s ? src[i] : kNone;
    const unsigned long long key = i < s ? v.key(r) : ~0ull;
    keys[threadIdx.x] = key;
    __syncthreads();
    const unsigned long long prev = threadIdx.x ? keys[threadIdx.x - 1] : last;
    const int first = i < s && (i == 0 || key != prev);
    MaxPlus total;  // a plain sum: {first, kNeg}
    const long long at = block_exclusive({first, kNeg}, &total).a;
    if (first) dst[k + at] = r;
    if (threadIdx.x == kBlock - 1) last = key;
    k += (uint32_t)total.a;
    __syncthreads();
  }
  return k;
}

// A group of s <= kSmall rows of an oversize tile, ordered by one thread
// (insertion sort) and cut to its first occurrences at the front of
// rows[]; returns their number.
__device__ uint32_t order_small(const View& v, uint32_t* rows, uint32_t s) {
  for (uint32_t i = 1; i < s; ++i) {
    const uint32_t r = rows[i];
    uint32_t j = i;
    for (; j > 0 && v.less(r, rows[j - 1]); --j) rows[j] = rows[j - 1];
    rows[j] = r;
  }
  uint32_t n = 0;
  unsigned long long prev = 0;
  for (uint32_t i = 0; i < s; ++i) {
    const uint32_t r = rows[i];
    const unsigned long long k = v.key(r);
    if (i == 0 || k != prev) rows[n++] = r;
    prev = k;
  }
  return n;
}

// Row i's home group in its tile, counted; its bloom word ORed into its
// group's (a duplicate has its key's word).  Returns the group.
__device__ __forceinline__ uint32_t count_row(const View& v, uint32_t i, const Finish& a,
                                              long long g0, FinishSmem& sm) {
  const uint32_t h = fhj::hash_u64(v.word(i, 0), v.word(i, 1));
  const uint32_t b = (uint32_t)(fhj::home_group(h, a.gbits, a.pre_shift) - g0);
  atomicAdd(sm.kept + b, 1u);
  if (a.bloom != nullptr) atomicOr(sm.bloom + b, fhj::bloom_word(h, a.bloom_k));
  return b;
}

// The groups' offsets in perm from their counts (sm.kept), which become
// the groups' cursors.
__device__ __forceinline__ void group_offsets(FinishSmem& sm, int ng, uint32_t m) {
  block_scan_counts(sm.kept, sm.off, ng);
  if (threadIdx.x == 0) sm.off[ng] = m;
  __syncthreads();
  for (int b = threadIdx.x; b < ng; b += kBlock) sm.kept[b] = sm.off[b];
  __syncthreads();
}

// A tile in shared memory: its rows by group into sm.perm, then each row of
// a small group ranked a thread a row (the tile holds at most kCap rows,
// kPer a thread): it is its key's first when no row of its group has its
// key and a smaller row id, and a first row's place among its group's kept
// rows is the number of first rows with a smaller key.  The kept rows go to
// the front of their group's range, k_b to sm.kept.
__device__ void order_tile(const View& v, uint32_t m, const Finish& a, long long g0, int ng,
                           FinishSmem& sm) {
  constexpr int kPer = kCap / kBlock;
  uint32_t grp[kPer], at[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t i = k * kBlock + threadIdx.x;
    grp[k] = i < m ? count_row(v, i, a, g0, sm) : 0u;
  }
  __syncthreads();
  group_offsets(sm, ng, m);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t i = k * kBlock + threadIdx.x;
    if (i < m) sm.perm[atomicAdd(sm.kept + grp[k], 1u)] = i;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < ng; b += kBlock)
    if (sm.off[b + 1] - sm.off[b] <= kSmall) sm.kept[b] = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t i = k * kBlock + threadIdx.x;
    if (i >= m) continue;
    const uint32_t lo = sm.off[grp[k]], s = sm.off[grp[k] + 1] - lo;
    if (s > kSmall) continue;
    const unsigned long long key = v.key(i);
    const uint32_t row = v.row(i);
    bool first = true;
    for (uint32_t q = 0; q < s; ++q) {
      const uint32_t j = sm.perm[lo + q];
      first &= !(v.key(j) == key && v.row(j) < row);
    }
    sm.first[i] = first;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const uint32_t i = k * kBlock + threadIdx.x;
    at[k] = kNone;
    if (i >= m || !sm.first[i]) continue;
    const uint32_t lo = sm.off[grp[k]], s = sm.off[grp[k] + 1] - lo;
    if (s > kSmall) continue;
    const unsigned long long key = v.key(i);
    uint32_t below = 0;
    for (uint32_t q = 0; q < s; ++q) {
      const uint32_t j = sm.perm[lo + q];
      below += sm.first[j] && v.key(j) < key;
    }
    at[k] = lo + below;
    atomicAdd(sm.kept + grp[k], 1u);
  }
  __syncthreads();  // every group's rows are read before the kept rows move
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (at[k] != kNone) sm.perm[at[k]] = k * kBlock + threadIdx.x;
}

// A tile's records [r0, r1) (r1 - r0 <= kCap) into shared memory, from the
// 16-byte boundary at or below the first: one bulk copy on an mbarrier,
// which every thread waits on; returns the first record's word in sm.u.rec.
__device__ int load_tile(const uint32_t* d, uint32_t r0, uint32_t r1, FinishSmem& sm) {
  const uint64_t a0 = ((uint64_t)kWords * r0) & ~3ull, a1 = ((uint64_t)kWords * r1 + 3) & ~3ull;
  const uint32_t bytes = (uint32_t)(a1 - a0) * 4u;
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&sm.bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(sm.u.rec);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            dst),
        "l"(d + a0), "r"(bytes), "r"(bar)
        : "memory");
  }
  __syncthreads();  // the barrier is set up before anyone waits on it
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, "
        "0, p;\n}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
  return (int)(kWords * (uint64_t)r0 - a0);
}

__global__ void __launch_bounds__(kBlock, 3) finish_kernel(const Finish a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FinishSmem& sm = *reinterpret_cast<FinishSmem*>(smem_raw);
  __shared__ long long t_sh, before_sh;
  __shared__ uint16_t large[kMaxGroups];  // groups of more than kSmall rows
  __shared__ int n_large;
  const int tid = threadIdx.x;
  if (tid == 0) {
    t_sh = atomicAdd(a.chain.ticket, 1u);
    n_large = 0;
  }
  __syncthreads();
  const long long t = t_sh;
  const int ng = 1 << a.tile_bits;
  const long long g0 = t << a.tile_bits;
  const uint32_t r0 = a.tile_start[t], r1 = a.tile_start[t + 1];
  const uint32_t m = r1 - r0;
  const bool inside = m <= kCap;
  View v;
  uint32_t *perm, *merge = nullptr;
  int sh = 0;  // the tile's first word in sm.u.rec
  if (inside) {
    if (m) sh = load_tile(a.data, r0, r1, sm);
    v = View{sm.u.rec + sh};
    perm = sm.perm;
  } else {
    v = View{a.data + (size_t)kWords * r0};
    perm = a.order + r0;
    merge = a.merge + r0;
  }
  for (int b = tid; b < ng; b += kBlock) sm.kept[b] = sm.bloom[b] = 0;
  __syncthreads();

  // each group's rows ordered by (key, row) and cut to their first
  // occurrences, k_b of them: the rows by group (counts, offsets, then each
  // row's place, a group's rows in the atomics' order), then a small group
  // ranked a thread a row (in shared memory) or ordered by a thread
  // (oversize), a large one sorted by the block
  if (inside) {
    order_tile(View{sm.u.rec + sh}, m, a, g0, ng, sm);
  } else {
    for (uint32_t base = 0; base < m; base += kBlock)
      if (base + tid < m) count_row(v, base + tid, a, g0, sm);
    __syncthreads();
    group_offsets(sm, ng, m);
    for (uint32_t base = 0; base < m; base += kBlock) {
      const uint32_t i = base + tid;
      if (i < m) {
        const uint32_t h = fhj::hash_u64(v.word(i, 0), v.word(i, 1));
        perm[atomicAdd(sm.kept + (fhj::home_group(h, a.gbits, a.pre_shift) - g0), 1u)] = i;
      }
    }
    __syncthreads();
    for (int b = tid; b < ng; b += kBlock) {
      const uint32_t lo = sm.off[b], s = sm.off[b + 1] - lo;
      if (s <= kSmall) sm.kept[b] = order_small(v, perm + lo, s);
    }
  }
  for (int b = tid; b < ng; b += kBlock)
    if (sm.off[b + 1] - sm.off[b] > kSmall) large[atomicAdd(&n_large, 1)] = (uint16_t)b;
  __syncthreads();
  for (int e = 0; e < n_large; ++e) {
    const int b = large[e];
    const uint32_t lo = sm.off[b], s = sm.off[b + 1] - lo;
    const uint32_t* sorted = perm + lo;
    if (inside) {
      sort_in_place(v, perm + lo, (int)s, sm.tmp);
    } else {
      for (uint32_t c = 0; c < s; c += kChunk)
        sort_chunk(v, perm + lo + c, (int)(kChunk < s - c ? kChunk : s - c), sm.u.sort);
      uint32_t *src = perm + lo, *dst = merge + lo;
      for (uint32_t w = kChunk; w < s; w <<= 1) {
        merge_pass(v, src, dst, s, w);
        uint32_t* x = src;
        src = dst;
        dst = x;
      }
      sorted = src;
    }
    const uint32_t k = first_occurrences(v, sorted, perm + lo, s);
    if (tid == 0) sm.kept[b] = k;
  }
  __syncthreads();

  // the tile's max-plus step, its carry-in from the look-back, and each
  // group's first slot; drops and out-of-reach rows counted
  const int b0 = tid * kGroupsPer;
  MaxPlus f = identity();
  for (int q = 0; q < kGroupsPer && b0 + q < ng; ++q) {
    const long long k = sm.kept[b0 + q];
    if (k) f = then(f, MaxPlus{k, ((g0 + b0 + q) << a.gshift) + k});
  }
  MaxPlus total;
  const MaxPlus ex = block_exclusive(f, &total);
  if (tid < 32) {
    const long long before = look_back(a.chain, t, total);
    if (tid == 0) before_sh = before;
  }
  __syncthreads();
  const long long before = before_sh;
  const long long first_slot = max(before, g0 << a.gshift);  // R_{t-1}
  const long long n_slots = a.total_groups << a.gshift;
  unsigned long long drops = 0;
  long long x = apply(ex, before);
  for (int q = 0; q < kGroupsPer && b0 + q < ng; ++q) {
    const long long home = g0 + b0 + q, k = sm.kept[b0 + q];
    const long long st = max(x, home << a.gshift), end = st + k;
    sm.start[b0 + q] = (uint32_t)(st - first_slot);
    if (!k) continue;
    x = end;
    if (end > n_slots) drops += end - max(st, n_slots);
    if (a.max_iters >= 0) {
      const long long far = max(st, (home + a.max_iters) << a.gshift);
      const long long written = min(end, n_slots);
      if (written > far) drops += written - far;
    }
  }
  const long long after = apply(total, before);
  const long long last =
      t == a.tiles - 1 ? n_slots : min(max(after, (g0 + ng) << a.gshift), n_slots);  // R_t

  // every slot of [R_{t-1}, R_t) once, in order, kCap slots at a time
  const uint32_t G = a.G;
  for (long long w0 = first_slot; w0 < last; w0 += kCap) {
    const long long W = min((long long)kCap, last - w0);
    for (int s = tid; s < W; s += kBlock) sm.tmp[s] = kNone;
    __syncthreads();
    for (int q = 0; q < kGroupsPer && b0 + q < ng; ++q) {
      const int b = b0 + q;
      if (sm.off[b + 1] - sm.off[b] > kSmall) continue;
      const long long st = first_slot + sm.start[b];
      const long long j0 = max(0ll, w0 - st), j1 = min((long long)sm.kept[b], w0 + W - st);
      for (long long j = j0; j < j1; ++j) sm.tmp[st + j - w0] = perm[sm.off[b] + j];
    }
    for (int e = 0; e < n_large; ++e) {
      const int b = large[e];
      const long long st = first_slot + sm.start[b];
      const long long j0 = max(0ll, w0 - st), j1 = min((long long)sm.kept[b], w0 + W - st);
      for (long long j = j0 + tid; j < j1; j += kBlock) sm.tmp[st + j - w0] = perm[sm.off[b] + j];
    }
    __syncthreads();
    for (int s = tid; s < W; s += kBlock) {
      const long long slot = w0 + s;
      const long long at = ((slot >> a.gshift) << (a.gshift + 1)) + (slot & (G - 1));
      const uint32_t r = sm.tmp[s];
      if (r == kNone) {
        a.keys[at] = kNone;
        a.keys[at + G] = kNone;
        a.vals[at] = 0u;
        a.vals[at + G] = 0u;
      } else {
        a.keys[at] = v.word(r, 0);
        a.keys[at + G] = v.word(r, 1);
        a.vals[at] = v.word(r, 2);
        a.vals[at + G] = v.word(r, 3);
      }
    }
    __syncthreads();
  }

  if (a.bloom != nullptr) {
    for (int b = tid; b < ng; b += kBlock) a.bloom[g0 + b] = sm.bloom[b];
    if (t == a.tiles - 1)
      for (long long g = g0 + ng + tid; g < a.total_groups; g += kBlock) a.bloom[g] = 0ull;
  }
  const unsigned long long dropped = fhj::block_sum(drops);
  if (tid == 0) {
    if (dropped) atomicAdd(a.special + 3, dropped);
    if (t == 0 && *a.max_row != 0u) {
      const uint32_t r = ~*a.max_row;
      a.special[0] = 1;
      a.special[1] = __ldg(a.vh0 + r);
      a.special[2] = __ldg(a.vl0 + r);
    }
  }
}

// ---- the plan and the scratch ----------------------------------------------------

struct Plan {
  int levels, bits[2], blocks[2];
  int64_t entries[2];  // counts a level: parents x digits x blocks
  int64_t parts[2];    // partitions after a level
  int64_t scan_tiles[2];
  int64_t tiles;       // the finish's
  int64_t rec_words;   // words of a level's records, with the bulk copy's slack
  int64_t n;
};

Plan make_plan(int64_t n_valid, int levels, int bits0, int bits1, int blocks0, int blocks1) {
  Plan p{levels, {bits0, bits1}, {blocks0, blocks1}, {0, 0}, {0, 0}, {0, 0}, 0, 0};
  int64_t parents = 1;
  for (int l = 0; l < levels; ++l) {
    p.entries[l] = parents * (1ll << p.bits[l]) * p.blocks[l];
    p.parts[l] = parents << p.bits[l];
    p.scan_tiles[l] = (p.entries[l] + kScanTile - 1) / kScanTile;
    parents = p.parts[l];
  }
  p.tiles = parents;
  p.rec_words = kWords * n_valid + 8;  // a bulk copy reads up to 3 words past a tile
  p.n = n_valid;
  return p;
}

// The scratch, in order: the counters and the chains' words (zeroed at each
// call), the counts and partition starts of each level,
// then the two buffers of records (the second, with one level, only an
// oversize tile's order and merge buffer: 2 words a row).
struct Scratch {
  unsigned* tickets;  // [scan 0, scan 1, finish, max_row]
  Chain chain[3];     // scan 0, scan 1, finish
  size_t zeroed;
  uint32_t* hist[2];
  uint32_t* part_start[2];
  uint32_t* buf[2];
  size_t bytes;
};

Scratch layout(const Plan& p, char* base) {
  Scratch s{};
  size_t at = 0;
  auto take = [&](size_t n) {
    char* x = base ? base + at : nullptr;
    at += align16(n);
    return x;
  };
  const int64_t tiles[3] = {p.scan_tiles[0], p.scan_tiles[1], p.tiles};
  s.tickets = reinterpret_cast<unsigned*>(take(16));
  for (int c = 0; c < 3; ++c) {
    s.chain[c].ticket = s.tickets ? s.tickets + c : nullptr;
    s.chain[c].a = reinterpret_cast<unsigned long long*>(take(tiles[c] * 8));
    s.chain[c].c = reinterpret_cast<unsigned long long*>(take(tiles[c] * 8));
    s.chain[c].value = reinterpret_cast<unsigned long long*>(take(tiles[c] * 8));
  }
  s.zeroed = at;
  for (int l = 0; l < p.levels; ++l) {
    s.hist[l] = reinterpret_cast<uint32_t*>(take(p.entries[l] * 4));
    s.part_start[l] = reinterpret_cast<uint32_t*>(take((p.parts[l] + 1) * 4));
  }
  s.buf[0] = reinterpret_cast<uint32_t*>(take((size_t)p.rec_words * 4));
  s.buf[1] = reinterpret_cast<uint32_t*>(
      take((size_t)(p.levels == 2 ? p.rec_words : 2 * p.n) * 4));
  s.bytes = at;
  return s;
}

bool plan_ok(int64_t n_valid, int gbits, int levels, int bits0, int bits1, int blocks0,
             int blocks1) {
  const int b1 = levels == 2 ? bits1 : 0;
  return (levels == 1 || levels == 2) && bits0 >= 0 && bits0 <= kMaxLevelBits && b1 >= 0 &&
         b1 <= kMaxLevelBits && bits0 + b1 <= gbits && gbits - bits0 - b1 <= kMaxTileBits &&
         blocks0 >= 1 && (levels == 1 || blocks1 >= 1) && n_valid >= 0;
}

}  // namespace

extern "C" {

// Bytes of device scratch fhj_global_build needs for this plan (0 when the
// plan is not one it takes).
int64_t fhj_global_build_scratch_bytes(int64_t n_valid, int gbits, int levels, int bits0,
                                       int bits1, int blocks0, int blocks1) {
  if (!plan_ok(n_valid, gbits, levels, bits0, bits1, blocks0, blocks1)) return 0;
  return (int64_t)layout(make_plan(n_valid, levels, bits0, bits1, blocks0, blocks1), nullptr)
      .bytes;
}

// The global tier's table from the build planes (kh, kl, vh, vl)[0,
// n_valid): keys and vals (total_groups, 2G) u32 planes, bloom
// (bloom_words,) u64 words (total_groups with bloom, 1 without), special
// (4,) int64: [has_max, max_vh, max_vl, n_dropped].  max_iters < 0: no
// probe bound.  The plan: `levels` (1 or 2) partition levels of bits0 and
// bits1 digit bits with blocks0 and blocks1 blocks a parent partition;
// tiles of 2^(gbits - bits) groups, at most 2^kMaxTileBits.  scratch:
// fhj_global_build_scratch_bytes bytes.  On `stream`, no sync; returns
// cudaGetLastError().
int fhj_global_build(const uint32_t* kh, const uint32_t* kl, const uint32_t* vh,
                     const uint32_t* vl, int64_t n_valid, int gbits, int group_size,
                     int64_t total_groups, int pre_shift, int bloom_k, int max_iters,
                     uint32_t* keys, uint32_t* vals, unsigned long long* bloom,
                     int64_t bloom_words, int with_bloom, unsigned long long* special,
                     void* scratch, int64_t scratch_size, int levels, int bits0, int bits1,
                     int blocks0, int blocks1, cudaStream_t stream) {
  const int64_t groups = 1ll << (gbits < 0 ? 0 : gbits);
  if (gbits < 0 || gbits > 30 || pre_shift < 0 || pre_shift > 32 || group_size < 1 ||
      group_size > 32 || (group_size & (group_size - 1)) || total_groups < groups ||
      n_valid < 0 || n_valid > 0x7fffffff || bloom_words < 1 ||
      (with_bloom && bloom_words != total_groups) ||
      !plan_ok(n_valid, gbits, levels, bits0, bits1, blocks0, blocks1))
    return (int)cudaErrorInvalidValue;
  if (levels == 1) bits1 = 0, blocks1 = 1;
  const Plan p = make_plan(n_valid, levels, bits0, bits1, blocks0, blocks1);
  const Scratch s = layout(p, static_cast<char*>(scratch));
  if (scratch_size < (int64_t)s.bytes) return (int)cudaErrorInvalidValue;
  int gshift = 0;
  while ((1 << gshift) < group_size) ++gshift;
  const size_t words = (size_t)total_groups * 2 * group_size;

  cudaError_t e = cudaMemsetAsync(special, 0, 4 * sizeof(*special), stream);
  if (e == cudaSuccess && !with_bloom) e = cudaMemsetAsync(bloom, 0, sizeof(*bloom), stream);
  if (e != cudaSuccess) return (int)e;
  if (n_valid == 0) {  // the empty table: memsets, no kernel
    if ((e = cudaMemsetAsync(keys, 0xFF, words * 4, stream)) != cudaSuccess) return (int)e;
    if (with_bloom && (e = cudaMemsetAsync(bloom, 0, bloom_words * 8, stream)) != cudaSuccess)
      return (int)e;
    return (int)cudaMemsetAsync(vals, 0, words * 4, stream);
  }
  if ((e = cudaMemsetAsync(scratch, 0, s.zeroed, stream)) != cudaSuccess) return (int)e;

  Level L{};
  L.kh = kh, L.kl = kl, L.vh = vh, L.vl = vl, L.rec = nullptr, L.parent_start = nullptr;
  L.n_valid = n_valid, L.gbits = gbits, L.pre_shift = pre_shift, L.max_row = s.tickets + 3;
  int consumed = 0;
  for (int l = 0; l < p.levels; ++l) {
    uint32_t* const out = s.buf[l];
    L.parents = l ? (int)p.parts[0] : 1;
    L.blocks = p.blocks[l];
    L.bits = p.bits[l];
    consumed += p.bits[l];
    L.shift = gbits - consumed;
    L.hist = s.hist[l];
    L.out = out;
    const int grid = L.parents * L.blocks;
    const size_t hist_smem = (size_t)4 << L.bits, scatter_bytes = scatter_smem<BuildRecords>(L.bits);
    const Scan sc{s.hist[l], p.entries[l], p.blocks[l], s.part_start[l],
                  s.chain[l]};
    void (*const hist)(Level) =
        l ? hist_kernel<BuildRecords, false> : hist_kernel<BuildRecords, true>;
    void (*const scatter)(Level) =
        l ? scatter_kernel<BuildRecords, false> : scatter_kernel<BuildRecords, true>;
    hist<<<grid, kBlock, hist_smem, stream>>>(L);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    scan_kernel<<<(int)p.scan_tiles[l], kBlock, 0, stream>>>(sc);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    cudaFuncSetAttribute(scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)scatter_bytes);
    scatter<<<grid, kBlock, scatter_bytes, stream>>>(L);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // the next level reads this one's buffer, partitions and rows
    L.rec = out;
    L.parent_start = s.part_start[l];
  }

  Finish f{};
  const int last = p.levels - 1;
  f.data = s.buf[last];
  f.order = s.buf[1 - last];
  f.merge = s.buf[1 - last] + p.n;
  f.tile_start = s.part_start[last];
  f.tiles = p.tiles;
  f.tile_bits = gbits - consumed;
  f.gbits = gbits, f.pre_shift = pre_shift, f.G = group_size, f.gshift = gshift;
  f.bloom_k = bloom_k, f.max_iters = max_iters, f.total_groups = total_groups;
  f.keys = keys, f.vals = vals, f.bloom = with_bloom ? bloom : nullptr, f.special = special;
  f.vh0 = vh, f.vl0 = vl, f.max_row = s.tickets + 3;
  f.chain = s.chain[2];
  cudaFuncSetAttribute(finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)sizeof(FinishSmem));
  finish_kernel<<<(unsigned)p.tiles, kBlock, sizeof(FinishSmem), stream>>>(f);
  return (int)cudaGetLastError();
}

}  // extern "C"
