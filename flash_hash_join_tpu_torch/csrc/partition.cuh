// The partition that the `global` tier's build (hash_build.cu) and walk
// (hash_walk.cu) and the partitioned tier's sliced probe (range_probe.cu)
// share: rows carried as fixed-size records and moved to the partition of
// the next bits of their digit, one level at a time, each level three
// launches:
//   hist_kernel    a block a slice of a parent partition: the rows' digits
//                  counted in shared memory, one count a digit written out;
//                  level 0 reads the input planes and skips the rows its
//                  records leave out;
//   scan_kernel    the exclusive sums of the counts (parent, digit, block),
//                  a single pass with a decoupled look-back: each block's
//                  offset a digit, and each child partition's start;
//   scatter_kernel the slice again, a chunk of rows at a time: ranked a
//                  digit by a shared atomic, staged in shared memory by
//                  digit, then written out a word a thread, each digit's
//                  run of records at its cursor, so the stores are whole
//                  runs, not 4-byte scatters.
// The order inside a partition is the atomics' and does not matter to any
// caller.  A record type names its digit (R::Digit, made once a block):
//   BuildRecords  20 bytes (kh, kl, vh, vl, row) from the four build
//                 planes; level 0 also notes the first u64-max row;
//   ProbeRecords  8 bytes (kh, kl) from the two probe planes; level 0 may
//                 also write, chunk by chunk, where each row's record went
//                 (spos and srow in the chunk's stage order), so that the
//                 walk's answers can be put back in row order in runs.
// Both take the next bits of the home group (HomeDigit) and leave u64-max
// rows out; range_probe.cu's RangeRecords have ProbeRecords' layout
// (ProbeLayout) by the top bits of the range table's directory bucket.  A
// pass of probe records (PassScratch, partition_pass) is one level-0
// partition into a bounded scratch, and restore_rows the body that puts a
// pass's answers back in row order.  The max-plus scan and its decoupled look-back serve the build's
// finish too.  Everything is in an unnamed namespace: each source that
// includes this header gets its own copy of the kernels.
#pragma once

#include "common.cuh"
#include "hash.cuh"

namespace {

constexpr int kBlock = fhj::kThreads;       // threads a block, every kernel
constexpr int kHistPer = 4;                  // rows a thread a step, hist_kernel
constexpr int kScanPer = 16;                 // counts a thread, scan_kernel
constexpr int kScanTile = kBlock * kScanPer;
constexpr int kMaxLevelBits = 11;            // digits a level: at most 2048
constexpr uint32_t kNone = 0xFFFFFFFFu;  // no row, no position
constexpr unsigned kFull = 0xffffffffu;

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
  return {__shfl_up_sync(kFull, f.a, o), __shfl_up_sync(kFull, f.c, o)};
}

__device__ __forceinline__ MaxPlus shfl_down(MaxPlus f, int o) {
  return {__shfl_down_sync(kFull, f.a, o), __shfl_down_sync(kFull, f.c, o)};
}

// Exclusive scan of f over the block (kBlock threads, in thread order);
// *total gets the whole block's composition.  Every thread calls it.
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

// The exclusive sums of c[0, n) into out[0, n) (out may be c), n at most
// kBlock * 8, by the block; returns the total.  Every thread calls it.
__device__ long long block_scan_counts(const uint32_t* c, uint32_t* out, int n) {
  const int per = (n + kBlock - 1) / kBlock;
  const int b0 = threadIdx.x * per;
  long long s = 0;
  for (int q = 0; q < per && b0 + q < n; ++q) s += c[b0 + q];
  MaxPlus total;
  long long x = block_exclusive({s, kNeg}, &total).a;
  for (int q = 0; q < per && b0 + q < n; ++q) {
    const uint32_t v = c[b0 + q];
    out[b0 + q] = (uint32_t)x;
    x += v;
  }
  return total.a;
}

__device__ __forceinline__ bool is_max(uint32_t h, uint32_t l) {
  return (h & l) == 0xFFFFFFFFu;
}

// ---- the decoupled look-back -------------------------------------------------

// One chain of tiles: three 64-bit words a tile, zero at launch, each
// written once and whole, so a reader needs no fence between a flag and its
// data: the tile's step (a, then c + 1, or 0 for c = kNeg) with kStep in the
// top bits, then the value after the tile with kValue.
struct Chain {
  unsigned long long* a;
  unsigned long long* c;
  unsigned long long* value;
  unsigned* ticket;   // the tile counter
};
constexpr unsigned long long kStep = 1ull << 62, kValue = 2ull << 62, kLow = kStep - 1;

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Called by warp 0 of the block once tile t's step `own` is known:
// publishes it and returns the value before the tile (the steps of tiles
// 0 .. t-1 applied to 0, in order), then publishes the value after it.
// Lane k reads tile end - 1 - k, all three words at once; it waits only
// for the tiles up to the nearest published value, whose later tiles'
// steps are composed earliest first (the higher lane first).
__device__ long long look_back(const Chain& ch, long long t, MaxPlus own) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) store_word(ch.value, kValue | (unsigned long long)apply(own, 0));
    return 0;
  }
  if (lane == 0) {
    store_word(ch.a + t, kStep | (unsigned long long)own.a);
    store_word(ch.c + t, kStep | (own.c < 0 ? 0ull : (unsigned long long)own.c + 1));
  }
  MaxPlus acc = identity();  // the tiles between the value found and t
  long long x = 0;
  for (long long end = t;; end -= 32) {
    const long long j = end - 1 - lane;
    unsigned long long wa, wc, wv;
    unsigned value;
    int stop;
    for (;;) {
      wv = kValue, wa = wc = 0;  // before tile 0: a value of 0
      if (j >= 0) {
        wv = load_word(ch.value + j);
        wa = load_word(ch.a + j);
        wc = load_word(ch.c + j);
      }
      const bool has_value = (wv >> 62) == 2, has_step = (wa >> 62) == 1 && (wc >> 62) == 1;
      value = __ballot_sync(kFull, has_value);
      stop = value ? __ffs(value) - 1 : 31;
      if (!(__ballot_sync(kFull, !has_value && !has_step) & ((2u << stop) - 1u))) break;
    }
    if (!value) stop = 32;
    MaxPlus v = identity();
    if (lane < stop) v = MaxPlus{(long long)(wa & kLow), (wc & kLow) ? (long long)(wc & kLow) - 1 : kNeg};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const MaxPlus y = shfl_down(v, o);
      if (lane + o < 32) v = then(y, v);
    }
    acc = then(MaxPlus{__shfl_sync(kFull, v.a, 0), __shfl_sync(kFull, v.c, 0)}, acc);
    if (value) {
      x = __shfl_sync(kFull, (long long)(wv & kLow), stop);
      break;
    }
  }
  const long long before = apply(acc, x);
  if (lane == 0) store_word(ch.value + t, kValue | (unsigned long long)apply(own, before));
  return before;
}

// ---- the partition levels ------------------------------------------------------

struct Level {
  const uint32_t* kh;   // level 0: the input planes (the row is the index)
  const uint32_t* kl;
  const uint32_t* vh;   // BuildRecords only
  const uint32_t* vl;
  const uint32_t* rec;  // a later level: the level before's rows, kWords each
  const uint32_t* parent_start;  // (parents + 1,); level 0: null, [0, n_valid)
  int64_t n_valid;
  int parents, blocks;  // blocks a parent
  int bits, shift;      // the digit's bits, and the bits below it: HomeDigit's
                        // of the home group, RangeDigit's of the bucket
  int gbits, pre_shift;
  uint32_t* hist;       // (parents * 2^bits * blocks,): counts, then offsets
  uint32_t* out;        // the rows by partition, kWords each
  unsigned* max_row;    // BuildRecords: ~(the first u64-max row), 0 for none
  // ProbeRecords, level 0, or null: for each chunk of rows from row r0, in
  // stage order, the record position of stage slot s at spos[r0 + s] (kNone
  // past the chunk's records) and the slot's row, less r0, at srow[r0 + s]
  uint32_t* spos;
  uint16_t* srow;
  // RangeRecords: the range table's nkeys sorted keys and its directory's
  // shift, on the card
  const long long* keys;
  int64_t nkeys;
  const int64_t* key_shift;
};

// The digit of the hash table's records, made once a block: the next bits
// of the home group; level 0 gives a u64-max row no record.
struct HomeDigit {
  int bits, shift, gbits, pre_shift;
  __device__ explicit HomeDigit(const Level& L)
      : bits(L.bits), shift(L.shift), gbits(L.gbits), pre_shift(L.pre_shift) {}
  __device__ __forceinline__ bool takes(uint32_t h, uint32_t l) const { return !is_max(h, l); }
  __device__ __forceinline__ uint32_t operator()(uint32_t h, uint32_t l) const {
    const int64_t home = fhj::home_group(fhj::hash_u64(h, l), gbits, pre_shift);
    return (uint32_t)(home >> shift) & ((1u << bits) - 1u);
  }
};

// What a level carries a row as, what level 0 does beside, and the digit.
struct BuildRecords {
  static constexpr int kWords = 5;         // kh, kl, vh, vl, row
  static constexpr int kChunkPer = 8;      // rows a thread a step, scatter_kernel
  static constexpr bool kMaxRow = true;    // level 0 notes the first u64-max row
  static constexpr bool kStageMaps = false;
  using Digit = HomeDigit;
};
// The probe records' layout, which the walk's ProbeRecords and the range
// probe's RangeRecords share; each names its own digit, and the kernels'
// names carry the record type's, so each tier's launches keep their names.
struct ProbeLayout {
  static constexpr int kWords = 2;         // kh, kl
  static constexpr int kChunkPer = 16;
  static constexpr bool kMaxRow = false;
  static constexpr bool kStageMaps = true;  // level 0 writes spos / srow when given
};
struct ProbeRecords : ProbeLayout {
  using Digit = HomeDigit;
};
constexpr int kProbeChunkRows = kBlock * ProbeLayout::kChunkPer;  // a probe scatter chunk's rows

// Block (p, s)'s rows: the s-th of `blocks` even slices of parent p.
__device__ __forceinline__ void block_rows(const Level& L, int* p, int* s, int64_t* lo,
                                           int64_t* hi) {
  *p = blockIdx.x / L.blocks;
  *s = blockIdx.x % L.blocks;
  const int64_t a = L.parent_start ? L.parent_start[*p] : 0;
  const int64_t b = L.parent_start ? L.parent_start[*p + 1] : L.n_valid;
  *lo = a + (b - a) * *s / L.blocks;
  *hi = a + (b - a) * (*s + 1) / L.blocks;
}

// Level 0 reads the input planes (a row the digit does not take is not
// partitioned), a later level the buffer of the level before.
template <class R, bool kFirst>
__global__ void __launch_bounds__(kBlock) hist_kernel(const Level L) {
  constexpr int W = R::kWords;
  extern __shared__ uint32_t cnt[];  // a count a digit
  const int D = 1 << L.bits;
  const typename R::Digit digit(L);
  for (int d = threadIdx.x; d < D; d += kBlock) cnt[d] = 0;
  __syncthreads();
  int p, s;
  int64_t lo, hi;
  block_rows(L, &p, &s, &lo, &hi);
  uint32_t first_max = kNone;
  for (int64_t base = lo; base < hi; base += kBlock * kHistPer) {
    uint32_t h[kHistPer], l[kHistPer];
#pragma unroll
    for (int k = 0; k < kHistPer; ++k) {
      const int64_t i = base + k * kBlock + threadIdx.x;
      h[k] = i >= hi ? 0u : kFirst ? __ldg(L.kh + i) : __ldg(L.rec + W * i);
      l[k] = i >= hi ? 0u : kFirst ? __ldg(L.kl + i) : __ldg(L.rec + W * i + 1);
    }
#pragma unroll
    for (int k = 0; k < kHistPer; ++k) {
      const int64_t i = base + k * kBlock + threadIdx.x;
      bool on = i < hi;
      if (kFirst && on && !digit.takes(h[k], l[k])) {
        if (R::kMaxRow) first_max = min(first_max, (uint32_t)i);
        on = false;
      }
      if (on) atomicAdd(cnt + digit(h[k], l[k]), 1u);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kBlock)
    L.hist[((int64_t)p * D + d) * L.blocks + s] = cnt[d];
  if (kFirst && R::kMaxRow) {
    const uint32_t m = fhj::block_min(first_max);
    if (threadIdx.x == 0 && m != kNone) atomicMax(L.max_row, ~m);
  }
}

struct Scan {
  uint32_t* v;           // (n,): counts, replaced by their exclusive sums
  int64_t n;
  int every;             // the sum at each multiple of `every` starts a partition
  uint32_t* part_start;  // (n / every + 1,)
  Chain chain;
};

// A block a tile of kScanTile counts, in ticket order.
__global__ void __launch_bounds__(kBlock) scan_kernel(const Scan a) {
  __shared__ long long t_sh, before_sh;
  if (threadIdx.x == 0) t_sh = atomicAdd(a.chain.ticket, 1u);
  __syncthreads();
  const long long t = t_sh;
  const int64_t i0 = t * kScanTile + (int64_t)threadIdx.x * kScanPer;
  uint32_t x[kScanPer];
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    x[k] = i0 + k < a.n ? a.v[i0 + k] : 0u;
    sum += x[k];
  }
  MaxPlus total;
  const long long ex = block_exclusive({sum, kNeg}, &total).a;
  if (threadIdx.x < 32) {
    const long long before = look_back(a.chain, t, total);
    if (threadIdx.x == 0) before_sh = before;
  }
  __syncthreads();
  long long run = before_sh + ex;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    const int64_t i = i0 + k;
    if (i < a.n) {
      a.v[i] = (uint32_t)run;
      if (i % a.every == 0) a.part_start[i / a.every] = (uint32_t)run;
      run += x[k];
      if (i == a.n - 1) a.part_start[a.n / a.every] = (uint32_t)run;
    }
  }
}

// Block (p, s) writes its rows to their partitions, a chunk of kBlock *
// kChunkPer rows at a time:
// each row ranked within its digit by a shared atomic, staged in shared
// memory in digit order as kWords-word records, then written out a word a
// thread: each digit's run of records lands at its cursor, so the stores
// are whole runs, not 4-byte scatters.  The order inside a partition is the
// atomics' and does not matter: the build's finish orders each tile by
// (home, key, row), and the probes' answers do not depend on the order.
template <class R, bool kFirst>
__global__ void __launch_bounds__(kBlock) scatter_kernel(const Level L) {
  constexpr int W = R::kWords, kChunkPer = R::kChunkPer, kChunkRows = kBlock * kChunkPer;
  extern __shared__ uint32_t sm[];
  const int D = 1 << L.bits;
  const typename R::Digit digit(L);
  uint32_t* cnt = sm;
  uint32_t* lstart = cnt + D;
  uint32_t* cursor = lstart + D;
  uint32_t* stage = cursor + D;  // kChunkRows records
  uint16_t* sdig = reinterpret_cast<uint16_t*>(stage + W * kChunkRows);
  uint16_t* srow = sdig + kChunkRows;  // R::kStageMaps: each stage slot's row in the chunk
  int p, s;
  int64_t lo, hi;
  block_rows(L, &p, &s, &lo, &hi);
  for (int d = threadIdx.x; d < D; d += kBlock) {
    cnt[d] = 0;
    cursor[d] = L.hist[((int64_t)p * D + d) * L.blocks + s];
  }
  __syncthreads();
  for (int64_t base = lo; base < hi; base += kChunkRows) {
    uint32_t w[kChunkPer][W], dig[kChunkPer], rank[kChunkPer];
    bool on[kChunkPer];
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      const int64_t i = base + k * kBlock + threadIdx.x;
      on[k] = i < hi;
      if (kFirst) {
        w[k][0] = on[k] ? __ldg(L.kh + i) : 0u;
        w[k][1] = on[k] ? __ldg(L.kl + i) : 0u;
        if constexpr (W == 5) {
          w[k][2] = on[k] ? __ldg(L.vh + i) : 0u;
          w[k][3] = on[k] ? __ldg(L.vl + i) : 0u;
          w[k][4] = (uint32_t)i;
        }
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) w[k][q] = on[k] ? __ldg(L.rec + W * i + q) : 0u;
      }
    }
    bool placed[kChunkPer];
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k) {
      placed[k] = on[k] && (!kFirst || digit.takes(w[k][0], w[k][1]));
      dig[k] = placed[k] ? digit(w[k][0], w[k][1]) : 0u;
      rank[k] = placed[k] ? atomicAdd(cnt + dig[k], 1u) : 0u;
    }
    __syncthreads();
    const int n_here = (int)block_scan_counts(cnt, lstart, D);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunkPer; ++k)
      if (placed[k]) {
        const uint32_t at = lstart[dig[k]] + rank[k];
#pragma unroll
        for (int q = 0; q < W; ++q) stage[W * at + q] = w[k][q];
        sdig[at] = (uint16_t)dig[k];
        if constexpr (R::kStageMaps) srow[at] = (uint16_t)(k * kBlock + threadIdx.x);
      }
    __syncthreads();
    for (int i = threadIdx.x; i < W * n_here; i += kBlock) {
      const uint32_t d = sdig[i / W];
      L.out[W * ((int64_t)cursor[d] - lstart[d]) + i] = stage[i];
    }
    if constexpr (R::kStageMaps && kFirst) {
      if (L.spos != nullptr) {   // the chunk's stage slots, in order
        const int rows = hi - base < kChunkRows ? (int)(hi - base) : kChunkRows;
        for (int i = threadIdx.x; i < rows; i += kBlock) {
          const uint32_t d = i < n_here ? sdig[i] : 0u;
          L.spos[base + i] = i < n_here ? cursor[d] - lstart[d] + i : kNone;
          L.srow[base + i] = i < n_here ? srow[i] : 0;
        }
      }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kBlock) {
      cursor[d] += cnt[d];
      cnt[d] = 0;
    }
    __syncthreads();
  }
}

// scatter_kernel's dynamic shared memory at `bits` digit bits.
template <class R>
size_t scatter_smem(int bits) {
  constexpr size_t kChunkRows = (size_t)kBlock * R::kChunkPer;
  return (size_t)3 * 4 * (1 << bits) + R::kWords * 4 * kChunkRows +
         (R::kStageMaps ? 4 : 2) * kChunkRows;
}

// ---- a pass of probe records: its scratch and its partition ----------------------

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// A pass's scratch (the walk's, hash_walk.cu, and the range probe's), in
// order: the tickets (the scan's, the consumer's) and the scan's look-back
// words, zeroed each pass, the counts and the partition starts, the
// records, then with `maps` the chunks' stage maps and a hit flag a record.
struct PassScratch {
  unsigned* tickets;
  Chain chain;
  size_t zeroed;
  uint32_t* hist;
  uint32_t* part_start;
  uint2* rec;
  uint32_t* spos;
  uint16_t* srow;
  uint8_t* rhit;
  size_t bytes;
};

PassScratch pass_layout(char* base, int64_t pass_rows, int pbits, int blocks, bool maps) {
  PassScratch s{};
  size_t at = 0;
  auto take = [&](size_t n) {
    char* x = base ? base + at : nullptr;
    at += align16(n);
    return x;
  };
  const int64_t entries = (1ll << pbits) * blocks;
  const int64_t tiles = (entries + kScanTile - 1) / kScanTile;
  s.tickets = reinterpret_cast<unsigned*>(take(16));
  s.chain.ticket = s.tickets;
  s.chain.a = reinterpret_cast<unsigned long long*>(take(tiles * 8));
  s.chain.c = reinterpret_cast<unsigned long long*>(take(tiles * 8));
  s.chain.value = reinterpret_cast<unsigned long long*>(take(tiles * 8));
  s.zeroed = at;
  s.hist = reinterpret_cast<uint32_t*>(take(entries * 4));
  s.part_start = reinterpret_cast<uint32_t*>(take(((1ll << pbits) + 1) * 4));
  s.rec = reinterpret_cast<uint2*>(take(pass_rows * 8));
  if (maps) {
    s.spos = reinterpret_cast<uint32_t*>(take(pass_rows * 4));
    s.srow = reinterpret_cast<uint16_t*>(take(pass_rows * 2));
    s.rhit = reinterpret_cast<uint8_t*>(take(pass_rows));
  }
  s.bytes = at;
  return s;
}

// A pass's answers put back in row order, chunk by chunk as the scatter took
// them (a block its rows [lo, hi), chunks of kProbeChunkRows): each chunk's
// stage slots read in order (spos, srow), so that the records' answers come
// in runs, placed in shared memory by row, then written out in order.  A row
// with no record gets the walk's u64-max answer (special: its count, vh, vl)
// where kSpecial, else (0, 0, 0) (the range probe's probes outside the keys;
// special unread).
struct Restore {
  const uint32_t* spos;
  const uint16_t* srow;
  const uint2* rec;
  const uint8_t* rhit;
  const int64_t* special;
  int64_t rows;
  int blocks;
  bool* hit;
  uint32_t* vh;
  uint32_t* vl;
};
constexpr size_t kRestoreSmem = (size_t)9 * kProbeChunkRows;  // answers, then hit flags

// The body of each tier's restore kernel (hash_walk.cu's restore_kernel,
// range_probe.cu's range_unsort_kernel), given its kRestoreSmem bytes of
// dynamic shared memory.
template <bool kSpecial>
__device__ __forceinline__ void restore_rows(const Restore r, uint2* sv) {
  uint8_t* sh = reinterpret_cast<uint8_t*>(sv + kProbeChunkRows);
  const bool has_max = kSpecial && __ldg(r.special) > 0;
  const uint2 fill = has_max ? make_uint2((uint32_t)__ldg(r.special + 1),
                                          (uint32_t)__ldg(r.special + 2))
                             : make_uint2(0u, 0u);
  const int64_t lo = r.rows * blockIdx.x / r.blocks, hi = r.rows * (blockIdx.x + 1) / r.blocks;
  for (int64_t base = lo; base < hi; base += kProbeChunkRows) {
    const int n = hi - base < kProbeChunkRows ? (int)(hi - base) : kProbeChunkRows;
    for (int t = threadIdx.x; t < n; t += kBlock) {
      sv[t] = fill;
      sh[t] = has_max;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kBlock) {
      const uint32_t p = __ldg(r.spos + base + t);
      if (p != kNone) {
        const uint16_t row = __ldg(r.srow + base + t);
        sv[row] = __ldg(r.rec + p);
        sh[row] = __ldg(r.rhit + p);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kBlock) {
      r.hit[base + t] = sh[t];
      r.vh[base + t] = sv[t].x;
      r.vl[base + t] = sv[t].y;
    }
    __syncthreads();
  }
}

// One pass's level 0: L's rows [0, L.n_valid) (or its parent range) to
// s.rec by L.bits digit bits over L.blocks blocks, with the stage maps where
// s has them.  The memset of the tickets and look-back words, hist_kernel,
// scan_kernel, scatter_kernel; the records' end is then s.part_start[2^bits].
template <class R>
cudaError_t partition_pass(Level L, const PassScratch& s, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(s.tickets, 0, s.zeroed, stream);
  if (e != cudaSuccess) return e;
  L.parents = 1, L.hist = s.hist, L.out = reinterpret_cast<uint32_t*>(s.rec);
  L.spos = s.spos, L.srow = s.srow;
  hist_kernel<R, true><<<L.blocks, kBlock, (size_t)4 << L.bits, stream>>>(L);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t entries = ((int64_t)1 << L.bits) * L.blocks;
  const Scan sc{s.hist, entries, L.blocks, s.part_start, s.chain};
  scan_kernel<<<(unsigned)((entries + kScanTile - 1) / kScanTile), kBlock, 0, stream>>>(sc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t smem = scatter_smem<R>(L.bits);
  cudaFuncSetAttribute(scatter_kernel<R, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  scatter_kernel<R, true><<<L.blocks, kBlock, smem, stream>>>(L);
  return cudaGetLastError();
}

}  // namespace
