// The `global` tier's probe: the bounded group walk over the open-addressed
// hash table, count and materialize.
//
// Replaces flash_hash_join_tpu/ops/hash_table.py:212 _probe_chunk_state
// (a jax.lax.while_loop) together with the lax.scan of probe_count (:304)
// and probe_materialize (:350) around it.  That code is plain XLA, not a
// Pallas kernel: on the TPU it is one device program, where the port's
// plain version (ops/hash_table.py) is a host loop that syncs once a walk
// step.  It is the reference's own algorithm, flash join
// (hash_join.cpp:75-204): groups of G slots, all compared at once.
//
// Table (ops/hash_table.py:build_table): keys and vals are (total_groups,
// 2G) u32 planes, group g's row [hi_0 .. hi_{G-1}, lo_0 .. lo_{G-1}];
// empty slots hold the u64-max key; bloom is one u32 word a group (held in
// int64); special = [has_max, max_vh, max_vl, n_dropped] (int64).
//
// Semantics, bit for bit with the plain walk:
//  * h = hash_u64(hi, lo) (ops/hashing.py); the home group is the top gbits
//    of h after discarding its top pre_shift bits (the distributed ranks
//    pass pre_shift != 0).
//  * With bloom, a probe whose tag bloom_word(h, k) is not inside its home
//    group's word never walks.
//  * A u64-max probe never walks: it matches iff special[0] > 0, with the
//    value special[1:3] (empty slots hold u64-max, so a walking max key
//    would find them).  Rows at or past np_valid never hit.
//  * The walk visits at most max_iters groups from home: at each it
//    compares the G (hi, lo) pairs and takes the lowest matching slot j; it
//    stops on a match, on any empty slot of the group, or after the last
//    group (total_groups - 1).  The JAX loop bounds a whole chunk in
//    lockstep (it < max_iters and not all done), but every probe not yet
//    done advances exactly one group a step, so after max_iters steps each
//    has visited at most max_iters groups: a per-probe bound of max_iters
//    visits gives the same result (tests/test_torch_hash_walk.py walks each
//    probe alone in numpy and compares).  No answer depends on the order in
//    which the probes walk, the walk statistics neither.
//
// What bounds it on an H100: device memory, and the order of the reads.
// Each probe reads its 8-byte key and one 64-byte group row (G = 8), a few
// per cent two.  The key plane (2^gbits + 64 groups) is far larger than
// the 50 MB L2 at the main path's shapes (2.15 GB at J1 1e8 Q5, 268 MB at
// config #2), so a walk in probe order fetches nearly every row it reads
// from HBM: each row ~3 times at J1 1e8 Q5 and ~24 times at config #2,
// ~7.2 GB in all at J1 1e8 Q5, where each input byte read once would take
// 0.88 ms.  The bloom word and the materialize's values are random reads
// of their own.
//
// Design: the probes walk slice by slice of the table.  A plan on the host
// (ops/cuda/hash_walk.plan) picks one of two routes by shape:
//   0 levels   walk_kernel, grid-stride over the probe planes: where the
//              planes the walk reads fit in half of L2, or fewer than two
//              probes share a group (the routes cross there, PERF.md).
//              G / 2 lanes walk a probe together (walk_coop, G >= 4), each
//              loading 16 bytes of the row, so that a warp's load touches
//              8 rows, not 32 (J1 1e8 Q5: 3.4 ms against 4.5 a thread a
//              probe);
//   1 level    for each pass of at most pass_rows valid probe rows:
//     hist_kernel, scan_kernel, scatter_kernel (partition.cuh) move the
//              pass's rows, as 8-byte (kh, kl) records, to the partition of
//              the top bits of their home group: a slice of at most 16 MB
//              of the planes the walk reads, at most 2^7 digits (more
//              digits cost the scatter more than the smaller slices save);
//              u64-max rows get no record; for materialize the scatter
//              also writes, chunk by chunk, each stage slot's record
//              position and row (spos, srow);
//     slice_walk_kernel  persistent blocks take chunks of records, in
//              order, from a ticket counter, so that the blocks in flight
//              work inside one or two slices: each slice's rows come from
//              HBM once and then from L2.  Two probes a thread, their home
//              rows loaded before any compare.  The count is reduced a
//              block (the pass's u64-max rows add has_max: its rows less
//              its records); materialize overwrites each record with its
//              (vh, vl) and writes its hit flag, in record order;
//     restore_kernel  (materialize) a block the scatter's chunks of rows:
//              each chunk's answers read in its stage order (runs of
//              records), placed by row in shared memory, written out in
//              probe order for K5.  Rows at or past np_valid: memsets.
// A chain that runs past its slice reads the next groups from device
// memory, which is right whatever the slice.  The slice walk is not bound
// by HBM: each probe reads its row's two sectors from L2 (1e8 probes: 1.7
// to 1.9 ms, where the bytes it moves from HBM take ~0.4).  A second level
// into tiles of 2^10 groups walked from shared memory ran slower at
// config #2 (3.6-3.9 ms against 2.9-3.1, PERF.md).  The walk adds the
// groups it visited into stats[0], keeps the longest walk in stats[1] and
// adds the probe rows whose bloom test passed into stats[2].
// Scratch: 8 B a row of a pass for the count, 15 B for the materialize,
// and the partition's counts; no host sync.
//
// The bloom prune (count with bloom, 1 level, where the u32 words take at
// most three quarters of L2: ops/cuda/hash_walk.plan).  It takes the place of the JAX
// walk's bloom test inside the walk (ops/hash_table.py:241), which the walk
// kernels still run at 0 levels, for materialize and where the words do
// not fit: gathered from device memory, one word a row costs more than
// the partition it saves (2^24 and 2^25 groups, PERF.md).  Where a selective join's bloom
// rejects most probe rows, partitioning every row before its bloom test
// moves each rejected row's 8 bytes four times (the planes read twice, a
// record written and read) to drop it at the walk.  prune_kernel reads a
// pass's planes once, streaming (evict-first, so that the bloom words
// stay in L2), tests each row's bloom word (narrowed to u32 once a join,
// 16.8 MB at 2^22 groups) and writes the rows that pass, in no order, to a
// survivors' pair of planes, staged a block at a time in shared memory;
// the u64-max rows add has_max into the count there.  The pass's
// partition and slice walk (fhj_global_walk_count with `survivors`) then
// take their rows from the survivors' count on the card (the level's
// parent range), with no bloom test and no u64-max rows: no host sync.
// Bound: not HBM (8 B a probe row, 2.4 ms at 1e9 rows; the planes alone
// stream in 2.6) but the bloom words' gather, one random L2 sector a row:
// at config #3 8.7 ms, ~1.15e11 sectors/s, the rate the slice walk's row
// reads show too; 5.5 with the words held in L1, and no faster with
// another load path or with the rows fetched ahead by cp.async (PERF.md).
// Scratch: 8 B a row of a pass more, and the u32 words.

#include <type_traits>

#include "common.cuh"
#include "hash.cuh"
#include "partition.cuh"

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;

// Group row of 2G words: G / 2 16-byte loads (one 8-byte load for G = 1).
template <int G>
__device__ __forceinline__ void load_group(const uint32_t* __restrict__ row,
                                           uint32_t (&w)[2 * G]) {
  if constexpr (G == 1) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(row));
    w[0] = q.x;
    w[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < G / 2; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + k);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
  }
}

struct Walk {
  const uint32_t* keys;     // (total_groups, 2G)
  const uint32_t* vals;     // (total_groups, 2G), materialize only
  const int64_t* bloom;     // (total_groups,) u32 words, or null (no bloom)
  const int64_t* special;   // (4,)
  int64_t total_groups;
  int gbits, pre_shift, bloom_k, max_iters;
  unsigned long long* count;  // count: the 0-d result, zeroed by the caller
  unsigned long long* stats;  // [groups visited, longest walk, bloom passes], or null
  // 0 levels: the probe planes and the outputs in probe order
  const uint32_t* ph;
  const uint32_t* pl;
  int64_t n, np_valid;
  bool* hit;                  // materialize: (n,) hit mask and values
  uint32_t* vh;
  uint32_t* vl;
  // 1 level: a pass's records
  uint2* rec;                 // (kh, kl) in slice order; materialize: then (vh, vl)
  uint8_t* rhit;              // materialize: a hit flag a record
  const uint32_t* nrec;       // the pass's records: the partition's end
  int64_t pass_rows;          // the pass's valid rows, u64-max rows included
  unsigned* ticket;
  // a pruned pass: its rows are [survivors[0], survivors[1]) of (ph, pl),
  // on the card; no bloom test and no u64-max rows (the prune counted
  // them); null otherwise
  const uint32_t* survivors;
};

// The walks of P probes (kh, kl): hit, the matching slot's value (kMat)
// and the groups visited each.  The home group rows of all P are loaded
// before any compare; a probe that goes on walks its next groups alone.
template <int G, bool kMat, int P>
__device__ __forceinline__ void walk_probes(const Walk& a, const uint32_t (&kh)[P],
                                            const uint32_t (&kl)[P], const bool (&on)[P],
                                            bool (&hit)[P], uint32_t (&out_h)[P],
                                            uint32_t (&out_l)[P], unsigned (&visited)[P],
                                            unsigned long long& passed) {
  int64_t g[P];
  bool walks[P];
  uint32_t tag[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    hit[k] = false;
    out_h[k] = out_l[k] = 0u;
    visited[k] = 0;
    const uint32_t h = fhj::hash_u64(kh[k], kl[k]);
    g[k] = fhj::home_group(h, a.gbits, a.pre_shift);
    walks[k] = on[k];
    tag[k] = a.bloom != nullptr ? fhj::bloom_word(h, a.bloom_k) : 0u;
  }
  if (a.bloom != nullptr) {
    uint32_t word[P];
#pragma unroll
    for (int k = 0; k < P; ++k) word[k] = walks[k] ? (uint32_t)__ldg(a.bloom + g[k]) : 0u;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      walks[k] = walks[k] && (word[k] & tag[k]) == tag[k];
      passed += walks[k];
    }
  }
#pragma unroll
  for (int k = 0; k < P; ++k) walks[k] = walks[k] && a.max_iters > 0;
  uint32_t w[P][2 * G];
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (walks[k]) load_group<G>(a.keys + g[k] * (2 * G), w[k]);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    for (int it = 0; walks[k] && it < a.max_iters; ++it) {
      const int64_t base = g[k] * (2 * G);
      if (it > 0) load_group<G>(a.keys + base, w[k]);
      ++visited[k];
      int j = -1;
      bool empty = false;
#pragma unroll
      for (int q = G - 1; q >= 0; --q) {    // the lowest matching slot wins
        if (w[k][q] == kh[k] && w[k][G + q] == kl[k]) j = q;
        empty |= (w[k][q] == kEmpty) & (w[k][G + q] == kEmpty);
      }
      if (j >= 0) {
        hit[k] = true;
        if (kMat) {
          out_h[k] = __ldg(a.vals + base + j);
          out_l[k] = __ldg(a.vals + base + G + j);
        }
        break;
      }
      if (empty || g[k] + 1 >= a.total_groups) break;   // absent
      ++g[k];
    }
  }
}

// The walk of each thread's probe (kh, kl) by T = G / 2 threads together
// (G >= 4): thread q of a group of T lanes loads the 16-byte part q of the
// row (parts 0 .. T/2 - 1 the hi words, the rest the lo words), so that a
// warp's load touches 32 / T rows, not 32; the hi and lo halves of a slot
// meet by one shuffle, the slots' bits by log2(T / 2) more.  The group's T
// probes take turns; the first group row of each is loaded before any
// compare.  Every lane of the warp calls it.
template <int G, bool kMat>
__device__ __forceinline__ void walk_coop(const Walk& a, uint32_t kh, uint32_t kl, bool on,
                                          bool& hit, uint32_t& out_h, uint32_t& out_l,
                                          unsigned& visited, unsigned long long& passed) {
  constexpr int T = G / 2, H = T / 2;
  constexpr int kE = G <= 16 ? 16 : 32;   // the slots' match bits, then their empty bits
  using Bits = std::conditional_t<(G <= 16), unsigned, unsigned long long>;
  const int lane = threadIdx.x & 31, q = lane & (T - 1), first = lane & ~(T - 1);
  const unsigned gmask = T == 32 ? 0xffffffffu : ((1u << T) - 1u) << first;
  const uint32_t h = fhj::hash_u64(kh, kl);
  int64_t g = fhj::home_group(h, a.gbits, a.pre_shift);
  bool walks = on;
  if (walks && a.bloom != nullptr) {
    const uint32_t tag = fhj::bloom_word(h, a.bloom_k);
    walks = ((uint32_t)__ldg(a.bloom + g) & tag) == tag;
    passed += walks;
  }
  if (!walks || a.max_iters <= 0) g = -1;
  uint32_t rk[T];
  int64_t rg[T];
  uint4 w0[T];
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const uint32_t rkh = __shfl_sync(gmask, kh, first | r);
    const uint32_t rkl = __shfl_sync(gmask, kl, first | r);
    rk[r] = q < H ? rkh : rkl;                 // this part's half of the key
    rg[r] = __shfl_sync(gmask, g, first | r);
  }
#pragma unroll
  for (int r = 0; r < T; ++r)
    if (rg[r] >= 0) w0[r] = __ldg(reinterpret_cast<const uint4*>(a.keys + rg[r] * (2 * G)) + q);
  hit = false;
  out_h = out_l = 0u;
  visited = 0;
  int64_t at = 0;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    unsigned n = 0;
    int j = -1;
    int64_t gr = rg[r];
    for (int it = 0; gr >= 0 && it < a.max_iters; ++it) {
      const uint4 w = it ? __ldg(reinterpret_cast<const uint4*>(a.keys + gr * (2 * G)) + q) : w0[r];
      const uint32_t k = rk[r];
      unsigned v = (w.x == k) | (w.y == k) << 1 | (w.z == k) << 2 | (w.w == k) << 3 |
                   (w.x == kEmpty) << 4 | (w.y == kEmpty) << 5 | (w.z == kEmpty) << 6 |
                   (w.w == kEmpty) << 7;
      v &= __shfl_xor_sync(gmask, v, H);      // a slot: its hi and its lo word
      const int at4 = 4 * (q & (H - 1));   // the part's first slot
      Bits bits = (Bits)(v & 0xFu) << at4 | (Bits)(v >> 4) << (kE + at4);
#pragma unroll
      for (int o = 1; o < H; o <<= 1) bits |= __shfl_xor_sync(gmask, bits, o);
      ++n;
      const unsigned match = (unsigned)(bits & ((Bits)1 << kE) - 1);
      if (match) {
        j = __ffs(match) - 1;               // the lowest matching slot wins
        break;
      }
      if ((bits >> kE) || gr + 1 >= a.total_groups) break;   // absent
      ++gr;
    }
    if (q == r) {
      visited = n;
      hit = j >= 0;
      at = gr * (2 * G) + j;
    }
  }
  if (kMat && hit) {
    out_h = __ldg(a.vals + at);
    out_l = __ldg(a.vals + at + G);
  }
}

// Adds a block's count and walk statistics (every thread calls it).
__device__ __forceinline__ void finish_block(const Walk& a, bool count, unsigned long long hits,
                                             unsigned long long groups, unsigned int longest,
                                             unsigned long long passed) {
  if (count) {
    const unsigned long long s = fhj::block_sum(hits);
    if (threadIdx.x == 0 && s) atomicAdd(a.count, s);
    __syncthreads();                  // block_sum's shared words are reused below
  }
  if (a.stats != nullptr) {
    const unsigned long long s = fhj::block_sum(groups);
    if (threadIdx.x == 0 && s) atomicAdd(a.stats, s);
    const unsigned int m = __reduce_max_sync(0xffffffffu, longest);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(a.stats + 1, (unsigned long long)m);
    if (a.bloom != nullptr) {
      __syncthreads();
      const unsigned long long b = fhj::block_sum(passed);
      if (threadIdx.x == 0 && b) atomicAdd(a.stats + 2, b);
    }
  }
}

// 0 levels: grid-stride over the probe rows, a thread a row, walked by
// walk_coop (kCoop) or by the thread alone.  The loop runs alike in every
// thread of a block, as walk_coop's shuffles need.
template <int G, bool kMat, bool kCoop>
__global__ void __launch_bounds__(fhj::kThreads) walk_kernel(const Walk a) {
  const bool has_max = __ldg(a.special) > 0;
  const uint32_t max_vh = (uint32_t)__ldg(a.special + 1);
  const uint32_t max_vl = (uint32_t)__ldg(a.special + 2);
  const int64_t rows = kMat ? a.n : a.np_valid;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned long long hits = 0, groups = 0, passed = 0;
  unsigned int longest = 0;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < rows; base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < a.np_valid;
    uint32_t kh[1] = {valid ? __ldg(a.ph + i) : 0u}, kl[1] = {valid ? __ldg(a.pl + i) : 0u};
    const bool max_key = valid && kh[0] == kEmpty && kl[0] == kEmpty;
    bool on[1] = {valid && !max_key}, hit[1];
    uint32_t out_h[1], out_l[1];
    unsigned visited[1];
    if constexpr (kCoop)
      walk_coop<G, kMat>(a, kh[0], kl[0], on[0], hit[0], out_h[0], out_l[0], visited[0], passed);
    else
      walk_probes<G, kMat, 1>(a, kh, kl, on, hit, out_h, out_l, visited, passed);
    if (max_key) {
      hit[0] = has_max;
      out_h[0] = has_max ? max_vh : 0u;
      out_l[0] = has_max ? max_vl : 0u;
    }
    hits += hit[0];
    groups += visited[0];
    longest = visited[0] > longest ? visited[0] : longest;
    if (kMat && i < rows) {
      a.hit[i] = hit[0];
      a.vh[i] = out_h[0];
      a.vl[i] = out_l[0];
    }
  }
  finish_block(a, !kMat, hits, groups, longest, passed);
}

// 1 level: chunks of P * blockDim records (P probes a thread, their first
// group rows loaded before any compare) taken in order from the ticket
// counter, a persistent block taking one after another.
template <int G, bool kMat, int P>
__global__ void __launch_bounds__(fhj::kThreads) slice_walk_kernel(const Walk a) {
  __shared__ unsigned t_sh;
  const int64_t nrec = *a.nrec;
  const int64_t chunk = (int64_t)blockDim.x * P;
  unsigned long long hits = 0, groups = 0, passed = 0;
  unsigned int longest = 0;
  for (;;) {
    if (threadIdx.x == 0) t_sh = atomicAdd(a.ticket, 1u);
    __syncthreads();
    const int64_t base = (int64_t)t_sh * chunk;
    __syncthreads();                  // t_sh is read before the next ticket
    if (base >= nrec) break;
    uint32_t kh[P], kl[P], out_h[P], out_l[P];
    bool on[P], hit[P];
    unsigned visited[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int64_t i = base + k * blockDim.x + threadIdx.x;
      on[k] = i < nrec;
      const uint2 r = on[k] ? a.rec[i] : make_uint2(0u, 0u);
      kh[k] = r.x;
      kl[k] = r.y;
    }
    walk_probes<G, kMat, P>(a, kh, kl, on, hit, out_h, out_l, visited, passed);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int64_t i = base + k * blockDim.x + threadIdx.x;
      hits += hit[k];
      groups += visited[k];
      longest = visited[k] > longest ? visited[k] : longest;
      if (kMat && on[k]) {
        a.rec[i] = make_uint2(out_h[k], out_l[k]);
        a.rhit[i] = hit[k];
      }
    }
  }
  if (!kMat && a.survivors == nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
      __ldg(a.special) > 0)
    hits += a.pass_rows - nrec;       // the pass's u64-max rows
  finish_block(a, !kMat, hits, groups, longest, passed);
}

// The bloom prune of a pass's rows [0, n) of (ph, pl), chunks of
// kPruneChunk rows a block, kPrunePer a thread, every row's two words
// loaded (streaming) before any bloom word.  The rows that pass are staged
// in shared memory (a warp's run from one shared atomic) and flushed to
// (sh, sl) at rows[1], one global atomic a flush, when the stage could not
// take another chunk: at a 5 % match every ~16 chunks, not every chunk
// (8.7 ms against 9.2 at config #3, PERF.md).  The u64-max rows add
// has_max into the count, the rows that pass into stats[2].
struct Prune {
  const uint32_t* ph;
  const uint32_t* pl;
  int64_t n;
  const uint32_t* words;       // the bloom words, narrowed to u32
  const int64_t* special;
  int gbits, pre_shift, bloom_k;
  uint32_t* sh;                // the survivors' planes, n rows at most
  uint32_t* sl;
  uint32_t* rows;              // [0, survivors), zeroed by the launch
  unsigned long long* count;
  unsigned long long* stats;   // or null
};

constexpr int kPrunePer = 8;
constexpr int kPruneChunk = fhj::kThreads * kPrunePer;
constexpr int kStageRows = 2 * kPruneChunk;
constexpr size_t kPruneSmem = (size_t)2 * 4 * kStageRows;   // the stage's hi, then lo words

__global__ void __launch_bounds__(fhj::kThreads) prune_kernel(const Prune a) {
  extern __shared__ uint32_t stage[];
  __shared__ unsigned fill, out_at;
  const unsigned lane = threadIdx.x & 31, below = (1u << lane) - 1u;
  if (threadIdx.x == 0) fill = 0;
  __syncthreads();
  auto flush = [&]() {               // every thread calls it
    const unsigned n = fill;
    if (threadIdx.x == 0 && n) out_at = atomicAdd(a.rows + 1, n);
    __syncthreads();
    for (unsigned j = threadIdx.x; j < n; j += fhj::kThreads) {
      a.sh[out_at + j] = stage[j];
      a.sl[out_at + j] = stage[kStageRows + j];
    }
    __syncthreads();
    if (threadIdx.x == 0) fill = 0;
    __syncthreads();
  };
  unsigned long long maxes = 0, kept = 0;
  for (int64_t base = (int64_t)blockIdx.x * kPruneChunk; base < a.n;
       base += (int64_t)gridDim.x * kPruneChunk) {
    uint32_t h[kPrunePer], l[kPrunePer];
#pragma unroll
    for (int k = 0; k < kPrunePer; ++k) {
      const int64_t i = base + k * fhj::kThreads + threadIdx.x;
      h[k] = i < a.n ? __ldcs(a.ph + i) : 0u;
      l[k] = i < a.n ? __ldcs(a.pl + i) : 0u;
    }
    bool keep[kPrunePer];
    uint32_t tag[kPrunePer], word[kPrunePer];
#pragma unroll
    for (int k = 0; k < kPrunePer; ++k) {
      const bool valid = base + k * fhj::kThreads + threadIdx.x < a.n;
      const bool max_key = is_max(h[k], l[k]);
      maxes += valid && max_key;
      keep[k] = valid && !max_key;
      const uint32_t hk = fhj::hash_u64(h[k], l[k]);
      tag[k] = fhj::bloom_word(hk, a.bloom_k);
      word[k] = keep[k] ? __ldg(a.words + fhj::home_group(hk, a.gbits, a.pre_shift)) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPrunePer; ++k) {
      keep[k] = keep[k] && (word[k] & tag[k]) == tag[k];
      const unsigned m = __ballot_sync(0xffffffffu, keep[k]);
      unsigned at = 0;
      if (lane == 0 && m) at = atomicAdd(&fill, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (keep[k]) {
        const unsigned pos = at + __popc(m & below);
        stage[pos] = h[k];
        stage[kStageRows + pos] = l[k];
      }
      kept += keep[k];
    }
    __syncthreads();
    const bool full = fill > (unsigned)(kStageRows - kPruneChunk);
    __syncthreads();                  // read by all before the next chunk adds to it
    if (full) flush();
  }
  flush();
  const bool has_max = __ldg(a.special) > 0;
  const unsigned long long m = fhj::block_sum(has_max ? maxes : 0ull);
  if (threadIdx.x == 0 && m) atomicAdd(a.count, m);
  if (a.stats != nullptr) {
    __syncthreads();                  // block_sum's shared words are reused
    const unsigned long long s = fhj::block_sum(kept);
    if (threadIdx.x == 0 && s) atomicAdd(a.stats + 2, s);
  }
}

// The table's int64 bloom words narrowed to their u32 values.
__global__ void __launch_bounds__(fhj::kThreads) bloom_words_kernel(const int64_t* in,
                                                                   uint32_t* out, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = (uint32_t)in[i];
}

// Materialize, 1 level: the pass's rows put back in row order
// (partition.cuh's restore_rows); a row with no record (u64-max) keeps
// special's answer.
__global__ void __launch_bounds__(kBlock) restore_kernel(const Restore r) {
  extern __shared__ uint2 sv[];
  restore_rows<true>(r, sv);
}

// ---- the plan's scratch and the launches -------------------------------------------

bool plan_ok(int gbits, int pbits, int64_t pass_rows, int blocks) {
  return pbits >= 0 && pbits <= kMaxLevelBits && pbits <= gbits && pass_rows >= 1 &&
         pass_rows < (1ll << 31) && blocks >= 1;
}

// 0 levels: one launch over the probe planes.
template <int G, bool kMat, bool kCoop>
cudaError_t walk_planes(const Walk& base, cudaStream_t stream) {
  const int64_t rows = kMat ? base.n : base.np_valid;
  if (rows == 0) return cudaSuccess;
  return fhj::launch(walk_kernel<G, kMat, kCoop>, rows, stream, base);
}

// 1 level: the passes, each partitioned, walked and (materialize) restored.
template <int G, bool kMat, int P>
cudaError_t walk_slices(const Walk& base, const PassScratch& s, int pbits, int64_t pass_rows,
                        int blocks, cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
  int walk_grid = 0;
  if ((e = fhj::grid_for(slice_walk_kernel<G, kMat, P>, 1ll << 40, 0, &walk_grid)) != cudaSuccess)
    return e;
  const int D = 1 << pbits;
  for (int64_t p0 = 0; p0 < base.np_valid; p0 += pass_rows) {
    const int64_t len = base.np_valid - p0 < pass_rows ? base.np_valid - p0 : pass_rows;
    const int64_t want = (len + kProbeChunkRows - 1) / kProbeChunkRows;
    const int nb = (int)(want < blocks ? want : blocks);
    Level L{};
    L.kh = base.ph + p0, L.kl = base.pl + p0;
    L.n_valid = len, L.blocks = nb, L.bits = pbits, L.shift = base.gbits - pbits;
    L.gbits = base.gbits, L.pre_shift = base.pre_shift;
    L.parent_start = base.survivors;   // a pruned pass: its rows, counted on the card
    if ((e = partition_pass<ProbeRecords>(L, s, stream)) != cudaSuccess) return e;
    Walk a = base;
    a.rec = s.rec, a.rhit = s.rhit, a.nrec = s.part_start + D, a.pass_rows = len;
    a.ticket = s.tickets + 1;
    const int64_t need = (len + (int64_t)fhj::kThreads * P - 1) / ((int64_t)fhj::kThreads * P);
    slice_walk_kernel<G, kMat, P>
        <<<(unsigned)(need < walk_grid ? need : walk_grid), fhj::kThreads, 0, stream>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if constexpr (kMat) {
      const Restore r{s.spos, s.srow, s.rec, s.rhit, base.special, len, nb,
                      base.hit + p0, base.vh + p0, base.vl + p0};
      restore_kernel<<<nb, kBlock, kRestoreSmem, stream>>>(r);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  if (kMat && base.n > base.np_valid) {  // rows at or past np_valid never hit
    const size_t tail = (size_t)(base.n - base.np_valid);
    if ((e = cudaMemsetAsync(base.hit + base.np_valid, 0, tail, stream)) != cudaSuccess ||
        (e = cudaMemsetAsync(base.vh + base.np_valid, 0, tail * 4, stream)) != cudaSuccess ||
        (e = cudaMemsetAsync(base.vl + base.np_valid, 0, tail * 4, stream)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

// The per-probe code each route runs (measured on an H100, PERF.md: one or
// four probes a thread, and lanes a probe at 1 level, were no faster): at 0
// levels G / 2 lanes a probe (walk_coop) for G >= 4; at 1 level two probes
// a thread up to G = 8, one above.
template <int G, bool kMat>
cudaError_t by_route(const Walk& a, const PassScratch& s, int pbits, int64_t pass_rows, int blocks,
                     cudaStream_t stream) {
  if (pbits == 0) return walk_planes<G, kMat, (G >= 4)>(a, stream);
  return walk_slices<G, kMat, (G <= 8 ? 2 : 1)>(a, s, pbits, pass_rows, blocks, stream);
}

template <bool kMat>
cudaError_t walk(const Walk& a, int group_size, const PassScratch& s, int pbits, int64_t pass_rows,
                 int blocks, cudaStream_t stream) {
  switch (group_size) {
    case 1: return by_route<1, kMat>(a, s, pbits, pass_rows, blocks, stream);
    case 2: return by_route<2, kMat>(a, s, pbits, pass_rows, blocks, stream);
    case 4: return by_route<4, kMat>(a, s, pbits, pass_rows, blocks, stream);
    case 8: return by_route<8, kMat>(a, s, pbits, pass_rows, blocks, stream);
    case 16: return by_route<16, kMat>(a, s, pbits, pass_rows, blocks, stream);
    case 32: return by_route<32, kMat>(a, s, pbits, pass_rows, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int64_t total_groups, int gbits, int pre_shift, int max_iters) {
  return gbits < 0 || gbits > 32 || pre_shift < 0 || pre_shift > 32 || max_iters < 0 ||
         total_groups < (1ll << gbits);
}

}  // namespace

extern "C" {

// Bytes of device scratch a walk with this plan needs (0 for 0 levels, -1
// for a plan it does not take).
int64_t fhj_global_walk_scratch_bytes(int gbits, int pbits, int64_t pass_rows, int blocks,
                                      int materialize) {
  if (!plan_ok(gbits, pbits, pass_rows, blocks)) return -1;
  return pbits == 0 ? 0 : (int64_t)pass_layout(nullptr, pass_rows, pbits, blocks, materialize).bytes;
}

// Count the probes (ph, pl)[0, np_valid) whose key is in the table: adds
// into *count (a zeroed int64 on the card), and, when stats is not null,
// the groups visited into stats[0], the longest walk into stats[1] and the
// rows whose bloom test passed into stats[2].  group_size a power of two
// up to 32; bloom null when off.  The plan: pbits digit bits (0: the walk
// over the planes), passes of at most pass_rows rows, at most `blocks`
// partition blocks; scratch fhj_global_walk_scratch_bytes bytes.
// survivors, when not null, makes this one pruned pass (pbits > 0,
// np_valid <= pass_rows): (ph, pl) are fhj_global_prune's survivors,
// [survivors[0], survivors[1]) on the card, np_valid their bound; bloom is
// not read.  On `stream`; returns cudaGetLastError().
int fhj_global_walk_count(const uint32_t* keys, const int64_t* bloom, const int64_t* special,
                          int64_t total_groups, int group_size, int gbits, int pre_shift,
                          int bloom_k, int max_iters, const uint32_t* ph, const uint32_t* pl,
                          int64_t np_valid, unsigned long long* count,
                          unsigned long long* stats, int pbits, int64_t pass_rows, int blocks,
                          void* scratch, int64_t scratch_bytes, const uint32_t* survivors,
                          cudaStream_t stream) {
  if (bad_shape(total_groups, gbits, pre_shift, max_iters) ||
      !plan_ok(gbits, pbits, pass_rows, blocks) ||
      (survivors != nullptr && (pbits == 0 || np_valid > pass_rows)))
    return (int)cudaErrorInvalidValue;
  const PassScratch s = pass_layout(static_cast<char*>(scratch), pass_rows, pbits, blocks, false);
  if (pbits && scratch_bytes < (int64_t)s.bytes) return (int)cudaErrorInvalidValue;
  Walk a{};
  a.keys = keys, a.bloom = survivors ? nullptr : bloom, a.special = special;
  a.total_groups = total_groups, a.gbits = gbits, a.pre_shift = pre_shift;
  a.bloom_k = bloom_k, a.max_iters = max_iters, a.count = count, a.stats = stats;
  a.ph = ph, a.pl = pl, a.n = np_valid, a.np_valid = np_valid, a.survivors = survivors;
  return (int)walk<false>(a, group_size, s, pbits, pass_rows, blocks, stream);
}

// The bloom prune of probe rows (ph, pl)[0, n): each row that is not the
// u64-max key and whose tag bloom_word(h, bloom_k) is inside its home
// group's word (pre_shift as the walk's) is copied to (sh, sl)[0,
// survivors), in no order, rows = [0, survivors) (two u32 words the launch
// zeroes first); the u64-max rows add into *count when special[0] > 0, and
// the survivors into stats[2] when stats is not null.  n < 2^31.  The
// words: the prune reads the bloom words narrowed to u32 (n_words of
// them), half the bytes of the table's int64 words, so that more of them
// stay in L2 (9.2 ms against 12.1 at config #3, PERF.md); with bloom not
// null, the table's words are narrowed into words first.  A memset and
// one or two launches on `stream`; returns cudaGetLastError().
int fhj_global_prune(const int64_t* bloom, uint32_t* words, int64_t n_words,
                     const int64_t* special, int gbits, int pre_shift, int bloom_k,
                     const uint32_t* ph, const uint32_t* pl, int64_t n, uint32_t* sh,
                     uint32_t* sl, uint32_t* rows, unsigned long long* count,
                     unsigned long long* stats, cudaStream_t stream) {
  if (gbits < 0 || gbits > 32 || pre_shift < 0 || pre_shift > 32 || bloom_k < 0 ||
      bloom_k > 32 || n < 0 || n >= (1ll << 31) || words == nullptr || n_words < (1ll << gbits))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(rows, 0, 2 * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return (int)e;
  if (bloom != nullptr &&
      (e = fhj::launch(bloom_words_kernel, n_words, stream, bloom, words, n_words)) != cudaSuccess)
    return (int)e;
  if (n == 0) return (int)cudaSuccess;
  int grid = 0;
  cudaFuncSetAttribute(prune_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kPruneSmem);
  if ((e = fhj::grid_for(prune_kernel, n, kPruneSmem, &grid, kPrunePer)) != cudaSuccess)
    return (int)e;
  const Prune a{ph, pl, n, words, special, gbits, pre_shift, bloom_k, sh, sl, rows, count, stats};
  prune_kernel<<<grid, fhj::kThreads, kPruneSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Per probe row i < n: hit[i], and (vh[i], vl[i]) the matching slot's
// value (special[1:3] for a u64-max probe; 0 on a miss and at or past
// np_valid); stats and the plan as for the count.
int fhj_global_walk_materialize(const uint32_t* keys, const uint32_t* vals, const int64_t* bloom,
                                const int64_t* special, int64_t total_groups, int group_size,
                                int gbits, int pre_shift, int bloom_k, int max_iters,
                                const uint32_t* ph, const uint32_t* pl, int64_t n,
                                int64_t np_valid, bool* hit, uint32_t* vh, uint32_t* vl,
                                unsigned long long* stats, int pbits, int64_t pass_rows,
                                int blocks, void* scratch, int64_t scratch_bytes,
                                cudaStream_t stream) {
  if (bad_shape(total_groups, gbits, pre_shift, max_iters) || np_valid > n ||
      !plan_ok(gbits, pbits, pass_rows, blocks))
    return (int)cudaErrorInvalidValue;
  const PassScratch s = pass_layout(static_cast<char*>(scratch), pass_rows, pbits, blocks, true);
  if (pbits && scratch_bytes < (int64_t)s.bytes) return (int)cudaErrorInvalidValue;
  Walk a{};
  a.keys = keys, a.vals = vals, a.bloom = bloom, a.special = special;
  a.total_groups = total_groups, a.gbits = gbits, a.pre_shift = pre_shift;
  a.bloom_k = bloom_k, a.max_iters = max_iters, a.stats = stats, a.ph = ph, a.pl = pl;
  a.n = n, a.np_valid = np_valid, a.hit = hit, a.vh = vh, a.vl = vl;
  return (int)walk<true>(a, group_size, s, pbits, pass_rows, blocks, stream);
}

}  // extern "C"
