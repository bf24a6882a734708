// The partitioned tier's table build: a stable LSD radix sort of the valid
// build rows by their u64 key, over the key bits that vary, each record
// carrying its value words.
//
// Replaces no TPU kernel: the JAX package sorts the build side with a plain
// lax.sort (flash_hash_join_tpu/ops/range_table.py:build_range_table), and
// the first port with torch's stable sort of an int64 sortable key, then a
// stack of (vh, vl) and a gather of it by the sort's order.  Same function:
// keys, the valid rows' sortable keys (utils/u64.py:sortable) ascending,
// equal keys in row order, so the first of a run is its minimum build row;
// values, their (vh, vl) pairs in the same order as one interleaved plane.
//
// What bounds it on an H100: device memory.  A build must read each row's
// key and value words once (16 B) and write its sortable key and value pair
// once (16 B): at J1 1e8 Q5, 3.2 GB, about 1 ms at 3.35 TB/s.  A sort of
// 27-bit keys in 9-bit digits moves each record three times.
//
// What the design does about it, against torch.sort's CUB onesweep over
// (int64 key, int64 index) and all 64 bits, then the stack and the gather:
//  * count_kernel reads the key planes once and counts the digits of all
//    eight 9-bit digit positions (bits 0-8, 9-17, ..., 63), with the OR and
//    the AND of the high words; its last block finds the positions whose
//    digit is the same for every key, turns each count into its digit's
//    exclusive base, and writes the plan: the digits that vary ("live"),
//    lowest first, and whether the high word is shared.  Every decision is
//    on the card: no host sync.  Digits of 9 bits take J1's 27-bit keys in
//    three passes where 8 bits take four (the 512 digit values a tile cost
//    little more than 256 against a whole pass: PERF.md); keys over all 64
//    bits take eight either way.
//  * records are narrow: while the high word is shared, the key travels as
//    its low word alone (4 B, 12 B with the value words), else as both
//    words (8 B, 16 B).  The values ride in the record, so no gather is
//    left.  The first live pass reads the input planes, the last writes the
//    int64 sortable keys and the interleaved values: no int64 or stacked
//    intermediate.  The passes between ping-pong between a scratch buffer
//    and the output's own memory, arranged so that the last pass reads the
//    scratch buffer.
//  * a pass kernel a record width, so that each has the tile and the
//    registers that suit it (Records): for each digit position the narrow
//    and the wide kernel of the build are launched, sixteen in all, and a
//    kernel whose digit is not live or whose width is not the plan's
//    returns at once (about 1 µs).  No live digit (all keys equal, one row)
//    leaves digit 0 live: its stable pass is the copy into the output.
//  * a pass is a single sweep (onesweep): each block takes tiles in ticket
//    order; ranks each warp's rows stably (a warp's rows are contiguous,
//    taken item by item, lane by lane, so that order is row order; a lane's
//    peers from a ballot a digit bit, which beat __match_any_sync by 4 % on
//    the build); takes each digit's offset from the tiles before it by a
//    decoupled look-back, a thread two digit values, whose two states it
//    reads and writes as one 16-byte word; stages the tile's records in
//    digit order in shared memory; and writes each digit's run of records
//    at its offset, so the stores are whole runs.  A tile state is one
//    64-bit word (the pass's tag, an inclusive flag, the count), stored and
//    loaded whole, so a reader needs no fence; the tag tells one pass's
//    states from the last's, so one zeroing of the states serves every
//    pass.  Measured and dropped (PERF.md): taking the next tile's ticket
//    early (a tile held but not started stalls the look-backs after it),
//    and a look-back that reads 4-16 states at once.
// An LSD pass costs the same whatever the keys: skewed or equal keys cost
// what uniform ones do (no tile can overflow, unlike the MSD tiles of
// hash_build.cu).
#include "common.cuh"

namespace {

constexpr int kBlock = fhj::kThreads;   // threads a block, every kernel
constexpr int kWarps = kBlock / 32;
constexpr int kDigitBits = 9;           // a digit: 9 bits of the u64 key
constexpr int kDigits = 8;              // digit positions: bits 0-71 cover the key
constexpr int kBins = 1 << kDigitBits;
constexpr int kPer = kBins / kBlock;    // digit values a thread keeps: 2t and 2t + 1
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ull;
static_assert(kPer == 2, "two digit values a thread");

// The scratch: digit counts (then bases), the plan, the tile counters, then
// a tile state a (tile, digit value).  Zeroed up to the states' end.
constexpr size_t kPlanOffset = sizeof(uint32_t) * kDigits * kBins;
constexpr size_t kTicketOffset = kPlanOffset + 8 * sizeof(uint32_t);
constexpr size_t kStatusOffset = kPlanOffset + 256;  // past the tickets, 256-byte aligned
static_assert(kTicketOffset + kDigits * sizeof(uint32_t) <= kStatusOffset, "scratch layout");
// plan words: [0] live digits | narrow << 8, [1] the OR of the high words,
// [2] count_kernel's finished blocks, [3] the OR of the high words' complements

// A tile state: the pass's tag (1 + its index among the live passes) in the
// top 4 bits, then the inclusive flag, then the count below.
constexpr int kTagShift = 60;
constexpr unsigned long long kInclusive = 1ull << 59, kCount = kInclusive - 1;
constexpr long long kMaxSpins = 1ll << 26;  // reads of one state: seconds, where a wait is µs

// Two adjacent tile states (digit values 2t, 2t + 1), each read and written
// whole.
__device__ __forceinline__ void store_states(unsigned long long* p, unsigned long long a,
                                             unsigned long long b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(a), "l"(b)
               : "memory");
}

__device__ __forceinline__ void load_states(const unsigned long long* p, unsigned long long* a,
                                            unsigned long long* b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];" : "=l"(*a), "=l"(*b) : "l"(p)
               : "memory");
}

__device__ __forceinline__ uint32_t digit_of(unsigned long long key, int k) {
  return (uint32_t)(key >> (kDigitBits * k)) & (kBins - 1u);
}

// Exclusive sum of v over the block (a value a thread, in thread order);
// *total gets the sum of all.  Every thread calls it.
__device__ uint32_t block_exclusive_sum(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    before += w < warp ? s : 0u;
    all += s;
  }
  __syncthreads();  // warp_sums is read before another call rewrites it
  *total = all;
  return before + x - v;
}

// The digit counts of every position over the key planes [0, n), and the
// OR and the AND of the high words; then, in the last block to finish, the
// plan and each count replaced by its digit's exclusive base.  Each thread
// counts runs of equal digits in registers and adds a run to shared memory
// when it ends, so a position whose digit is the same for every key costs
// no atomic a key.
__global__ void __launch_bounds__(kBlock)
count_kernel(const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl, int64_t n,
             uint32_t* hist, uint32_t* plan) {
  __shared__ uint32_t h[kDigits * kBins];
  __shared__ uint32_t finished;
  for (int i = threadIdx.x; i < kDigits * kBins; i += kBlock) h[i] = 0;
  __syncthreads();
  uint32_t last[kDigits], run[kDigits], hi_or = 0, hi_and = kFull;
#pragma unroll
  for (int k = 0; k < kDigits; ++k) last[k] = 0, run[k] = 0;
  fhj::for_each_pair(kh, kl, n, [&](uint32_t hi, uint32_t lo) {
    hi_or |= hi, hi_and &= hi;
    const unsigned long long key = (unsigned long long)hi << 32 | lo;
#pragma unroll
    for (int k = 0; k < kDigits; ++k) {
      const uint32_t d = digit_of(key, k);
      if (d != last[k]) {
        if (run[k]) atomicAdd(h + k * kBins + last[k], run[k]);
        last[k] = d, run[k] = 0;
      }
      ++run[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kDigits; ++k)
    if (run[k]) atomicAdd(h + k * kBins + last[k], run[k]);
  hi_or = __reduce_or_sync(kFull, hi_or);
  hi_and = __reduce_and_sync(kFull, hi_and);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(plan + 1, hi_or);
    atomicOr(plan + 3, ~hi_and);  // zeroed, so the AND goes in as its complement
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits * kBins; i += kBlock)
    if (h[i]) atomicAdd(hist + i, h[i]);
  __threadfence();
  if (threadIdx.x == 0) finished = atomicAdd(plan + 2, 1u);
  __syncthreads();
  if (finished != gridDim.x - 1) return;
  // the last block: every count is in device memory (the atomics are done
  // at L2, and each block fenced before it counted itself finished)
  __threadfence();
  const int d = kPer * threadIdx.x;  // this thread's digit values d, d + 1
  uint32_t live = 0;
  for (int k = 0; k < kDigits; ++k) {
    const uint32_t c0 = __ldcg(hist + k * kBins + d), c1 = __ldcg(hist + k * kBins + d + 1);
    // a digit value in every key: the position is the same for all
    if (!__syncthreads_or(c0 == (uint32_t)n || c1 == (uint32_t)n)) live |= 1u << k;
    uint32_t total;
    const uint32_t before = block_exclusive_sum(c0 + c1, &total);
    hist[k * kBins + d] = before;
    hist[k * kBins + d + 1] = before + c0;
  }
  if (threadIdx.x == 0) {
    if (live == 0) live = 1;  // the copy into the output: a stable pass of digit 0
    const uint32_t ors = __ldcg(plan + 1), ands = ~__ldcg(plan + 3);
    plan[0] = live | (ors == ands ? 1u << 8 : 0u);  // narrow: one high word in all
  }
}

// A pass's records are W words: the key's words first (the low word alone
// while the high word is shared), then (vh, vl) where the build keeps
// values.  W names the record: 1 a narrow key, 2 a whole key, 3 and 4 the
// same with values.  The rows a thread takes a tile, and the blocks a
// multiprocessor holds (registers: 65536 / (256 kMinBlocks) a thread), for
// each: the best of 12-32 rows and 1-4 blocks on an H100 at 1e8 rows
// (PERF.md): larger tiles share a look-back and a tile's fixed steps among
// more rows, until registers spill.
template <int W>
struct Records {
  static constexpr bool kNarrow = W & 1;
  static constexpr int kKeyWords = kNarrow ? 1 : 2;
  static constexpr bool kValues = W > kKeyWords;
  static constexpr int kItems = W == 1 ? 24 : 16;
  static constexpr int kTile = kBlock * kItems;
  static constexpr int kMinBlocks = W <= 2 ? 3 : 2;
};
constexpr int min2(int a, int b) { return a < b ? a : b; }
// the least tile of any record: the states are sized for it
constexpr int kMinTile = min2(min2(Records<1>::kTile, Records<2>::kTile),
                              min2(Records<3>::kTile, Records<4>::kTile));

struct Pass {
  const uint32_t* kh;  // the input planes, read by the first live pass
  const uint32_t* kl;
  const uint32_t* vh;
  const uint32_t* vl;
  uint32_t* out;       // the output: n int64 keys, then (values) n (vh, vl) pairs
  uint32_t* buf;       // the other ping-pong buffer
  const uint32_t* base;  // (kDigits, kBins) digit bases
  const uint32_t* plan;
  uint32_t* tickets;   // a tile counter a digit position
  unsigned long long* state;  // (tiles, kBins)
  int64_t n;
  int digit;           // this launch's digit position
};

// A pass's shared memory: the stage of a tile's records, then a digit's
// output record of its first staged record less its slot (delta), its base
// in this pass, its first stage slot (lstart), each warp's count of it and
// then its offset (whist), and each stage slot's digit (sdig).
template <int W>
struct Shared {
  static constexpr int kTile = Records<W>::kTile;
  uint32_t stage[W * kTile];
  long long delta[kBins];
  uint32_t base[kBins];
  uint32_t lstart[kBins];
  uint32_t whist[kWarps * kBins];
  uint16_t sdig[kTile];
};

template <int W>
__device__ __forceinline__ void load_record(const uint32_t* s, uint32_t (&r)[W]) {
  if constexpr (W == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(s);
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else if constexpr (W == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(s);
    r[0] = q.x, r[1] = q.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) r[w] = s[w];
  }
}

template <int W>
__device__ __forceinline__ void store_record(uint32_t* s, const uint32_t (&r)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(s) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(s) = make_uint2(r[0], r[1]);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = r[w];
  }
}

// The pass of digit position P.digit over records of W words, launched for
// every position and both record widths of the build: it returns at once
// unless its digit is live and its width the plan's.
template <int W>
__global__ void __launch_bounds__(kBlock, Records<W>::kMinBlocks) pass_kernel(const Pass P) {
  using R = Records<W>;
  constexpr int KW = R::kKeyWords, kItems = R::kItems, kTile = R::kTile;
  const uint32_t word = __ldcg(P.plan), live = word & 0xFFu;
  if (!((live >> P.digit) & 1u) || ((word >> 8) & 1u) != (uint32_t)R::kNarrow) return;
  const uint32_t hi_word = __ldcg(P.plan + 1);
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<W>& S = *reinterpret_cast<Shared<W>*>(smem);
  __shared__ long long tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = P.digit;
  // this pass's place among the live ones; the passes between the first and
  // the last alternate between out and buf so that the last reads buf
  const int j = __popc(live & ((1u << k) - 1u)), passes = __popc(live);
  const bool first = j == 0, last = j == passes - 1;
  const uint32_t* const src = first ? nullptr : ((passes - 1 - j) & 1) ? P.out : P.buf;
  uint32_t* const dst = last ? nullptr : ((passes - 2 - j) & 1) ? P.out : P.buf;
  const unsigned long long tag = (unsigned long long)(j + 1) << kTagShift;
  const long long tiles = (P.n + kTile - 1) / kTile;
  const int d = kPer * threadIdx.x;  // this thread's digit values d, d + 1
  S.base[d] = P.base[k * kBins + d];
  S.base[d + 1] = P.base[k * kBins + d + 1];
  const unsigned lt = (1u << lane) - 1u;
  // the digit of a record (word indices constant: the record stays in registers)
  auto digit = [&](const uint32_t(&r)[W]) {
    return digit_of(R::kNarrow ? (unsigned long long)hi_word << 32 | r[0]
                               : (unsigned long long)r[0] << 32 | r[1], k);
  };

  for (;;) {
    if (threadIdx.x == 0) tile_sh = atomicAdd(P.tickets + k, 1u);
    for (int i = threadIdx.x; i < kWarps * kBins; i += kBlock) S.whist[i] = 0;
    __syncthreads();
    const long long t = tile_sh;
    if (t >= tiles) break;
    const int64_t row0 = t * (int64_t)kTile;
    const int rows = (int)(P.n - row0 < kTile ? P.n - row0 : kTile);
    const int r0 = warp * 32 * kItems + lane;  // item i is tile row r0 + 32 i

    uint32_t rec[kItems][W];
    if (first) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = r0 + 32 * i;
        const int64_t row = row0 + r;
        const bool on = r < rows;
        if constexpr (R::kNarrow) {
          rec[i][0] = on ? __ldcs(P.kl + row) : 0u;
        } else {
          rec[i][0] = on ? __ldcs(P.kh + row) : 0u;
          rec[i][1] = on ? __ldcs(P.kl + row) : 0u;
        }
        if constexpr (R::kValues) {
          rec[i][KW] = on ? __ldcs(P.vh + row) : 0u;
          rec[i][KW + 1] = on ? __ldcs(P.vl + row) : 0u;
        }
      }
    } else {
      // the tile's records, contiguous, into the stage in 16-byte loads
      const uint32_t* s = src + (int64_t)W * row0;
      const int words = W * rows, quads = words >> 2;
      for (int q = threadIdx.x; q < quads; q += kBlock)
        reinterpret_cast<uint4*>(S.stage)[q] = __ldcs(reinterpret_cast<const uint4*>(s) + q);
      for (int q = 4 * quads + threadIdx.x; q < words; q += kBlock) S.stage[q] = __ldcs(s + q);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int r = r0 + 32 * i;
        if (r < rows) {
          load_record<W>(S.stage + W * r, rec[i]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) rec[i][w] = 0u;
        }
      }
    }

    // rank: within the warp, item by item, lane by lane (row order); a
    // lane's peers (the lanes of its digit) from one ballot a digit bit and
    // one for the rows past the tile's end (digit kBins)
    uint32_t wrank[(kItems + 1) / 2];  // two 16-bit ranks a register: no spill at 128
#pragma unroll
    for (int i = 0; i < (kItems + 1) / 2; ++i) wrank[i] = 0;
    uint32_t* const wh = S.whist + warp * kBins;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool on = r0 + 32 * i < rows;
      const uint32_t dg = on ? digit(rec[i]) : (uint32_t)kBins;
      unsigned peers = kFull;
#pragma unroll
      for (int b = 0; b <= kDigitBits; ++b) {
        const bool bit = (dg >> b) & 1u;
        const unsigned m = __ballot_sync(kFull, bit);
        peers &= bit ? m : ~m;
      }
      const int leader = __ffs(peers) - 1;
      uint32_t before = 0;
      if (lane == leader && on) {
        before = wh[dg];
        wh[dg] = before + __popc(peers);
      }
      wrank[i / 2] |= (__shfl_sync(kFull, before, leader) + __popc(peers & lt)) << (16 * (i & 1));
      __syncwarp();
    }
    __syncthreads();

    // digits d, d + 1: the warps' offsets, the tile's counts, published at once
    uint32_t count0 = 0, count1 = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      uint32_t* const c = S.whist + w * kBins + d;
      const uint32_t c0 = c[0], c1 = c[1];
      c[0] = count0, c[1] = count1;
      count0 += c0, count1 += c1;
    }
    unsigned long long* const mine = P.state + t * kBins + d;
    const unsigned long long flag = tag | (t == 0 ? kInclusive : 0ull);
    store_states(mine, flag | count0, flag | count1);
    uint32_t tile_rows;
    const uint32_t lstart = block_exclusive_sum(count0 + count1, &tile_rows);
    S.lstart[d] = lstart;
    S.lstart[d + 1] = lstart + count0;
    __syncthreads();

    // stage the records in digit order
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (r0 + 32 * i < rows) {
        const uint32_t dg = digit(rec[i]);
        const uint32_t rank = (wrank[i / 2] >> (16 * (i & 1))) & 0xFFFFu;
        const uint32_t slot = S.lstart[dg] + S.whist[warp * kBins + dg] + rank;
        store_record<W>(S.stage + W * slot, rec[i]);
        S.sdig[slot] = (uint16_t)dg;
      }

    // digits d, d + 1: their records before this tile's, by a decoupled
    // look-back over both states of a tile at once, each digit's walk ending
    // at its first inclusive state
    unsigned long long before0 = 0, before1 = 0;
    if (t > 0) {
      const unsigned long long mark = (unsigned long long)(j + 1);
      bool done0 = false, done1 = false;
      long long spins = 0;
      for (long long p = t - 1; !(done0 && done1);) {
        unsigned long long s0, s1;
        load_states(P.state + p * kBins + d, &s0, &s1);
        if ((!done0 && (s0 >> kTagShift) != mark) || (!done1 && (s1 >> kTagShift) != mark)) {
          if (++spins > kMaxSpins) __trap();  // a tile that never publishes: fail, not hang
          continue;                           // not yet published
        }
        if (!done0) {
          before0 += s0 & kCount;
          done0 = (s0 & kInclusive) != 0;
        }
        if (!done1) {
          before1 += s1 & kCount;
          done1 = (s1 & kInclusive) != 0;
        }
        --p;
      }
      store_states(mine, tag | kInclusive | (before0 + count0),
                   tag | kInclusive | (before1 + count1));
    }
    S.delta[d] = (long long)S.base[d] + (long long)before0 - (long long)lstart;
    S.delta[d + 1] = (long long)S.base[d + 1] + (long long)before1 - (long long)(lstart + count0);
    __syncthreads();

    // write each digit's run at its offset
    if (last) {
      long long* const keys = reinterpret_cast<long long*>(P.out);
      uint2* const values = reinterpret_cast<uint2*>(P.out + 2 * P.n);
      for (int r = threadIdx.x; r < rows; r += kBlock) {
        const long long at = S.delta[S.sdig[r]] + r;
        const uint32_t* q = S.stage + W * r;
        const unsigned long long key =
            R::kNarrow ? ((unsigned long long)hi_word << 32 | q[0])
                       : ((unsigned long long)q[0] << 32 | q[1]);
        keys[at] = (long long)(key ^ kSign);
        if constexpr (R::kValues) values[at] = make_uint2(q[KW], q[KW + 1]);
      }
    } else if constexpr (W == 3) {  // a word a thread
      for (int q = threadIdx.x; q < W * rows; q += kBlock) {
        const int r = q / W;
        dst[W * (S.delta[S.sdig[r]] + r) + (q - W * r)] = S.stage[q];
      }
    } else {  // a record a thread
      for (int r = threadIdx.x; r < rows; r += kBlock) {
        uint32_t q[W];
        load_record<W>(S.stage + W * r, q);
        store_record<W>(dst + W * (S.delta[S.sdig[r]] + r), q);
      }
    }
    __syncthreads();  // the stage, sdig and delta are the next tile's
  }
}

int64_t tiles_of(int64_t n) { return (n + kMinTile - 1) / kMinTile; }

// The pass kernel of W-word records: its shared memory and its grid, the
// blocks the card holds at once.
template <int W>
cudaError_t pass_launch(int* grid, size_t* smem) {
  *smem = sizeof(Shared<W>);
  cudaError_t e = cudaFuncSetAttribute(pass_kernel<W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pass_kernel<W>, kBlock,
                                                         *smem)) != cudaSuccess)
    return e;
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The passes of every digit position, narrow records then wide (the card's
// plan keeps one of the two, or neither).
template <int Wn, int Ww>
cudaError_t launch_passes(Pass P, cudaStream_t stream) {
  int gn = 0, gw = 0;
  size_t sn = 0, sw = 0;
  cudaError_t e = pass_launch<Wn>(&gn, &sn);
  if (e == cudaSuccess) e = pass_launch<Ww>(&gw, &sw);
  if (e != cudaSuccess) return e;
  const int64_t tn = (P.n + Records<Wn>::kTile - 1) / Records<Wn>::kTile;
  const int64_t tw = (P.n + Records<Ww>::kTile - 1) / Records<Ww>::kTile;
  for (int k = 0; k < kDigits; ++k) {
    P.digit = k;
    pass_kernel<Wn><<<(int)(tn < gn ? tn : gn), kBlock, sn, stream>>>(P);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    pass_kernel<Ww><<<(int)(tw < gw ? tw : gw), kBlock, sw, stream>>>(P);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of device scratch fhj_range_build needs for n rows.
int64_t fhj_range_build_scratch_bytes(int64_t n) {
  return (int64_t)kStatusOffset + tiles_of(n) * kBins * 8;
}

// The table of the build planes (kh, kl, vh, vl)[0, n), 1 <= n < 2^31: out
// gets n sortable int64 keys, ascending, equal keys in row order, then
// (with_values) their n (vh, vl) u32 pairs; out holds 16 n bytes with
// values, 8 n without.  buf: as many bytes, for the passes.  out, buf and
// scratch on 16-byte boundaries.  scratch:
// fhj_range_build_scratch_bytes(n) bytes; its plan word (at byte 16384: the
// live digit positions in bits 0-7, bit 8 set where the high word is shared)
// stays for a caller to read.  One memset and seventeen launches on
// `stream`, no host sync; returns cudaGetLastError().
int fhj_range_build(const uint32_t* kh, const uint32_t* kl, const uint32_t* vh,
                    const uint32_t* vl, int64_t n, int with_values, void* out, void* buf,
                    void* scratch, int64_t scratch_bytes, cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (n < 1 || n > 0x7fffffff || scratch_bytes < fhj_range_build_scratch_bytes(n) ||
      (with_values && (vh == nullptr || vl == nullptr)) || misaligned(out) ||
      misaligned(buf) || misaligned(scratch))
    return (int)cudaErrorInvalidValue;
  char* const s = static_cast<char*>(scratch);
  uint32_t* const hist = reinterpret_cast<uint32_t*>(s);
  uint32_t* const plan = reinterpret_cast<uint32_t*>(s + kPlanOffset);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)fhj_range_build_scratch_bytes(n), stream);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  if ((e = fhj::grid_for(count_kernel, n, 0, &grid)) != cudaSuccess) return (int)e;
  count_kernel<<<grid, kBlock, 0, stream>>>(kh, kl, n, hist, plan);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  Pass P{};
  P.kh = kh, P.kl = kl, P.vh = vh, P.vl = vl;
  P.out = static_cast<uint32_t*>(out), P.buf = static_cast<uint32_t*>(buf);
  P.base = hist, P.plan = plan;
  P.tickets = reinterpret_cast<uint32_t*>(s + kTicketOffset);
  P.state = reinterpret_cast<unsigned long long*>(s + kStatusOffset);
  P.n = n;
  return (int)(with_values ? launch_passes<3, 4>(P, stream) : launch_passes<1, 2>(P, stream));
}

}  // extern "C"
