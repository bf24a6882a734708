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
//    probe alone in numpy and compares).
//
// What bounds it on an H100: device memory.  Each probe reads its 8-byte
// key and one 64-byte group row (G = 8), a few per cent two; the table
// (2^gbits + 64 groups, 4.3 GB of key and value planes at 1e8 build rows)
// is far larger than L2, so nearly every row read is an HBM access: ~7.2
// GB at J1 1e8 Q5, ~2.2 ms, where each input byte read once (the probe
// planes and the 2.15 GB key plane) would take 0.88 ms.
// Design (right and simple first): one thread a probe row, grid-stride
// with 64-bit row and group indices (probe sides reach 1e9 rows, and g *
// 2G passes 2^31 from 2^27 groups); the group row as G / 2 16-byte loads;
// one launch over the whole probe side, no chunks.  The count is reduced
// within the block and added once a block; materialize writes a hit mask
// and the (vh, vl) planes for every probe row (0 on a miss), which K5
// compacts in probe order.  The walk also adds up the groups it visited
// and keeps the longest walk (stats[0], stats[1]), read after the call.
#include "common.cuh"
#include "hash.cuh"

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
  const uint32_t* ph;
  const uint32_t* pl;
  int64_t n, np_valid;
  unsigned long long* count;  // count: the 0-d result, zeroed by the caller
  bool* hit;                  // materialize: (n,) hit mask and values
  uint32_t* vh;
  uint32_t* vl;
  unsigned long long* stats;  // [groups visited, longest walk], or null
};

template <int G, bool kMat>
__global__ void __launch_bounds__(fhj::kThreads) walk_kernel(const Walk a) {
  const bool has_max = __ldg(a.special) > 0;
  const uint32_t max_vh = (uint32_t)__ldg(a.special + 1);
  const uint32_t max_vl = (uint32_t)__ldg(a.special + 2);
  const int64_t rows = kMat ? a.n : a.np_valid;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  unsigned long long hits = 0, groups = 0;
  unsigned int longest = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < rows; i += stride) {
    bool hit = false;
    uint32_t out_h = 0, out_l = 0;
    unsigned int visited = 0;
    if (i < a.np_valid) {
      const uint32_t kh = __ldg(a.ph + i);
      const uint32_t kl = __ldg(a.pl + i);
      if (kh == kEmpty && kl == kEmpty) {
        hit = has_max;
        out_h = has_max ? max_vh : 0u;
        out_l = has_max ? max_vl : 0u;
      } else {
        const uint32_t h = fhj::hash_u64(kh, kl);
        int64_t g = fhj::home_group(h, a.gbits, a.pre_shift);
        bool walks = true;
        if (a.bloom != nullptr) {
          const uint32_t tag = fhj::bloom_word(h, a.bloom_k);
          walks = ((uint32_t)__ldg(a.bloom + g) & tag) == tag;
        }
        for (int it = 0; walks && it < a.max_iters; ++it) {
          const int64_t base = g * (2 * G);
          uint32_t w[2 * G];
          load_group<G>(a.keys + base, w);
          ++visited;
          int j = -1;
          bool empty = false;
#pragma unroll
          for (int q = G - 1; q >= 0; --q) {    // the lowest matching slot wins
            if (w[q] == kh && w[G + q] == kl) j = q;
            empty |= (w[q] == kEmpty) & (w[G + q] == kEmpty);
          }
          if (j >= 0) {
            hit = true;
            if (kMat) {
              out_h = __ldg(a.vals + base + j);
              out_l = __ldg(a.vals + base + G + j);
            }
            break;
          }
          if (empty || g + 1 >= a.total_groups) break;   // absent
          ++g;
        }
      }
    }
    hits += hit;
    groups += visited;
    longest = visited > longest ? visited : longest;
    if (kMat) {
      a.hit[i] = hit;
      a.vh[i] = out_h;
      a.vl[i] = out_l;
    }
  }
  if (!kMat) {
    const unsigned long long s = fhj::block_sum(hits);
    if (threadIdx.x == 0 && s) atomicAdd(a.count, s);
    __syncthreads();                  // block_sum's shared words are reused below
  }
  if (a.stats != nullptr) {
    const unsigned long long s = fhj::block_sum(groups);
    if (threadIdx.x == 0 && s) atomicAdd(a.stats, s);
    const unsigned int m = __reduce_max_sync(0xffffffffu, longest);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(a.stats + 1, (unsigned long long)m);
  }
}

template <int G, bool kMat>
cudaError_t run(const Walk& a, cudaStream_t stream) {
  const int64_t rows = kMat ? a.n : a.np_valid;
  if (rows == 0) return cudaSuccess;
  return fhj::launch(walk_kernel<G, kMat>, rows, stream, a);
}

template <bool kMat>
cudaError_t walk(const Walk& a, int group_size, cudaStream_t stream) {
  switch (group_size) {
    case 1: return run<1, kMat>(a, stream);
    case 2: return run<2, kMat>(a, stream);
    case 4: return run<4, kMat>(a, stream);
    case 8: return run<8, kMat>(a, stream);
    case 16: return run<16, kMat>(a, stream);
    case 32: return run<32, kMat>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int64_t total_groups, int gbits, int pre_shift, int max_iters) {
  return gbits < 0 || gbits > 32 || pre_shift < 0 || pre_shift > 32 || max_iters < 0 ||
         total_groups < (1ll << gbits);
}

}  // namespace

extern "C" {

// Count the probes (ph, pl)[0, np_valid) whose key is in the table: adds
// into *count (a zeroed int64 on the card), and, when stats is not null,
// the groups visited into stats[0] and the longest walk into stats[1].
// group_size a power of two up to 32; bloom null when off.  On `stream`;
// returns cudaGetLastError().
int fhj_global_walk_count(const uint32_t* keys, const int64_t* bloom, const int64_t* special,
                          int64_t total_groups, int group_size, int gbits, int pre_shift,
                          int bloom_k, int max_iters, const uint32_t* ph, const uint32_t* pl,
                          int64_t np_valid, unsigned long long* count,
                          unsigned long long* stats, cudaStream_t stream) {
  if (bad_shape(total_groups, gbits, pre_shift, max_iters)) return (int)cudaErrorInvalidValue;
  const Walk a{keys, nullptr, bloom, special, total_groups, gbits, pre_shift, bloom_k,
               max_iters, ph, pl, np_valid, np_valid, count, nullptr, nullptr, nullptr, stats};
  return (int)walk<false>(a, group_size, stream);
}

// Per probe row i < n: hit[i], and (vh[i], vl[i]) the matching slot's
// value (special[1:3] for a u64-max probe; 0 on a miss and at or past
// np_valid); stats as for the count.
int fhj_global_walk_materialize(const uint32_t* keys, const uint32_t* vals, const int64_t* bloom,
                                const int64_t* special, int64_t total_groups, int group_size,
                                int gbits, int pre_shift, int bloom_k, int max_iters,
                                const uint32_t* ph, const uint32_t* pl, int64_t n,
                                int64_t np_valid, bool* hit, uint32_t* vh, uint32_t* vl,
                                unsigned long long* stats, cudaStream_t stream) {
  if (bad_shape(total_groups, gbits, pre_shift, max_iters) || np_valid > n)
    return (int)cudaErrorInvalidValue;
  const Walk a{keys, vals, bloom, special, total_groups, gbits, pre_shift, bloom_k,
               max_iters, ph, pl, n, np_valid, nullptr, hit, vh, vl, stats};
  return (int)walk<true>(a, group_size, stream);
}

}  // extern "C"
