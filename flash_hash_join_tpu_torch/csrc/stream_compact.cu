// K5: stable, sort-free stream compaction, in one pass.
//
// Replaces flash_hash_join_tpu/ops/pallas/stream_compact.py:
// pack_concat_blocks (kernel body _pack_kernel), which every materialize
// path ends in.  Same function: the rows of V u32 planes whose mask is set
// are written to the front of V output planes, in input order, at exact
// offsets, and the total number of set rows is written to the card.
//
// One launch (after one memset of its scratch) does the whole call: a
// single-pass scan with a decoupled look-back, the card's form of the TPU
// kernel's running total carried across its sequential grid (the SMEM `L`
// of _pack_kernel).  Each block takes the next tile of kTile mask rows
// from an atomic counter (CUDA gives no forward-progress guarantee to a
// block that waits on one not yet scheduled, so tiles are handed out in
// the order blocks start, never by blockIdx):
//   1. each thread reads 16 mask bytes with one 16-byte load (the mask is
//      read once; the chunks at the ends of a misaligned view byte by
//      byte) and the block scans the per-thread hit counts;
//   2. warp 0 publishes the tile's hit count as an "aggregate" state, then
//      walks back over the states of the 32 tiles before it at a time,
//      summing aggregates until it meets an "inclusive prefix", and
//      publishes its own inclusive prefix: a tile waits only for tiles
//      that have started, and never for a whole chain of them;
//   3. meanwhile the block writes its hits' tile-local row numbers to
//      shared memory in order; then, per plane, consecutive threads copy
//      consecutive hits, so the stores are whole 128-byte lines (the walk
//      starts at the 32-word boundary under the tile's offset) and the
//      loads read only the hit rows, merged by the coalescer.
// A tile state is one 64-bit word, flag in the top two bits and the
// prefix below, stored with release and loaded with acquire semantics, so
// a reader never sees a torn state.  The last tile writes the total.
//
// What bounds it on an H100: device-memory traffic.  It reads the 1-byte
// mask once, and the hit rows' V 4-byte values, and writes V 4-byte values
// per hit: at 1e8 rows, 4 planes and a 60 % hit rate, 0.1 GB of mask and
// 1.92 GB of values, a floor of 0.60 ms at the 3.35 TB/s peak
// (chip_smoke.bound).  At that rate nearly every 32-byte sector of the
// input planes holds a hit, so the reads fetch ~1.6 GB rather than 0.96.
//
// The tile: kTile = 8192 rows, 512 threads a block, one 16-byte mask load
// a thread, 16 KB of row numbers in shared memory.  Against 4096 rows (256
// threads, 8 KB) it ran 3-7 % faster back to back at 1e8 rows (4 planes at
// 60 % and 5 % hits, 3 planes at 60 %: 0.95 against 0.99 ms, 0.46 against
// 0.49, 0.76 against 0.79; an NVIDIA H100 80GB HBM3 at 700 W, PERF.md):
// half the tiles, so half the look-backs and tile-counter atomics, and as
// many rows in flight (three blocks a SM at 40 registers a thread, against
// six).
//
// What the design does about it, against the TPU kernel: the TPU kernel
// packs lanes with rotations and moves rows with an MXU permutation matmul
// over a lane-major count layout, because Mosaic cannot scatter; here each
// hit is written to its own address, so none of that, nor the staging and
// carry rows, is needed.  Against the first port (a count kernel, a
// torch.cumsum of the tile counts, a subtraction and a scatter kernel that
// walked its tile in 16 rounds of 256 rows, each hit a lone 4-byte store):
// one launch instead of four, the mask read once, and whole-line stores.
//
// K6: exact-offset concatenation of ragged blocks.  Replaces
// flash_hash_join_tpu/ops/pallas/stream_compact.py:concat_ragged_blocks
// (kernel body _concat_kernel), the second half of the FHJ_COMPACT=stream
// compaction: each block of block_elems words arrives with its valid
// elements already moved to its front (a blockwise torch.sort, in
// ops/compact.py), and the block's prefix of counts[b] elements goes to the
// running offset, the exclusive scan of the counts.
//
// One launch (after one memset of its scratch) does the whole call, as in
// K5: each block takes the next input block from a ticket counter; warp 0
// reads its count, clamps it to [0, block_elems], publishes it and finds
// the block's offset by K5's look_back, which takes the place of the TPU
// kernel's running total; the last block writes the total.  Then the block
// copies the prefix of every plane with K9's loop (fhj::copy_planes): the
// words up to the destination's first 16-byte boundary one by one, then
// whole 16-byte stores, 4 x n_planes 16-byte words in flight a thread, and
// a scalar tail.  In 3 blocks of 4 the source lies at another 16-byte
// offset than the destination and is read with four scalar loads a 16-byte
// word; realigning 16-byte loads with warp shuffles took 140-198 registers
// a thread and ran about twice as long (bench_k6.py's variants, PERF.md).
// 512 threads a block ran as fast as 256.
//
// What bounds it on an H100: device-memory traffic, each kept word read
// once and written once, plane by plane: at 1e8 rows, 4 planes and 60 %
// hits 1.92 GB, 0.573 ms at the 3.35 TB/s peak.  It reads a dense prefix of
// each block, so every sector it fetches is wanted and the bound is its
// floor.  It runs at 0.77-0.80 ms back to back there (93 registers, two
// blocks an SM), against 1.28-1.30 for the first port (a clamp, a
// torch.cumsum and a subtraction in the wrapper, then one block a block
// with one 4-byte load and store in flight a thread, stores at any word
// offset: four launches for two), on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md).
//
// What the design does about it, against the TPU kernel: the TPU kernel
// rotates lanes, merges a carried partial row and orders overlapping DMA
// writes with semaphores, writing 8 rows of slack past the end, because
// Mosaic has no per-element addressing; here each block copies its prefix
// to its own offset, with no slack.
#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 4;
constexpr unsigned kFullWarp = 0xffffffffu;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

// Tile states of the look-back: flag in bits 62-63, prefix below.
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own hits
constexpr unsigned long long kInclusive = 2ull << 62;  // hits up to its end
constexpr unsigned long long kValue = (1ull << 62) - 1;

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Bit k (k < 4) set when byte k of w is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t top = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return ((top >> 7) * 0x10204080u) >> 28;
}

// Bit j set when mask row row0 + j (j < 16) is set; rows outside [0, n)
// read as clear.  A chunk inside the mask is one 16-byte load (mask + row0
// is then 16-byte aligned: the caller walks the 16-byte grid of the view).
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* __restrict__ mask, int64_t n,
                                              int64_t row0) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row0 >= 0 && row0 + 16 <= n) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(mask + row0));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int64_t r = row0 + j;
      if (r >= 0 && r < n) w[j >> 2] |= (uint32_t)mask[r] << (8 * (j & 3));
    }
  }
  return nonzero_bytes(w[0]) | nonzero_bytes(w[1]) << 4 | nonzero_bytes(w[2]) << 8 |
         nonzero_bytes(w[3]) << 12;
}

// The tile's exclusive prefix: the hits of every tile before it (K6: the
// kept words of every block before it).  Called by warp 0 of the block
// after the tile's count `agg` is known; publishes the tile's states on
// the way.
__device__ __forceinline__ long long look_back(unsigned long long* __restrict__ state,
                                               long long tile, long long agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_release(state, kInclusive | (unsigned long long)agg);
    return 0;
  }
  if (lane == 0) store_release(state + tile, kAggregate | (unsigned long long)agg);
  long long excl = 0;
  for (long long end = tile;; end -= 32) {
    // lane k reads tile end - 1 - k; before tile 0 reads as a prefix of 0
    const long long j = end - 1 - lane;
    unsigned long long s;
    do {
      s = j >= 0 ? load_acquire(state + j) : kInclusive;
    } while (__any_sync(kFullWarp, (s >> 62) == 0));
    const unsigned inclusive = __ballot_sync(kFullWarp, (s >> 62) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    long long v = lane <= stop ? (long long)(s & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullWarp, v, o);
    excl += v;
    if (inclusive) break;
  }
  if (lane == 0) store_release(state + tile, kInclusive | (unsigned long long)(excl + agg));
  return excl;
}

constexpr int kBlock = 512;            // threads a block, one tile
constexpr int kTile = kBlock * 16;      // mask rows a tile: 8192

// scratch: [0] the total (written by the last tile), [1] the tile counter,
// [2 ..] one state a tile; all zero at launch.  One block a tile of kTile
// rows of the mask's 16-byte grid: tile t covers the view's rows
// [t * kTile - head, (t + 1) * kTile - head), head = the view's offset from
// the 16-byte boundary under it.
__global__ void __launch_bounds__(kBlock)
compact_kernel(const uint8_t* __restrict__ mask, int64_t n, Planes planes, int n_planes,
               int64_t n_out, unsigned long long* __restrict__ scratch) {
  constexpr int kWarps = kBlock / 32;
  constexpr int kUnroll = 4;
  __shared__ uint16_t rows[kTile];  // the tile's hits, tile-local row numbers
  __shared__ int warp_ends[kWarps];
  __shared__ long long tile_sh, excl_sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    tile_sh = atomicAdd(reinterpret_cast<unsigned int*>(scratch + 1), 1u);
  __syncthreads();
  const long long tile = tile_sh;
  const int64_t first = tile * kTile - (int64_t)(reinterpret_cast<uintptr_t>(mask) & 15);
  uint32_t bits = mask_bits(mask, n, first + 16 * threadIdx.x);

  // block scan of the threads' hit counts
  const int hits = __popc(bits);
  int incl = hits;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullWarp, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_ends[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_ends[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullWarp, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_ends[lane] = w;
  }
  __syncthreads();
  const int agg = warp_ends[kWarps - 1];
  if (warp == 0) {
    const long long excl = look_back(scratch + 2, tile, agg);
    if (lane == 0) {
      excl_sh = excl;
      if (tile == gridDim.x - 1) scratch[0] = (unsigned long long)(excl + agg);
    }
  }
  int at = incl - hits + (warp ? warp_ends[warp - 1] : 0);
  while (bits) {
    rows[at++] = (uint16_t)(16 * threadIdx.x + __ffs(bits) - 1);
    bits &= bits - 1;
  }
  __syncthreads();

  // the tile's hits go to [excl, excl + agg), cut at n_out; the walk starts
  // on the 32-word boundary under excl, so each warp stores whole lines
  const int64_t excl = excl_sh;
  const int64_t end = excl + agg < n_out ? excl + agg : n_out;
  for (int64_t d0 = (excl & ~31ll) + threadIdx.x; d0 < end; d0 += kBlock * kUnroll) {
    uint32_t v[kUnroll][kMaxPlanes];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t d = d0 + u * kBlock;
      if (d >= excl && d < end) {
        const int64_t src = first + rows[d - excl];
        // unrolled over the fixed maximum, so the plane pointers are read
        // from the parameter space instead of a local copy of the struct
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p)
          if (p < n_planes) v[u][p] = __ldg(planes.in[p] + src);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t d = d0 + u * kBlock;
      if (d >= excl && d < end) {
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p)
          if (p < n_planes) planes.out[p][d] = v[u][p];
      }
    }
  }
}

// K6: one block a ragged block, taken from the ticket counter in
// scratch[1] in the order blocks start.  Warp 0 reads the block's count,
// clamps it to [0, block_elems], publishes it and looks back for its
// offset (K5's look_back over scratch[2 ..]); then the whole block copies
// the block's prefix of every plane to that offset (fhj::copy_planes).
__global__ void __launch_bounds__(fhj::kThreads)
concat_ragged_kernel(const void* __restrict__ counts, int count_bytes, int64_t block_elems,
                     Planes planes, int n_planes, unsigned long long* __restrict__ scratch) {
  __shared__ long long block_sh, dst_sh, count_sh;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned int ticket = 0;
    if (lane == 0) ticket = atomicAdd(reinterpret_cast<unsigned int*>(scratch + 1), 1u);
    const long long b = __shfl_sync(kFullWarp, ticket, 0);
    long long c = count_bytes == 8 ? __ldg(static_cast<const long long*>(counts) + b)
                                   : (long long)__ldg(static_cast<const int*>(counts) + b);
    c = c < 0 ? 0 : (c > block_elems ? block_elems : c);
    const long long excl = look_back(scratch + 2, b, c);
    if (lane == 0) {
      block_sh = b, dst_sh = excl, count_sh = c;
      if (b == gridDim.x - 1) scratch[0] = (unsigned long long)(excl + c);
    }
  }
  __syncthreads();
  const uint32_t* src[kMaxPlanes];
  uint32_t* dst[kMaxPlanes];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) {
    src[p] = p < n_planes ? planes.in[p] + block_sh * block_elems : nullptr;
    dst[p] = p < n_planes ? planes.out[p] + dst_sh : nullptr;
  }
  fhj::copy_planes<kMaxPlanes>(src, dst, n_planes, count_sh, 0, 1);
}

}  // namespace

extern "C" {

// Rows a K5 tile covers: the caller sizes the scratch with it.
int fhj_compact_tile_rows() { return kTile; }

// K5.  mask: n bytes (any alignment), nonzero = hit; in0..in3 / out0..out3:
// the first n_planes (1..4) are used, n words in, n_out words out (hits at
// or past n_out are dropped).  scratch: scratch_words u64 of device memory,
// at least ceil((n + 15) / tile_rows) + 2; on return scratch[0] holds the
// number of hits.  One memset and one launch on `stream`, nothing when
// n == 0.  Returns cudaGetLastError().
int fhj_compact_by_mask(const uint8_t* mask, int64_t n, int n_planes, const uint32_t* in0,
                        const uint32_t* in1, const uint32_t* in2, const uint32_t* in3,
                        uint32_t* out0, uint32_t* out1, uint32_t* out2, uint32_t* out3,
                        int64_t n_out, unsigned long long* scratch, int64_t scratch_words,
                        cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t head = (int64_t)(reinterpret_cast<uintptr_t>(mask) & 15);
  const int64_t tiles = (head + n + kTile - 1) / kTile;
  if (n_planes < 1 || n_planes > kMaxPlanes || tiles > 0x7fffffff ||
      scratch_words < tiles + 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)(tiles + 2) * sizeof(*scratch), stream);
  if (e != cudaSuccess) return (int)e;
  const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
  compact_kernel<<<(unsigned int)tiles, kBlock, 0, stream>>>(mask, n, planes, n_planes, n_out,
                                                             scratch);
  return (int)cudaGetLastError();
}

// K6.  counts: nblocks integers of count_bytes (4 or 8) each, clamped to
// [0, block_elems] in the kernel.  in0..in3: nblocks * block_elems words
// each (any 4-byte alignment), out0..out3 as long; the first n_planes
// (1..4) are used.  scratch: scratch_words u64 of device memory, at least
// nblocks + 2; on return scratch[0] holds the sum of the clamped counts.
// One memset and one launch on `stream`, nothing when
// nblocks == 0.  Returns cudaGetLastError().
int fhj_concat_ragged_blocks(const void* counts, int count_bytes, int64_t nblocks,
                             int64_t block_elems, int n_planes, const uint32_t* in0,
                             const uint32_t* in1, const uint32_t* in2, const uint32_t* in3,
                             uint32_t* out0, uint32_t* out1, uint32_t* out2, uint32_t* out3,
                             unsigned long long* scratch, int64_t scratch_words,
                             cudaStream_t stream) {
  if (nblocks <= 0) return (int)cudaSuccess;
  if (n_planes < 1 || n_planes > kMaxPlanes || nblocks > 0x7fffffff ||
      (count_bytes != 4 && count_bytes != 8) || scratch_words < nblocks + 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)(nblocks + 2) * sizeof(*scratch), stream);
  if (e != cudaSuccess) return (int)e;
  const Planes planes = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
  concat_ragged_kernel<<<(unsigned)nblocks, fhj::kThreads, 0, stream>>>(
      counts, count_bytes, block_elems, planes, n_planes, scratch);
  return (int)cudaGetLastError();
}

}  // extern "C"
