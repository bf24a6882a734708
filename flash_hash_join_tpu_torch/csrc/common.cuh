// Shared device helpers: the index stream walk, the key-plane pair walk,
// the dense-domain test, the membership bit test and the shared-memory
// staging of the bitmap kernels (dense_bitmap.cu, bitmap_probe.cu,
// dense_values.cu), the copy loop of K9 and K6 (dense_values.cu,
// stream_compact.cu), the block reductions, the grid size of every kernel
// and a launch over n rows.
//
// Domain indices are u32 with sentinel 0xFFFFFFFF (torch int32 bit
// patterns on the Python side).  Bitmap word w holds slots [32w, 32w+32);
// for the (d_rows, 128) layout of the TPU kernels this is row w >> 7,
// lane w & 127.  An index is a member when it is below n_bits and its bit
// is set, so the sentinel and any out-of-domain index count nothing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fhj {

constexpr int kThreads = 256;

// Calls visit(v) for every element of idx[0, n), spread over the whole
// grid: 16-byte (uint4) loads over the aligned body, scalar loads for the
// at most 3 + 3 elements of the unaligned head and the ragged tail.
template <typename Visit>
__device__ __forceinline__ void for_each_index(const uint32_t* __restrict__ idx,
                                               int64_t n, Visit visit) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t head = (int64_t)((16 - (reinterpret_cast<uintptr_t>(idx) & 15)) & 15) >> 2;
  if (head > n) head = n;
  const int64_t n4 = (n - head) >> 2;
  const uint4* body = reinterpret_cast<const uint4*>(idx + head);
  for (int64_t i = tid; i < n4; i += stride) {
    const uint4 q = __ldg(body + i);
    visit(q.x);
    visit(q.y);
    visit(q.z);
    visit(q.w);
  }
  const int64_t tail = head + (n4 << 2);
  if (tid < head) visit(idx[tid]);
  if (tid < n - tail) visit(idx[tail + tid]);
}

// Calls visit(i, h, l) for every i < n with h = hi[i], l = lo[i]: the two
// u32 planes of a u64 key column, walked like for_each_index.  The body is
// aligned on hi; lo is read with 16-byte loads too when it then lies on a
// 16-byte boundary, else with four scalar loads (the choice is the same
// for the whole grid).  A thread visits the rows of a 16-byte body word in
// order, i to i + 3.
template <typename Visit>
__device__ __forceinline__ void for_each_pair_at(const uint32_t* __restrict__ hi,
                                                 const uint32_t* __restrict__ lo,
                                                 int64_t n, Visit visit) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t head = (int64_t)((16 - (reinterpret_cast<uintptr_t>(hi) & 15)) & 15) >> 2;
  if (head > n) head = n;
  const int64_t n4 = (n - head) >> 2;
  const uint4* h4 = reinterpret_cast<const uint4*>(hi + head);
  const uint32_t* l1 = lo + head;
  if ((reinterpret_cast<uintptr_t>(l1) & 15) == 0) {
    const uint4* l4 = reinterpret_cast<const uint4*>(l1);
    for (int64_t i = tid; i < n4; i += stride) {
      const uint4 h = __ldg(h4 + i);
      const uint4 l = __ldg(l4 + i);
      const int64_t r = head + 4 * i;
      visit(r, h.x, l.x);
      visit(r + 1, h.y, l.y);
      visit(r + 2, h.z, l.z);
      visit(r + 3, h.w, l.w);
    }
  } else {
    for (int64_t i = tid; i < n4; i += stride) {
      const uint4 h = __ldg(h4 + i);
      const uint32_t* l = l1 + 4 * i;
      const int64_t r = head + 4 * i;
      visit(r, h.x, __ldg(l));
      visit(r + 1, h.y, __ldg(l + 1));
      visit(r + 2, h.z, __ldg(l + 2));
      visit(r + 3, h.w, __ldg(l + 3));
    }
  }
  const int64_t tail = head + (n4 << 2);
  if (tid < head) visit(tid, hi[tid], lo[tid]);
  if (tid < n - tail) visit(tail + tid, hi[tail + tid], lo[tail + tid]);
}

// for_each_pair_at for a visitor that needs no row index: visit(h, l).
template <typename Visit>
__device__ __forceinline__ void for_each_pair(const uint32_t* __restrict__ hi,
                                              const uint32_t* __restrict__ lo,
                                              int64_t n, Visit visit) {
  for_each_pair_at(hi, lo, n, [&](int64_t, uint32_t h, uint32_t l) { visit(h, l); });
}

// The dense-domain test of a u64 key (hi, lo) against a domain of n_bits
// slots from `base`: *idx = (lo - base) mod 2^32, and the key is in the
// domain when hi == 0 and *idx < n_bits.  Keys below base wrap to huge
// indices and fall outside, so a probe below the domain misses and a build
// row below it is bad.  The u32 twin of the int64 mapping of the plain
// paths (ops/cuda/dense_bitmap.py: build_domain_idx / probe_domain_idx).
__device__ __forceinline__ bool in_domain(uint32_t hi, uint32_t lo, uint32_t base,
                                          uint32_t n_bits, uint32_t* idx) {
  *idx = lo - base;
  return hi == 0u && *idx < n_bits;
}

__device__ __forceinline__ unsigned int bit_of(uint32_t word, uint32_t v) {
  return (word >> (v & 31u)) & 1u;
}

// Copies n32 words (a multiple of 4, both sides 16-byte aligned) into the
// block's shared memory at dst, 16 bytes a thread a step.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* __restrict__ src,
                                      int n32) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n32 / 4; i += blockDim.x) d[i] = __ldg(s + i);
}

constexpr int kCopyUnroll = 4;

// Quad i (i < n4) of the words at s, whose 16-byte offset is `shift`
// words: one 16-byte load where s is aligned, else four scalar loads that
// the coalescer merges.  (Realigning aligned 16-byte loads with warp
// shuffles took 140-198 registers a thread and ran twice as long in K6 on
// an H100: PERF.md.)
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ s, int shift,
                                           int64_t i) {
  if (shift == 0) return __ldcs(reinterpret_cast<const uint4*>(s) + i);
  const uint32_t* w = s + 4 * i;
  return make_uint4(__ldcs(w), __ldcs(w + 1), __ldcs(w + 2), __ldcs(w + 3));
}

// The copy loop of K9 and K6: src[p][0, n) to dst[p][0, n) for each plane
// p < n_planes (at most kPlanes; no overlap), shared by `groups` blocks of
// which the caller's is number `group` (K9: the grid; K6: one block
// alone).  Each plane's words up to its destination's first 16-byte
// boundary (at most 3) and its ragged tail are scalar; the rest goes out
// as whole 16-byte words (streaming, __stcs).  A thread moves the 16-byte
// words base + k * blockDim.x, k < kCopyUnroll, of every plane in one
// pass, all loads before the stores (n_planes * kCopyUnroll loads in
// flight), then again `groups` blocks further on while any are left.
template <int kPlanes>
__device__ __forceinline__ void copy_planes(const uint32_t* const (&src)[kPlanes],
                                            uint32_t* const (&dst)[kPlanes], int n_planes,
                                            int64_t n, int64_t group, int64_t groups) {
  int64_t head[kPlanes], n4[kPlanes], n4_max = 0;
  int shift[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    head[p] = n4[p] = shift[p] = 0;
    if (p < n_planes) {
      const int64_t h = (int64_t)((16 - (reinterpret_cast<uintptr_t>(dst[p]) & 15)) & 15) >> 2;
      head[p] = h < n ? h : n;
      n4[p] = (n - head[p]) >> 2;
      shift[p] = (int)((reinterpret_cast<uintptr_t>(src[p] + head[p]) & 15) >> 2);
      n4_max = n4[p] > n4_max ? n4[p] : n4_max;
    }
  }
  const int64_t step = (int64_t)kCopyUnroll * blockDim.x;
  for (int64_t base = group * step + threadIdx.x; base < n4_max; base += step * groups) {
    uint4 v[kPlanes][kCopyUnroll];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      if (p < n_planes) {
#pragma unroll
        for (int k = 0; k < kCopyUnroll; ++k) {
          const int64_t i = base + (int64_t)k * blockDim.x;
          if (i < n4[p]) v[p][k] = load_quad(src[p] + head[p], shift[p], i);
        }
      }
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      if (p < n_planes) {
        uint4* d = reinterpret_cast<uint4*>(dst[p] + head[p]);
#pragma unroll
        for (int k = 0; k < kCopyUnroll; ++k) {
          const int64_t i = base + (int64_t)k * blockDim.x;
          if (i < n4[p]) __stcs(d + i, v[p][k]);
        }
      }
  }
  const int64_t t = group * blockDim.x + threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p)
    if (p < n_planes) {
      const int64_t tail = head[p] + (n4[p] << 2);
      if (t < head[p]) dst[p][t] = src[p][t];
      if (t < n - tail) dst[p][tail + t] = src[p][tail + t];
    }
}

// Minimum of v over the block, valid in thread 0.  blockDim.x == kThreads.
__device__ __forceinline__ uint32_t block_min(uint32_t v) {
  __shared__ uint32_t warp_mins[kThreads / 32];
  v = __reduce_min_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_mins[warp] = v;
  __syncthreads();
  v = 0xFFFFFFFFu;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_mins[lane] : 0xFFFFFFFFu;
    v = __reduce_min_sync(0xffffffffu, v);
  }
  return v;
}

// Sum of v over the block, valid in thread 0.  blockDim.x == kBlock, at
// most 1024.
template <int kBlock = kThreads>
__device__ __forceinline__ unsigned long long block_sum(unsigned long long v) {
  __shared__ unsigned long long warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Blocks of `threads` for a grid-stride kernel over n elements
// (`per_thread` per thread per step): enough to cover n, at most what fits
// on the card at once.
template <typename Kernel>
inline cudaError_t grid_for(Kernel kernel, int64_t n, size_t smem, int* grid,
                            int per_thread = 4, int threads = kThreads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const int64_t need = ((n + per_thread - 1) / per_thread + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < 1 ? 1 : (need < cap ? need : cap));
  return cudaSuccess;
}

// Launches a grid-stride kernel over n rows (grid_for's grid, no dynamic
// shared memory) on `stream`; returns cudaGetLastError().
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int64_t n, cudaStream_t stream, Args... args) {
  int grid = 0;
  cudaError_t e = grid_for(kernel, n, 0, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace fhj
