// K8 and K9: the staged band of the dense-domain materialize.
//
// K8 replaces flash_hash_join_tpu/ops/pallas/dense_values.py:
// probe_gather_staged (kernel body _kernel): per probe domain index, the hit
// flag (the presence plane is nonzero at its slot) and the 1-2 dense value
// planes there (0 on a miss).  Planes are (v_rows <= 8192, 128) u32 words,
// slot s at word s: at most 4 MB each, 12 MB for presence plus two value
// planes.
//
// What bounds K8 on an H100: per probe a 4 B index read, 2-3 random 4 B
// reads of the planes and 5-9 B written.  The planes stay resident in the
// 50 MB L2, so the random reads are L2 sector reads and the stream of
// indices and outputs is bound by device-memory bandwidth.
//
// What the design does about it, against the TPU kernel: the TPU kernel
// block-sorts the probes (one u32 column), gives every 128-probe tile row a
// window of `sels` consecutive value rows (`rs` starts, scalar-prefetched),
// stages those rows in VMEM with dynamic-row copies and counts the probes
// that fall outside the window as unresolved; it passes the sorted indices
// through as keys.  All of that is there because Mosaic cannot address a
// row per element.  Here each thread reads its own probe's words through
// L2: no sort, no window, never unresolved, probe order kept.
//
// K9 replaces dense_values.py:materialize_copy (_copy_kernel): an identity
// copy.  In the JAX package it is an XLA:TPU fusion barrier in front of the
// staged band's consumers; PyTorch runs eagerly and fuses nothing, so here
// it is a plain copy of the probe indices that K8 then reads.  Bound by
// bandwidth: 8 B per element moved.  A grid of the card's size (SMs x
// occupancy) looping over the copy ran slower than torch's clone on an
// H100, with one 16-byte load a step or four; a grid that covers the copy,
// one step a thread, ran 1-2 % faster than clone when launched alone, and
// at clone's speed through the Python wrapper (PERF.md §6).  So each thread
// moves kCopyUnroll 16-byte words, all loads before the stores, and the
// grid has one block per kCopyUnroll * 256 of them.  The loads and stores
// are streaming (__ldcs / __stcs, evict-first), so the copy does not push
// K8's value planes, which K8 reads from L2 right after, out of the cache.
// Scalar head and tail for views that start off a 16-byte boundary or end
// ragged.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(fhj::kThreads)
staged_gather_kernel(const uint32_t* __restrict__ presence,
                     const uint32_t* __restrict__ p0, const uint32_t* __restrict__ p1,
                     uint32_t v_slots, const uint32_t* __restrict__ idx, int64_t n,
                     uint8_t* __restrict__ hit, uint32_t* __restrict__ o0,
                     uint32_t* __restrict__ o1) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t v = __ldg(idx + i);
    const bool h = v < v_slots && __ldg(presence + v) != 0u;
    hit[i] = h;
    o0[i] = h ? __ldg(p0 + v) : 0u;
    if (p1) o1[i] = h ? __ldg(p1 + v) : 0u;
  }
}

constexpr int kCopyUnroll = 4;

// dst[i] = src[i] for i < n.  The first `head` words bring dst to a 16-byte
// boundary; kAligned: src + head lies on one as well, and is read with
// vector loads too.  A thread moves the 16-byte words base + k * blockDim.x,
// k < kCopyUnroll (coalesced across the warp for every k), and again a grid
// further on while any are left.
template <bool kAligned>
__global__ void __launch_bounds__(fhj::kThreads)
copy_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int64_t n,
            int64_t head) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)kCopyUnroll * blockDim.x;
  const int64_t stride = step * gridDim.x;
  const int64_t n4 = (n - head) >> 2;
  const uint32_t* s = src + head;
  uint4* d = reinterpret_cast<uint4*>(dst + head);
  for (int64_t base = (int64_t)blockIdx.x * step + threadIdx.x; base < n4;
       base += stride) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const int64_t i = base + (int64_t)k * blockDim.x;
      if (i < n4) {
        if (kAligned) {
          v[k] = __ldcs(reinterpret_cast<const uint4*>(s) + i);
        } else {
          const uint32_t* q = s + 4 * i;
          v[k] = make_uint4(__ldcs(q), __ldcs(q + 1), __ldcs(q + 2), __ldcs(q + 3));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const int64_t i = base + (int64_t)k * blockDim.x;
      if (i < n4) __stcs(d + i, v[k]);
    }
  }
  const int64_t tail = head + (n4 << 2);
  if (tid < head) dst[tid] = src[tid];
  if (tid < n - tail) dst[tail + tid] = src[tail + tid];
}

}  // namespace

extern "C" {

// presence, p0 and p1 (p1 may be null): v_rows * 128 words each.  Writes
// hit[i], o0[i] and (with p1) o1[i] for every i < n on `stream` (no launch
// when n == 0).  Returns cudaGetLastError().
int fhj_staged_gather(const uint32_t* presence, const uint32_t* p0, const uint32_t* p1,
                      int v_rows, const uint32_t* idx, int64_t n, uint8_t* hit,
                      uint32_t* o0, uint32_t* o1, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  int grid = 0;
  cudaError_t e = fhj::grid_for(staged_gather_kernel, n, 0, &grid, 1);
  if (e != cudaSuccess) return (int)e;
  staged_gather_kernel<<<grid, fhj::kThreads, 0, stream>>>(
      presence, p0, p1, (uint32_t)v_rows * 128u, idx, n, hit, o0, o1);
  return (int)cudaGetLastError();
}

// Copies src[0, n) to dst[0, n) (both 4-byte aligned, not overlapping) on
// `stream` (no launch when n == 0).  Returns cudaGetLastError().
int fhj_materialize_copy(const uint32_t* src, uint32_t* dst, int64_t n,
                         cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t per_block = 4LL * kCopyUnroll * fhj::kThreads;   // words
  const int64_t grid = std::min<int64_t>((n + per_block - 1) / per_block, INT_MAX);
  const int64_t head =
      std::min<int64_t>(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2, n);
  if ((reinterpret_cast<uintptr_t>(src + head) & 15) == 0)
    copy_kernel<true><<<(unsigned)grid, fhj::kThreads, 0, stream>>>(src, dst, n, head);
  else
    copy_kernel<false><<<(unsigned)grid, fhj::kThreads, 0, stream>>>(src, dst, n, head);
  return (int)cudaGetLastError();
}

}  // extern "C"
