// The domain build that K1 (dense_bitmap.cu) and K2 (bitmap_probe.cu)
// share: the lo min and the bitmap build over the build key planes.  The
// two differ in lo only: K1's is the least low word of the zero-hi-word
// rows, K2's (the JAX scan band's) that of every valid row.
#pragma once

#include "common.cuh"

namespace fhj {

// Internal linkage: each source that includes this header launches its own
// copy.
namespace {

// *lo = min(*lo, the low words of the keys): every key when kEveryRow (the
// scan band's lo, K2), else the keys whose high word is 0 (K1's).
template <bool kEveryRow>
__global__ void __launch_bounds__(kThreads)
domain_lo_kernel(const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl,
                 int64_t n, uint32_t* __restrict__ lo) {
  uint32_t m = 0xFFFFFFFFu;
  for_each_pair(kh, kl, n, [&](uint32_t h, uint32_t l) {
    if ((kEveryRow || h == 0u) && l < m) m = l;
  });
  m = block_min(m);
  if (threadIdx.x == 0 && m != 0xFFFFFFFFu) atomicMin(lo, m);
}

// Sets the bit of every key in the domain of n_bits slots from *lo; counts
// the others into *n_bad.
__global__ void __launch_bounds__(kThreads)
domain_build_kernel(const uint32_t* __restrict__ kh, const uint32_t* __restrict__ kl,
                    int64_t n, const uint32_t* __restrict__ lo, uint32_t n_bits,
                    uint32_t* __restrict__ bitmap,
                    unsigned long long* __restrict__ n_bad) {
  const uint32_t base = __ldg(lo);
  unsigned int bad = 0;
  for_each_pair(kh, kl, n, [&](uint32_t h, uint32_t l) {
    uint32_t v;
    if (in_domain(h, l, base, n_bits, &v))
      atomicOr(bitmap + (v >> 5), 1u << (v & 31u));
    else
      ++bad;
  });
  const unsigned long long total = block_sum(bad);
  if (threadIdx.x == 0 && total) atomicAdd(n_bad, total);
}

// scratch: three u64 words {count, n_bad, lo}; bitmap: n_bits / 32 words.
// On `stream`: zeroes count and n_bad and sets lo = 0xFFFFFFFF; over a
// nonempty build (kh/kl rows [0, nb)) also zeroes the bitmap and launches
// the lo min and the build.  Returns the first error.
inline cudaError_t domain_build(const uint32_t* kh, const uint32_t* kl, int64_t nb,
                                bool every_row, uint32_t* bitmap, uint32_t n_bits,
                                unsigned long long* scratch, cudaStream_t stream) {
  uint32_t* lo = reinterpret_cast<uint32_t*>(scratch + 2);
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned long long), stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(lo, 0xFF, sizeof(uint32_t), stream);
  if (e != cudaSuccess || nb <= 0) return e;
  e = cudaMemsetAsync(bitmap, 0, (size_t)(n_bits / 32) * sizeof(uint32_t), stream);
  if (e != cudaSuccess) return e;
  e = every_row ? launch(domain_lo_kernel<true>, nb, stream, kh, kl, nb, lo)
                : launch(domain_lo_kernel<false>, nb, stream, kh, kl, nb, lo);
  if (e != cudaSuccess) return e;
  return launch(domain_build_kernel, nb, stream, kh, kl, nb, (const uint32_t*)lo,
                n_bits, bitmap, scratch + 1);
}

}  // namespace

}  // namespace fhj
