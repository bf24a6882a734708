// The `global` tier's hashing, shared by its walk (hash_walk.cu) and its
// build (hash_build.cu): bit for bit ops/hashing.py and
// ops/hash_table.home_group, so that a table the build kernel writes is the
// table the walk kernel and the plain walk search.
#pragma once

#include <cstdint>

namespace fhj {

// murmur3's 32-bit finalizer and the two-word hash of ops/hashing.py.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_u64(uint32_t hi, uint32_t lo) {
  return fmix32(fmix32(lo) ^ (hi * 0x9E3779B9u));
}

// ops/hashing.py:bloom_word: bit (g >> 5i) & 31 for i < k, g a secondary
// mix of h.  The plain version shifts an int64 below 2^32, so a shift of 32
// or more gives 0: bit 0.
__device__ __forceinline__ uint32_t bloom_word(uint32_t h, int k) {
  const uint32_t g = h * 0x9E3779B9u + 1u;
  uint32_t word = 0;
  for (int i = 0; i < k; ++i) {
    const int s = 5 * i;
    word |= 1u << (s < 32 ? (g >> s) & 31u : 0u);
  }
  return word;
}

// ops/hash_table.home_group: the top gbits of h after discarding its top
// pre_shift bits (0 <= gbits, pre_shift <= 32).
__device__ __forceinline__ int64_t home_group(uint32_t h, int gbits, int pre_shift) {
  return (int64_t)((((unsigned long long)h << pre_shift) & 0xFFFFFFFFull) >> (32 - gbits));
}

}  // namespace fhj
