"""Hashing of u64 keys held as (hi, lo) u32 planes (port of
flash_hash_join_tpu/ops/hashing.py; bit-identical outputs).

murmur3's 32-bit finalizer over the two halves.  Inputs are u32 planes in
either device form (int32 bit patterns or widened int64, utils/u64.py);
outputs are widened int64 in [0, 2^32).

A u32 x u32 product does not fit signed int64, so each multiply is two
16-bit partial products, each masked to 32 bits (`_mul32`): nothing relies
on signed overflow wrapping.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.utils.u64 import MASK32, widen

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN_INT = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and a u32 constant c."""
    lo = h * (c & 0xFFFF)                          # < 2^48
    hi = ((h * (c >> 16)) & 0xFFFF) << 16          # < 2^32
    return (lo + hi) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (public-domain constants)."""
    h = widen(h)
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    h = h ^ (h >> 16)
    return h


def hash_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit hash of a u64 (hi, lo) pair with good top-bit avalanche."""
    h = fmix32(lo)
    return fmix32(h ^ _mul32(widen(hi), _GOLDEN_INT))


def bloom_word(h: torch.Tensor, k: int) -> torch.Tensor:
    """Per-key bloom signature: k bits set in a 32-bit word, from a
    secondary mix of the hash h."""
    g = (_mul32(widen(h), _GOLDEN_INT) + 1) & MASK32
    word = torch.zeros_like(g)
    for i in range(k):
        word |= 1 << ((g >> (5 * i)) & 31)
    return word
