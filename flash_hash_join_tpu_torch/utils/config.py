"""Engine configuration (copy of flash_hash_join_tpu/utils/config.py, which
cannot be imported here: importing the JAX package imports jax).

The reference hard-codes its tuning constants as C++ ``constexpr``s
(RADIX_BITS=8 at hash_join.cpp:38, PROBE_BATCH_SIZE=2048 at :302,
SMALL_TABLE_THRESHOLD=500'000 at :393, RADIX_JOIN_THRESHOLD=1'000'000 at :576,
capacity growth 1.5x at :99).  Here they live in one dataclass so the adaptive
dispatcher (models/cost.py) can reason about them and tests can shrink them.
"""

from __future__ import annotations

import dataclasses


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Static tuning knobs of the join engine (same fields and defaults as
    the JAX package's JoinConfig; the global hash-table tier reads most of
    them).

    Attributes:
      group_size: slots per hash-table bucket group.
      growth: slots-per-build-row factor (load factor 1/growth).
      overflow_groups: extra groups past the power-of-two home range.
      probe_chunk: probe keys processed per pipeline step: in the port, the
        chunks of the global tier's plain walk on the CPU only; on a card
        the walk kernel takes the whole probe side in one launch.
      max_probe_iters: hard bound on the chain walk.
      bloom_k: bits set per key in the per-group bloom word.
      min_groups: floor on the home-group count.
    """

    group_size: int = 8
    growth: float = 2.0
    overflow_groups: int = 64
    probe_chunk: int = 1 << 20
    max_probe_iters: int = 256
    bloom_k: int = 3
    min_groups: int = 16

    def num_home_groups(self, n_build: int) -> int:
        """Power-of-two home-group count for a build side of n_build rows."""
        want_slots = max(int(n_build * self.growth), self.group_size)
        return max(next_pow2(-(-want_slots // self.group_size)), self.min_groups)

    def group_bits(self, n_build: int) -> int:
        return self.num_home_groups(n_build).bit_length() - 1

    def total_groups(self, n_build: int) -> int:
        return self.num_home_groups(n_build) + self.overflow_groups


DEFAULT_CONFIG = JoinConfig()
