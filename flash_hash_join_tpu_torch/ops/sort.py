"""Radix-sort and radix-partition primitives over u64 (hi, lo) columns
(port of flash_hash_join_tpu/ops/sort.py; plain PyTorch, as the JAX
package leaves them to XLA's sort).

Key planes are int32 bit patterns (utils/u64.py).  A u64 key is ordered as
one int64, utils/u64.sortable, never as a signed sort of its raw bits.
Both sorts are stable: where the JAX partition's unstable sort leaves the
rows of a partition in any order, here they keep their input order (the
same multiset per partition).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.hashing import hash_u64
from flash_hash_join_tpu_torch.utils.u64 import MASK32, sortable


def sort_u64(kh: torch.Tensor, kl: torch.Tensor, *payloads: torch.Tensor):
    """Sort rows ascending by u64 key, stably; payload columns move with
    the keys.  Returns (kh, kl, *payloads) sorted."""
    order = torch.sort(sortable(kh, kl), stable=True).indices
    return (kh[order], kl[order], *(p[order] for p in payloads))


class PartitionResult(NamedTuple):
    pid: torch.Tensor       # (n,) int64 partition id of each (sorted) row
    offsets: torch.Tensor   # (2^pbits + 1,) int64 exclusive offsets
    cols: tuple             # the columns, partition-contiguous


def radix_partition_by_hash(cols: tuple, kh: torch.Tensor, kl: torch.Tensor,
                            *, pbits: int, pre_shift: int = 0
                            ) -> PartitionResult:
    """Partition rows by the top pbits of their key hash (after dropping
    its top pre_shift bits): the same bit slice of ops/hashing.hash_u64
    that picks a row's device in the distributed tier and its home group
    in the global table, so they refine each other."""
    if not 1 <= pbits <= 32:
        raise ValueError(f"pbits must be in [1, 32], got {pbits}")
    h = (hash_u64(kh, kl) << pre_shift) & MASK32
    pid = h >> (32 - pbits)
    pid_s, order = torch.sort(pid, stable=True)
    counts = torch.bincount(pid, minlength=1 << pbits)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return PartitionResult(pid_s, offsets, tuple(c[order] for c in cols))
