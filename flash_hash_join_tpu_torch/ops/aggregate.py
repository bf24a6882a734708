"""Hash aggregate (group-by) over u64 keys (port of
flash_hash_join_tpu/ops/aggregate.py; plain PyTorch, as the JAX package
leaves it to XLA).

The same spine as the global table's build (ops/hash_table.py): hash,
sort the rows stably by (home, key), cut them into runs of equal (home,
key).  Each run's exact reductions then come from one scatter a quantity
instead of the JAX package's segmented doubling scans: the u64 sum from
the sums of the hi and lo words (each below 2^63 for fewer than 2^31
rows) and the carry between them, min and max over utils/u64.sortable.
Groups come out in (home, key) order, as in the JAX package, so every
output array equals its JAX counterpart element for element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.hash_table import sort_rows
from flash_hash_join_tpu_torch.ops.hashing import hash_u64
from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen


class GroupByResult(NamedTuple):
    """Per group, the first n_groups rows of each (n,) column; zeros past
    them.  Key, sum, min and max planes are int32 bit patterns."""

    n_groups: torch.Tensor  # () int32
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    count: torch.Tensor     # (n,) int32 rows a group
    sum_hi: torch.Tensor    # exact u64 sum (mod 2**64)
    sum_lo: torch.Tensor
    min_hi: torch.Tensor
    min_lo: torch.Tensor
    max_hi: torch.Tensor
    max_lo: torch.Tensor


def hash_aggregate(kh: torch.Tensor, kl: torch.Tensor, vh: torch.Tensor,
                   vl: torch.Tensor, n_valid: int, *,
                   gbits: int = 20) -> GroupByResult:
    """Group the first n_valid rows by u64 key (int32 bit-pattern planes);
    count, sum, min and max of their u64 values.  Exact: the sum is
    modular u64, min and max are unsigned."""
    n, dev = kh.shape[0], kh.device
    valid = torch.arange(n, device=dev) < n_valid
    kw, lw = widen(kh), widen(kl)
    # invalid rows get home 0xFFFFFFFF, past every valid home, so they sort
    # last; boundaries include home, so the invalid tail starts a run of
    # its own even when its first key equals the last valid group's
    home = torch.where(valid, hash_u64(kw, lw) >> (32 - gbits), MASK32)
    order = sort_rows(home, kw, lw)
    home_s, kh_s, kl_s = home[order], kw[order], lw[order]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = ((home_s[1:] != home_s[:-1]) | (kh_s[1:] != kh_s[:-1])
               | (kl_s[1:] != kl_s[:-1]))
    seg = torch.cumsum(new, 0) - 1
    # valid rows sort first, so the valid groups are the first runs
    n_groups = (new & valid[order]).sum()
    emit = torch.arange(n, device=dev) < n_groups

    def per_group(x: torch.Tensor, reduce: str) -> torch.Tensor:
        if reduce == "sum":
            out = torch.zeros(n, dtype=x.dtype, device=dev)
            out.index_add_(0, seg, x)
        else:
            out = torch.zeros(n, dtype=x.dtype, device=dev).scatter_reduce_(
                0, seg, x, reduce, include_self=False)
        return torch.where(emit, out, 0)

    vh_s, vl_s = widen(vh)[order], widen(vl)[order]
    lo_sum = per_group(vl_s, "sum")
    hi_sum = per_group(vh_s, "sum") + (lo_sum >> 32)
    value = (vh_s - 2**31) * 2**32 + vl_s         # signed order == u64 order
    vmin, vmax = per_group(value, "amin"), per_group(value, "amax")

    def planes(x: torch.Tensor):
        """sortable int64 -> (hi, lo) int32 planes, zero past n_groups."""
        return (narrow(torch.where(emit, (x >> 32) + 2**31, 0)),
                narrow(torch.where(emit, x & MASK32, 0)))

    def key(x: torch.Tensor) -> torch.Tensor:
        """A run's key word: every row of the run holds the same."""
        out = torch.zeros(n, dtype=x.dtype, device=dev).scatter_(0, seg, x)
        return narrow(torch.where(emit, out, 0))

    return GroupByResult(
        n_groups=n_groups.to(torch.int32), key_hi=key(kh_s), key_lo=key(kl_s),
        count=per_group(torch.ones(n, dtype=torch.int32, device=dev), "sum"),
        sum_hi=narrow(hi_sum & MASK32), sum_lo=narrow(lo_sum & MASK32),
        min_hi=planes(vmin)[0], min_lo=planes(vmin)[1],
        max_hi=planes(vmax)[0], max_lo=planes(vmax)[1])
