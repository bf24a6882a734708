"""Predicate filter and stream compaction of columns (port of
flash_hash_join_tpu/ops/filter.py).

The predicates compare u64 keys held as int32 bit-pattern (hi, lo) planes
(utils/u64.py) with a constant (chi, clo), as unsigned: each builds the
key's utils/u64.sortable int64 once and compares it with the constant's.
filter_columns keeps the JAX contract, columns at the input length with
the selected rows first, in input order, and zeros after them; the port's
columns are int32 planes, and go through ops/compact.compact_by_mask (K5
on a card).
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.cuda.stream_compact import MAX_PLANES
from flash_hash_join_tpu_torch.utils.u64 import sortable


def _key(chi: int, clo: int) -> int:
    """The sortable int64 of the u64 constant (chi, clo)."""
    return ((chi << 32) | clo) - 2**63


def eq_u64(kh, kl, chi: int, clo: int):
    return sortable(kh, kl) == _key(chi, clo)


def lt_u64(kh, kl, chi: int, clo: int):
    return sortable(kh, kl) < _key(chi, clo)


def gt_u64(kh, kl, chi: int, clo: int):
    return sortable(kh, kl) > _key(chi, clo)


def le_u64(kh, kl, chi: int, clo: int):
    return sortable(kh, kl) <= _key(chi, clo)


def ge_u64(kh, kl, chi: int, clo: int):
    return sortable(kh, kl) >= _key(chi, clo)


def between_u64(kh, kl, lo_const: tuple[int, int],
                hi_const: tuple[int, int]):
    """lo_const <= key <= hi_const, each bound a (hi, lo) pair."""
    key = sortable(kh, kl)
    return (key >= _key(*lo_const)) & (key <= _key(*hi_const))


def filter_columns(mask: torch.Tensor, *cols: torch.Tensor):
    """Compact the rows where mask is True to the front of each column.

    cols: int32 planes (u32 bit patterns, or any int32 column) of the
    mask's length.  Returns (count, *compacted): count a 0-d int64 tensor;
    each column at the input length, its first count rows the selected
    rows in input order, zeros after them.  The planes are compacted
    MAX_PLANES at a time by compact_by_mask."""
    if any(c.dtype != torch.int32 for c in cols):
        raise ValueError("filter_columns takes int32 planes (utils/u64.py)")
    if not cols:
        return (mask.sum(),)
    outs = []
    for at in range(0, len(cols), MAX_PLANES):
        count, packed = compact_by_mask(mask, cols[at:at + MAX_PLANES])
        outs += packed
    tail = torch.arange(mask.shape[0], device=mask.device) >= count
    return (count, *(p.masked_fill_(tail, 0) for p in outs))
