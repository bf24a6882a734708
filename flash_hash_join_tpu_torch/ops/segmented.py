"""Segmented scans over sorted runs (port of
flash_hash_join_tpu/ops/segmented.py).

Rows arrive sorted by segment id; a Hillis-Steele doubling scan with a
segment-aware combiner folds each run (ceil(log2 n) rounds of shift +
masked combine), and the last element of each run is the segment's
reduction.  `values` is a tuple of equal-length tensors.

u64 helpers work on (hi, lo) pairs of widened int64 u32 values
(utils/u64.py), with explicit carry.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.utils.u64 import MASK32


def seg_ends(seg_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the last element of each run of equal seg_ids."""
    last = torch.ones(1, dtype=torch.bool, device=seg_ids.device)
    return torch.cat([seg_ids[1:] != seg_ids[:-1], last])


def seg_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the first element of each run of equal seg_ids."""
    first = torch.ones(1, dtype=torch.bool, device=seg_ids.device)
    return torch.cat([first, seg_ids[1:] != seg_ids[:-1]])


def _shift_right(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    pad = torch.full((d,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[:-d]])


def segmented_scan(combine, values: tuple, seg_ids: torch.Tensor) -> tuple:
    """Inclusive scan of `values` with `combine(prev, cur)`, restarting at
    each new run of seg_ids.  Returns the scanned tuple."""
    n = seg_ids.shape[0]
    values = tuple(values)
    if n == 0:
        return values
    fill = -1 if seg_ids.is_signed() else torch.iinfo(seg_ids.dtype).max
    d = 1
    while d < n:
        same = _shift_right(seg_ids, d, fill) == seg_ids
        prev = tuple(_shift_right(v, d, 0) for v in values)
        merged = combine(prev, values)
        values = tuple(torch.where(same, m, v)
                       for m, v in zip(merged, values))
        d *= 2
    return values


def cummax(x: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Inclusive running maximum of a 1-D integer tensor.  torch.cummax
    scans a 1-D CUDA tensor in one thread block (0.3 s at 1e8 int64 on an
    H100), so this scans rows of `block` elements in parallel and then
    carries each row's running maximum into the rows after it."""
    n = x.numel()
    if n <= block:
        return torch.cummax(x, 0).values
    fill = x.new_full((-n % block,), torch.iinfo(x.dtype).min)
    rows = torch.cummax(torch.cat([x, fill]).view(-1, block), 1).values
    carry = torch.cummax(rows[:, -1], 0).values
    rows[1:] = torch.maximum(rows[1:], carry[:-1, None])
    return rows.view(-1)[:n]


def add_u64(a, b):
    """(hi, lo) + (hi, lo) mod 2**64 with carry."""
    ahi, alo = a
    bhi, blo = b
    lo = (alo + blo) & MASK32
    carry = (lo < blo).to(ahi.dtype)
    return (ahi + bhi + carry) & MASK32, lo


def min_u64(a, b):
    ahi, alo = a
    bhi, blo = b
    a_lt = (ahi < bhi) | ((ahi == bhi) & (alo < blo))
    return torch.where(a_lt, ahi, bhi), torch.where(a_lt, alo, blo)


def max_u64(a, b):
    ahi, alo = a
    bhi, blo = b
    a_gt = (ahi > bhi) | ((ahi == bhi) & (alo > blo))
    return torch.where(a_gt, ahi, bhi), torch.where(a_gt, alo, blo)
