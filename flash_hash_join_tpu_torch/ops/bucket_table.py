"""The `vmem` tier: a bucket hash table probed by K10 / K11 (port of
flash_hash_join_tpu/ops/bucket_table.py).

Layout: (R, 128) int32 planes — 128 buckets (columns), R slots per bucket
(rows).  bucket(key) = top 7 hash bits after pre_shift; a key's slot is its
rank among its bucket's kept keys, from the sort by (bucket, key) and the
dedup of ops/hash_table.py, so each column is ascending by u64 key with
the empty (u64-max) slots after its keys.  A bucket with more than R kept
keys keeps its first R and counts the rest in special[3]; the caller then
reruns on `merge`, so results stay exact.

The JAX package pads the probes into (M, 128) tiles and precomputes their
bucket plane before its kernel (_prep_probe): TPU layout, not ported.  K10
and K11 hash the unpadded probe planes in-kernel; `probe_buckets`
(ops/cuda/bucket_probe.py) is the same bucket in plain torch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops import hash_table as ht
from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bp
from flash_hash_join_tpu_torch.ops.segmented import cummax
from flash_hash_join_tpu_torch.utils.config import next_pow2
from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen

LANES = bp.LANES
BUCKET_BITS = bp.BUCKET_BITS
MAX_R_SLOTS = bp.MAX_R_SLOTS     # 64K slots
# Largest build side the tier is sized for (r_slots_for stays <= MAX).
MAX_BUILD_ROWS = 40_000


def r_slots_for(n_build: int) -> int:
    """Slots per bucket for n_build keys over 128 buckets: the Poisson
    mean plus 8 standard deviations plus 8, a power of two in [8, 512]."""
    lam = max(n_build, 1) / LANES
    want = int(lam + 8.0 * lam ** 0.5 + 8.0)
    return min(max(next_pow2(want), 8), MAX_R_SLOTS)


class BucketTable(NamedTuple):
    """tk_hi, tk_lo: (R, 128) int32 key planes; tv_hi, tv_lo: (R, 128)
    value planes, or (1, 128) zeros without values; special: (4,) int64
    [has_max, max_val_hi, max_val_lo, n_dropped]."""

    tk_hi: torch.Tensor
    tk_lo: torch.Tensor
    tv_hi: torch.Tensor
    tv_lo: torch.Tensor
    special: torch.Tensor


def build_bucket_table(kh, kl, vh, vl, n_valid: int, *, r_slots: int,
                       with_values: bool, pre_shift: int = 0) -> BucketTable:
    """Build the table from the first n_valid rows of the key and value
    planes (int32 bit patterns or widened)."""
    n, dev = kh.shape[0], kh.device
    R = r_slots
    row_valid = torch.arange(n, device=dev) < n_valid
    kh = torch.where(row_valid, widen(kh), MASK32)
    kl = torch.where(row_valid, widen(kl), MASK32)
    vh, vl = widen(vh), widen(vl)
    has_max, max_vh, max_vl = ht.max_key_special(kh, kl, vh, vl, row_valid)

    bucket = bp.probe_buckets(kh, kl, pre_shift)
    order = ht.sort_rows(bucket, kh, kl)
    b_s, kh_s, kl_s = bucket[order], kh[order], kl[order]

    first_occ = torch.ones(n, dtype=torch.bool, device=dev)
    first_occ[1:] = (kh_s[1:] != kh_s[:-1]) | (kl_s[1:] != kl_s[:-1])
    keep = first_occ & ~((kh_s == MASK32) & (kl_s == MASK32))

    # rank of a kept row among its bucket's kept rows
    excl = torch.cumsum(keep, 0) - keep.to(torch.int64)
    b_start = torch.ones(n, dtype=torch.bool, device=dev)
    b_start[1:] = b_s[1:] != b_s[:-1]
    rank = excl - cummax(torch.where(b_start, excl, -1))
    place = keep & (rank < R)
    n_dropped = (keep & ~place).sum()
    slot = (rank * LANES + b_s)[place]              # slot-major (R, 128)

    def scatter(vals, fill):
        flat = torch.full((R * LANES,), fill, dtype=torch.int32, device=dev)
        flat[slot] = narrow(vals[place])
        return flat.view(R, LANES)

    tk_hi, tk_lo = scatter(kh_s, -1), scatter(kl_s, -1)
    if with_values:
        tv_hi, tv_lo = scatter(vh[order], 0), scatter(vl[order], 0)
    else:
        tv_hi = tv_lo = torch.zeros((1, LANES), dtype=torch.int32, device=dev)
    special = torch.stack([has_max, max_vh, max_vl, n_dropped])
    return BucketTable(tk_hi, tk_lo, tv_hi, tv_lo, special)


def _probe_is_max(ph, pl, np_valid: int) -> torch.Tensor:
    """Valid probe rows whose key is u64-max."""
    is_max = (ph == -1) & (pl == -1)
    is_max[np_valid:] = False
    return is_max


def bucket_join_count(kh, kl, vh, vl, ph, pl, nb_valid: int, np_valid: int,
                      *, r_slots: int, pre_shift: int = 0):
    """Fused build + probe count (K10).  Returns (count, special4)."""
    table = build_bucket_table(kh, kl, vh, vl, nb_valid, r_slots=r_slots,
                               with_values=False, pre_shift=pre_shift)
    count = bp.probe_count_vmem(table.tk_hi, table.tk_lo, ph, pl, np_valid,
                                pre_shift)
    sp = _probe_is_max(ph, pl, np_valid).sum() * table.special[0]
    return count + sp, table.special


def bucket_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid: int,
                            np_valid: int, *, r_slots: int,
                            pre_shift: int = 0):
    """Fused build + probe materialize (K11, then K5): (count, out_kh,
    out_kl, out_vh, out_vl, special4), the matched rows first in probe
    order."""
    table = build_bucket_table(kh, kl, vh, vl, nb_valid, r_slots=r_slots,
                               with_values=True, pre_shift=pre_shift)
    hit, mvh, mvl = bp.probe_materialize_vmem(
        table.tk_hi, table.tk_lo, table.tv_hi, table.tv_lo, ph, pl, np_valid,
        pre_shift)
    is_max = _probe_is_max(ph, pl, np_valid)
    max_vh, max_vl = narrow(table.special[1:3])
    hit |= is_max & (table.special[0] > 0)
    count, outs = compact_by_mask(hit, (ph, pl,
                                        torch.where(is_max, max_vh, mvh),
                                        torch.where(is_max, max_vl, mvl)))
    return (count, *outs, table.special)
