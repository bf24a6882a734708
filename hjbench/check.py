"""How `correct` is decided: what the timed window produced, against the
plain reference (reference/join.py) worked out from the same columns.

count_gap: the largest |count - the reference's count| over every join
of the window that returned one.  rows_wrong (materialize): of the joins
kept from the window, the rows of the first `count` output rows whose
(key, value) differs from the reference's row at that position, in probe
order, plus the rows one side has and the other lacks.  failed_joins:
the joins of the window that the driver counted as failed: on resident
columns those whose special[3] said build rows were dropped (the
engine's contract: such a join must be rerun on merge, so its answer is
not delivered); on the public call those that raised or returned no
count.  All are exact comparisons, so every limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from hjbench.reference import join as ref

LIMITS = {"count_gap": 0, "rows_wrong": 0, "failed_joins": 0}
BLOCK_ROWS = 1 << 25


def u64_bits(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern planes -> the uint64 keys' bits as int64."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


def planes(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint64 bits held as int64 -> (hi, lo) int32 bit-pattern planes."""
    lo = bits & 0xFFFFFFFF
    hi = (bits - lo) // (1 << 32)
    return tuple(torch.where(p >= 2**31, p - 2**32, p).to(torch.int32)
                 for p in (hi, lo))


def compare(bk: np.ndarray, bv: np.ndarray, pk: np.ndarray, mode: str,
            counts: list[int], kept: list[tuple], device, *, failed: int = 0,
            block_rows: int = BLOCK_ROWS) -> dict:
    """The numbers compared: count_gap, rows_wrong for a materialize, and
    failed_joins.  kept holds (count, kh, kl, vh, vl) of the joins whose
    rows are judged; failed counts the joins that dropped build rows."""
    table = ref.build(bk, bv, device)
    total, wrong, offset = 0, 0, 0
    for block in ref.probe(table, pk, device, block_rows=block_rows):
        n = block.keys.numel()
        for count, kh, kl, vh, vl in kept:
            m = max(min(count - offset, n), 0)
            rows = slice(offset, offset + m)
            wrong += int(((u64_bits(kh[rows], kl[rows]) != block.keys[:m])
                          | (u64_bits(vh[rows], vl[rows])
                             != block.values[:m])).sum()) + n - m
        offset += n
        total += n
    # a window whose every call failed has no count: failed_joins judges it
    checks = {"count_gap": max((abs(c - total) for c in counts), default=0)}
    if mode == "materialize":
        # rows past the reference's that a join returned
        checks["rows_wrong"] = wrong + sum(max(k[0] - total, 0) for k in kept)
    checks["failed_joins"] = failed
    return checks


def control(bk: np.ndarray, bv: np.ndarray, pk: np.ndarray, mode: str,
            device, *, block_rows: int = BLOCK_ROWS) -> dict:
    """The control's numbers: the reference with keys matched by their
    32-bit fingerprint, put in the program's place and judged as it is."""
    table = ref.build(bk, bv, device, fingerprint_keys=True)
    blocks = list(ref.probe(table, pk, device, block_rows=block_rows,
                            fingerprint_keys=True))
    count = sum(b.keys.numel() for b in blocks)
    kept = []
    if mode == "materialize":
        keys = torch.cat([b.keys for b in blocks])
        values = torch.cat([b.values for b in blocks])
        kept = [(count, *planes(keys), *planes(values))]
    return compare(bk, bv, pk, mode, [count], kept, device,
                   block_rows=block_rows)


def verdict(checks: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in checks.items())
