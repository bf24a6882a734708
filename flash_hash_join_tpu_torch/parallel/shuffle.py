"""Ragged hash shuffle over a mesh's ranks (port of
flash_hash_join_tpu/parallel/shuffle.py).

A row's destination rank is the top log2(ranks) bits of the same hash
that buckets the tables (ops/hashing.hash_u64), so rank d receives every
row whose key hashes to d, and a key's rows all meet on one rank.

The JAX shuffle packs fixed-quota buckets because XLA needs static shapes;
rows past the quota are dropped and counted, and the caller regrows the
quota.  PyTorch's all_to_all takes ragged split sizes, so here nothing is
dropped:
  1. each rank sorts its rows by destination with a STABLE sort (rows
     not sent sink past the last destination);
  2. torch.bincount counts each destination's rows;
  3. one small all_to_all exchanges the counts, then one host sync reads
     them: every rank's send and receive split sizes;
  4. one all_to_all moves the columns, stacked as one (n, ncols) int32
     tensor, so that a destination's rows are one contiguous slice.
Rank d receives its rows from every rank in rank order, each rank's rows
in their original order.  `overflow` stays in the caller's contract and is
always 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.hashing import hash_u64


def dest_device(kh: torch.Tensor, kl: torch.Tensor,
                dbits: int) -> torch.Tensor:
    """Destination rank = top dbits of the key hash (0 if dbits == 0), as
    int64."""
    if dbits == 0:
        return torch.zeros(kh.shape, dtype=torch.int64, device=kh.device)
    return hash_u64(kh, kl) >> (32 - dbits)


class ShufflePlan(NamedTuple):
    """A shuffle ready to exchange: for each local rank its rows to send,
    (n_sent, ncols) int32 grouped by destination in rank order, and its
    send and receive split sizes (rows to, and from, each rank).  Step 4
    is mesh.all_to_all(*plan); its wait() gives each local rank's
    received rows as (n_received, ncols) int32."""

    sends: list
    send_splits: list
    recv_splits: list


def plan_shuffle(mesh, cols, dest, send=None) -> ShufflePlan:
    """Steps 1-3 for every local rank: cols[i] is a tuple of equal-length
    int32 columns, dest[i] their destination ranks, send[i] (None: every
    row) a bool mask of the rows to send."""
    ndev = mesh.size
    orders, counts = [], []
    for i in range(len(mesh.local)):
        with mesh.guard(i):
            d = dest[i] if send is None else torch.where(send[i], dest[i],
                                                         ndev)
            orders.append(torch.sort(d, stable=True).indices)
            counts.append(torch.bincount(d, minlength=ndev + 1)[:ndev])
    ones = [[1] * ndev] * len(counts)
    recv = mesh.all_to_all([c.view(ndev, 1) for c in counts], ones,
                           ones).wait()
    send_splits = [c.tolist() for c in counts]
    recv_splits = [r.view(-1).tolist() for r in recv]
    sends = []
    for i, (order, splits) in enumerate(zip(orders, send_splits)):
        with mesh.guard(i):
            rows = order[:sum(splits)]
            sends.append(torch.stack([c[rows] for c in cols[i]], 1))
    return ShufflePlan(sends, send_splits, recv_splits)


def columns(rows: torch.Tensor) -> tuple:
    """The contiguous columns of received (n, ncols) rows."""
    return tuple(rows.t().contiguous())


def hash_shuffle(mesh, cols, dest, send=None):
    """Exchange rows so that rank d receives every sent row with dest ==
    d.  Returns (received, overflow): received[i] the local rank's columns
    (a tuple like cols[i]), overflow always 0 (no quota)."""
    rows = mesh.all_to_all(*plan_shuffle(mesh, cols, dest, send)).wait()
    return [columns(r) for r in rows], 0
