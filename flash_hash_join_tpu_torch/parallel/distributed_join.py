"""Distributed hash join over a mesh of ranks (port of
flash_hash_join_tpu/parallel/distributed_join.py).

  1. Both sides arrive row-sharded: rank r holds the r-th contiguous,
     near-equal piece of each column (shard_columns, np.array_split).
  2. Sampled heavy-hitter detection (parallel/hotkeys.py) builds a
     consensus hot set; hot BUILD rows are replicated (one all_gather) and
     hot PROBE rows stay where they are.
  3. Each rank hash-shuffles its other build rows (parallel/shuffle.py),
     then builds the `global` tier's table (ops/hash_table.py, bucketed on
     the hash bits below the rank bits: pre_shift; the build kernel on a
     card, launched on the rank's stream with no sync) over the rows it
     received, the replicated hot rows after them.
  4. The probe side is shuffled in `overlap_chunks` chunks: chunk k + 1's
     exchange is in flight while chunk k is probed (in-process: on each
     card's copy stream; in a process group: an async all_to_all).  Each
     rank probes its received chunks, then its local hot probe rows.
  5. count = the ranks' counts added up; materialize compacts each rank's
     parts with compact_by_mask (K5 on a card), and the host concatenates
     the ranks' rows in rank order.
Between the collectives, a rank's own work runs through mesh.map; on an
in-process mesh of several cards the shards' split and copy and the
read-back run in a thread a card (mesh.map(..., threaded=True)).

Exact by construction: a key's rows meet on one rank, and the ragged
exchange drops nothing.  The winner among duplicate build keys is the
MINIMUM build row, the port's rule on every tier: the stable exchange
keeps each rank's received rows in global row order, the replicated hot
rows come in rank order, and the table's stable sort keeps the first.
A rank whose table dropped build rows (special[3]: past max_probe_iters
or the table's end) reruns its own local join on `merge`, as the
single-card global tier does; the JAX package folds such drops into its
quota overflow and regrows the quota instead.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from flash_hash_join_tpu_torch.ops import hash_table as ht
from flash_hash_join_tpu_torch.ops import merge_join as mj
from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.parallel import hotkeys as hk
from flash_hash_join_tpu_torch.parallel.shuffle import (columns, dest_device,
                                                        hash_shuffle,
                                                        plan_shuffle)
from flash_hash_join_tpu_torch.utils import u64
from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG, JoinConfig


class DistJoinResult(NamedTuple):
    """count: the global match count.  keys, values: a materialize's
    matched (probe key, build value) rows as numpy u64, in rank order (on a
    process group: this process's rank's rows), else None.  info: the
    ranks, rows received, hot set, drops and reruns, stage seconds."""

    count: int
    keys: np.ndarray | None
    values: np.ndarray | None
    info: dict


def shard_columns(mesh, arrays) -> list:
    """Each local rank's share of the numpy u64 columns: the rank's
    contiguous near-equal piece of each (np.array_split, rank order), as
    (hi, lo) int32 planes on the rank's device; a flat list a rank."""
    def shard(i):
        r, planes = mesh.local[i], []
        for col in arrays:
            a, b = _bounds(len(col), mesh.size)[r:r + 2]
            planes += u64.device_planes(col[a:b], mesh.device(i))
        return planes
    return mesh.map(shard, threaded=True)


class _Clock:
    """Seconds of each stage: the local devices synchronised at each
    mark, so a stage's work is charged to it."""

    def __init__(self, mesh):
        self.mesh, self.stages, self.t = mesh, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        self.mesh.synchronize()
        now = time.perf_counter()
        self.stages[name] = now - self.t
        self.t = now


class _LocalJoin:
    """One rank's join: the global tier's table over its build rows, the
    parts it has probed, and the probe rows it keeps when the table dropped
    build rows and the rank reruns on merge.  The build is launched, not
    waited for: read_drops() reads its drop count."""

    def __init__(self, cols, cfg: JoinConfig, use_bloom: bool,
                 pre_shift: int, materialize: bool):
        self.cols, self.nb = cols, cols[0].numel()
        self.materialize = materialize
        self.table, self.drops, self.parts, self.kept = None, 0, [], []
        self.probed = 0
        if not self.nb:
            return
        gbits = cfg.group_bits(self.nb)
        self.table = ht.build_table(
            *cols, self.nb, gbits=gbits, group_size=cfg.group_size,
            overflow_groups=cfg.overflow_groups, with_bloom=use_bloom,
            bloom_k=cfg.bloom_k, pre_shift=pre_shift,
            max_probe_iters=cfg.max_probe_iters)
        self.static = dict(
            probe_chunk=cfg.probe_chunk, gbits=gbits,
            group_size=cfg.group_size,
            total_groups=(1 << gbits) + cfg.overflow_groups,
            use_bloom=use_bloom, bloom_k=cfg.bloom_k,
            max_iters=cfg.max_probe_iters, pre_shift=pre_shift)

    def read_drops(self) -> None:
        if self.table is not None:
            self.drops = int(self.table.special[3])
        if self.drops:
            self.table = None          # the rank reruns on merge

    def probe(self, ph, pl) -> None:
        self.probed += ph.numel()
        if self.drops:
            self.kept.append((ph, pl))
        elif self.nb:
            fn = ht.probe_materialize if self.materialize else ht.probe_count
            self.parts.append(fn(self.table, ph, pl, ph.numel(),
                                 **self.static))

    def finish(self):
        """(count, planes): the rank's count, a 0-d int64 tensor, and for
        a materialize its (kh, kl, vh, vl) planes, the matches first."""
        if self.drops:
            ph, pl = (torch.cat(c) for c in zip(*self.kept))
            args = (*self.cols, ph, pl, self.nb, ph.numel())
            if not self.materialize:
                return mj.merge_join_count(*args), None
            out = mj.merge_join_materialize(*args)
            return out[0], out[1:]
        dev = self.cols[0].device
        if not self.materialize:
            return sum(self.parts, torch.zeros((), dtype=torch.int64,
                                               device=dev)), None
        if not self.parts:
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            return torch.zeros((), dtype=torch.int64, device=dev), \
                (empty,) * 4
        # the parts' matches are their prefixes: one compaction (K5) puts
        # them together, in part order
        mask = torch.cat([torch.arange(p[1].numel(), device=dev) < p[0]
                          for p in self.parts])
        return compact_by_mask(mask, [torch.cat([p[j] for p in self.parts])
                                      for j in range(1, 5)])


def _bounds(n: int, k: int) -> list:
    """np.array_split's bounds of k contiguous near-equal pieces of n."""
    q, r = divmod(n, k)
    return [i * q + min(i, r) for i in range(k + 1)]


def distributed_join_exact(mesh, build_keys, build_values, probe_keys, *,
                           cfg: JoinConfig = DEFAULT_CONFIG,
                           use_bloom: bool = False, materialize: bool = False,
                           hot_cap: int = hk.HOT_CAP,
                           overlap_chunks: int = 2) -> DistJoinResult:
    """The exact distributed join of numpy u64 columns (the full columns;
    each rank takes its share, shard_columns).  hot_cap > 0 enables the
    hot-key tier (0 disables it); overlap_chunks >= 1 probe-side
    exchanges, each in flight while the one before is probed."""
    if overlap_chunks < 1:
        raise ValueError(f"overlap_chunks must be >= 1, got {overlap_chunks}")
    clock = _Clock(mesh)
    shards = shard_columns(mesh, (build_keys, build_values, probe_keys))
    clock.mark("split_h2d")
    dbits = mesh.size.bit_length() - 1
    build = [tuple(s[:4]) for s in shards]
    probe = [tuple(s[4:]) for s in shards]
    send_b = send_p = None
    hot_rows = [None] * len(mesh.local)
    local_p = [(p[0][:0], p[1][:0]) for p in probe]
    hot_keys = 0
    if hot_cap > 0:
        hot = hk.detect_hot_keys(mesh, [p[0] for p in probe],
                                 [p[1] for p in probe], cap=hot_cap)
        hot_keys = hot[0].keys.numel()
        hot_rows = hk.gather_hot_build_rows(mesh, build, hot)

        def split_hot(i):
            b, p, h = build[i], probe[i], hot[i]
            m = hk.is_member(p[0], p[1], h)
            return ~hk.is_member(b[0], b[1], h), ~m, (p[0][m], p[1][m])
        send_b, send_p, local_p = zip(*mesh.map(split_hot))
    clock.mark("hot_keys")

    recv_b, overflow = hash_shuffle(
        mesh, build, [dest_device(b[0], b[1], dbits) for b in build], send_b)
    clock.mark("build_exchange")

    def build_rank(i):
        cols = recv_b[i]
        if hot_rows[i] is not None:
            cols = tuple(torch.cat([c, h]) for c, h in zip(cols,
                                                             hot_rows[i].t()))
        return _LocalJoin(cols, cfg, use_bloom, dbits, materialize)
    joins = mesh.map(build_rank)
    for j in joins:        # every rank's build launched: then the waits
        j.read_drops()
    del recv_b, build, shards
    clock.mark("build")

    plans = []
    for k in range(overlap_chunks):
        cut = [_bounds(p[0].numel(), overlap_chunks)[k:k + 2] for p in probe]
        cols = [(p[0][a:b], p[1][a:b]) for p, (a, b) in zip(probe, cut)]
        plans.append(plan_shuffle(
            mesh, cols, [dest_device(c[0], c[1], dbits) for c in cols],
            None if send_p is None else [m[a:b] for m, (a, b) in
                                         zip(send_p, cut)]))
    pending = mesh.all_to_all(*plans[0])
    for k in range(overlap_chunks):
        rows = pending.wait()
        if k + 1 < overlap_chunks:
            pending = mesh.all_to_all(*plans[k + 1])
        last = k + 1 == overlap_chunks

        def probe_rank(i):
            joins[i].probe(*columns(rows[i]))
            if last:
                joins[i].probe(*local_p[i])
        mesh.map(probe_rank)
    del plans, rows, probe, local_p
    clock.mark("probe")

    def finish_rank(i):
        """(count tensor, count, keys, values): the rank's rows read back
        as numpy u64 for a materialize."""
        count, planes = joins[i].finish()
        n = int(count)
        if planes is None:
            return count, n, None, None
        return (count, n, u64.to_numpy_u64(planes[0], planes[1], n),
                u64.to_numpy_u64(planes[2], planes[3], n))
    outs = mesh.map(finish_rank, threaded=True)
    count = mesh.sum([o[0] for o in outs])
    rank_counts = [o[1] for o in outs]
    keys = values = None
    if materialize:
        keys = np.concatenate([o[2] for o in outs])
        values = np.concatenate([o[3] for o in outs])
    clock.mark("finish")
    drops = [torch.tensor(j.drops, device=mesh.device(i))
             for i, j in enumerate(joins)]
    reruns = [torch.tensor(int(j.drops > 0), device=mesh.device(i))
              for i, j in enumerate(joins)]
    info = dict(
        ranks=mesh.size, devices=[str(d) for d in mesh.devices],
        local_ranks=list(mesh.local), hot_keys=hot_keys,
        build_rows=[j.nb for j in joins], probe_rows=[j.probed for j in joins],
        rank_counts=rank_counts, drops=mesh.sum(drops),
        reruns=mesh.sum(reruns), overflow=overflow,
        probe_chunks=overlap_chunks, stages=clock.stages)
    return DistJoinResult(count, keys, values, info)
