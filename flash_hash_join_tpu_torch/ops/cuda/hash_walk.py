"""The `global` tier's probe on the card: the bounded group walk over the
open-addressed hash table, count and materialize (csrc/hash_walk.cu).

Replaces flash_hash_join_tpu/ops/hash_table.py:212 _probe_chunk_state
together with the lax.scan of probe_count (:304) and probe_materialize
(:350) around it.  That code is plain XLA, not a Pallas kernel (a
jax.lax.while_loop, one device program on the TPU), as the range
directory replaces plain XLA too (ops/cuda/range_probe.py); its plain
version here is ops/hash_table.py's host-synced walk, which the CPU takes
and which ops/hash_table.probe_count / probe_materialize dispatch to for
CPU tensors.  These wrappers take CUDA tensors only.

The table is ops/hash_table.HashTable: keys and vals (total_groups, 2G)
int32 planes, bloom int64 words (zeros((1,)) when off), special (4,)
int64.  Each probe: hash, home group (after pre_shift), the bloom test,
then at most max_iters groups, each compared at once; a u64-max probe is
answered from special, rows at or past n_valid never hit.  `plan` picks
the order in which the probes walk, by shape: 0 levels, the probes in
probe order, where the planes the walk reads fit in half of L2 or fewer
than MIN_PROBES_PER_GROUP probes share a group; else passes of at most
PASS_ROWS valid rows, each partitioned by the top bits of its home group
(a count, a look-back scan and a staged scatter of 8-byte records,
csrc/partition.cuh) into slices of at most SLICE_BYTES of those planes,
walked slice by slice so that each slice's rows come from device memory
once (for materialize put back into probe order chunk by chunk of the
scatter).  The constants are an H100's (scripts/bench_global_build.py
--sweep, PERF.md).  A count with bloom on the 1-level route prunes each
pass first where its bloom words, narrowed to u32, fit in three
quarters of L2 (global_prune, in the span fhj.global.prune): only the rows whose bloom
test passes are partitioned and walked, the pass's walk taking their
number from the card.  The kernels add the groups they visited into
stats[0], keep the longest walk in stats[1] and add the rows whose bloom
test passed into stats[2] (a (3,) int64 tensor on the probes' device, or
None), with no host sync.  Each call of a kernel's entry counts one
launch: a pruned count one global_prune and one global_walk_count a pass.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils import spans

GROUP_SIZES = (1, 2, 4, 8, 16, 32)
L2_BYTES = 50 * 2**20       # the H100's L2, where the card does not say
SLICE_BYTES = 16 * 2**20    # the walked planes a digit covers, at most
MAX_PBITS = 7               # digits a pass: at most 2^7
PASS_ROWS = 2**27           # valid probe rows a pass partitions, at most
MIN_PROBES_PER_GROUP = 2.0  # fewer valid probes a group: 0 levels
CHUNK_ROWS = 4096           # rows a partition block stages at a time
PRUNE_L2_SHARE = 0.75       # of L2, the most a prune's u32 bloom words take
_forced: dict = {}


class Plan(NamedTuple):
    """The walk's order: the digit bits of the one partition level (0: the
    per-probe walk over the probe planes), the valid rows a pass, the
    partition's blocks, and whether a count with bloom prunes each pass
    before it is partitioned."""
    pbits: int
    pass_rows: int
    blocks: int
    prune: bool = False


def walked_bytes(total_groups: int, group_size: int, use_bloom: bool,
                 materialize: bool) -> int:
    """Bytes of the table planes a walk reads: the key rows, the bloom
    words with bloom, the value rows for materialize."""
    row = 8 * group_size * total_groups
    return row * (2 if materialize else 1) + (8 * total_groups if use_bloom
                                              else 0)


def slice_bits(total_groups: int, group_size: int, use_bloom: bool,
               materialize: bool) -> int:
    """The fewest digit bits, at least 1 and at most MAX_PBITS, that cut
    the planes a walk reads into slices of at most SLICE_BYTES."""
    walked = walked_bytes(total_groups, group_size, use_bloom, materialize)
    return min(MAX_PBITS, max(1, math.ceil(math.log2(walked / SLICE_BYTES))))


def plan(n_valid: int, gbits: int, total_groups: int, group_size: int,
         use_bloom: bool, materialize: bool, *, l2_bytes: int = L2_BYTES,
         sms: int = 132, pbits: int | None = None,
         pass_rows: int | None = None, prune: bool | None = None) -> Plan:
    """The walk's plan for n_valid probe rows on a card with `l2_bytes` of
    L2 and `sms` multiprocessors: 0 levels where the planes the walk reads
    fit in half of L2, or where fewer than MIN_PROBES_PER_GROUP valid
    probes a group would share each row a slice brings in; else one level
    of slice_bits, at most gbits.  A count with bloom at 1 level prunes
    where the bloom words narrowed to u32, 4 B a group, take at most
    PRUNE_L2_SHARE of L2: the prune gathers one word a row, and from device
    memory that gather costs more than partitioning every row and testing
    the bloom slice by slice (on an H100, PERF.md: 16 MB of words prune
    faster at 5 % and 60 % match, 32 MB at 5 % and not at 60 %, 64 and
    128 MB slower).  pbits, pass_rows and prune, when given, replace the
    plan's own (pbits still at most gbits, prune only for a count with
    bloom at 1 level); an empty probe side takes 0 levels."""
    if pbits is None:
        walked = walked_bytes(total_groups, group_size, use_bloom,
                              materialize)
        pbits = slice_bits(total_groups, group_size, use_bloom, materialize) \
            if walked > l2_bytes // 2 and \
            n_valid >= MIN_PROBES_PER_GROUP * total_groups else 0
    pbits = 0 if n_valid <= 0 else min(pbits, gbits)
    rows = max(1, min(PASS_ROWS if pass_rows is None else pass_rows,
                      n_valid))
    blocks = max(1, min(-(-rows // CHUNK_ROWS), 4 * sms))
    if prune is None:
        prune = 4 * total_groups <= PRUNE_L2_SHARE * l2_bytes
    return Plan(pbits, rows, blocks,
                bool(prune) and use_bloom and not materialize and pbits > 0)


@contextlib.contextmanager
def forced(**overrides):
    """Within the block, the wrappers plan with these overrides of `plan`
    (pbits, pass_rows, prune): how the tests and chip_smoke.py hold both routes
    and the pass loop to the plain walk at small sizes."""
    global _forced
    before = _forced
    _forced = dict(before, **overrides)
    try:
        yield
    finally:
        _forced = before


def _check(table, ph, pl, n_valid: int, *, gbits: int, group_size: int,
           total_groups: int, use_bloom: bool, bloom_k: int, max_iters: int,
           pre_shift: int, stats) -> torch.device:
    dev = ph.device
    if dev.type != "cuda":
        raise ValueError("the walk kernel takes CUDA tensors; the plain walk "
                         "is ops/hash_table.probe_count / probe_materialize")
    if group_size not in GROUP_SIZES:
        raise ValueError(f"group_size must be one of {GROUP_SIZES}, got "
                         f"{group_size}")
    if not (0 <= gbits <= 32 and 0 <= pre_shift <= 32 and max_iters >= 0
            and total_groups >= 1 << gbits and 0 <= bloom_k <= 32):
        raise ValueError("need 0 <= gbits, pre_shift <= 32, max_iters >= 0, "
                         "0 <= bloom_k <= 32, total_groups >= 2^gbits")
    for name, t in (("table.keys", table.keys), ("table.vals", table.vals)):
        if (t.dtype != torch.int32 or t.shape != (total_groups, 2 * group_size)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous ({total_groups}, "
                             f"{2 * group_size}) int32 tensor on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    nbloom = total_groups if use_bloom else 1
    for name, t, n in (("table.bloom", table.bloom, nbloom),
                       ("table.special", table.special, 4),
                       ("stats", stats, 3)):
        if t is None:
            continue
        if (t.dtype != torch.int64 or t.shape != (n,) or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous ({n},) int64 "
                             f"tensor on {dev}")
    for name, p in (("ph", ph), ("pl", pl)):
        if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {p.dtype} of shape {tuple(p.shape)}")
    if pl.shape != ph.shape or pl.device != dev:
        raise ValueError("ph and pl must have equal length, on one device")
    if not 0 <= n_valid <= ph.numel():
        raise ValueError(f"n_valid must be in [0, {ph.numel()}], got "
                         f"{n_valid}")
    return dev


def _table_args(table, *, gbits, group_size, total_groups, use_bloom,
                bloom_k, max_iters, pre_shift) -> tuple:
    """bloom, special, total_groups, group_size, gbits, pre_shift, bloom_k,
    max_iters: the kernels' table arguments after keys (and vals)."""
    return (table.bloom.data_ptr() if use_bloom else None,
            table.special.data_ptr(), total_groups, group_size, gbits,
            pre_shift, bloom_k, max_iters)


def _plan_args(lib, dev, n_valid: int, static: dict,
               materialize: bool) -> tuple:
    """The plan, the kernels' plan arguments (pbits, pass_rows, blocks,
    scratch, scratch bytes), and the scratch they need on dev."""
    props = torch.cuda.get_device_properties(dev)
    p = plan(n_valid, static["gbits"], static["total_groups"],
             static["group_size"], static["use_bloom"], materialize,
             l2_bytes=getattr(props, "L2_cache_size", L2_BYTES),
             sms=props.multi_processor_count, **_forced)
    nbytes = lib.fhj_global_walk_scratch_bytes(static["gbits"], *p[:3],
                                               int(materialize))
    if nbytes < 0:
        raise ValueError(f"the walk kernel does not take the plan {p}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return p, (*p[:3], scratch.data_ptr() if nbytes else None,
               nbytes), scratch


def global_walk_count(table, ph: torch.Tensor, pl: torch.Tensor,
                      n_valid: int, *, gbits: int, group_size: int,
                      total_groups: int, use_bloom: bool, bloom_k: int,
                      max_iters: int, pre_shift: int = 0,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Count the probe rows [0, n_valid) whose key is in the table; a 0-d
    int64 tensor on the card.  The plan's launches, on the current stream
    of the probes' device; where the plan prunes, a prune and a pruned
    walk a pass (_count_pruned)."""
    static = dict(gbits=gbits, group_size=group_size,
                  total_groups=total_groups, use_bloom=use_bloom,
                  bloom_k=bloom_k, max_iters=max_iters, pre_shift=pre_shift)
    dev = _check(table, ph, pl, n_valid, stats=stats, **static)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if n_valid == 0:
        return count
    with torch.cuda.device(dev):
        lib = _build.lib()
        p, plan_args, scratch = _plan_args(lib, dev, n_valid, static,
                                           False)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if p.prune:
            _count_pruned(lib, table, ph, pl, n_valid, plan_args, static,
                          count, stats, stream)
            return count
        with spans.span(spans.K_GLOBAL_WALK_COUNT):
            err = lib.fhj_global_walk_count(
                table.keys.data_ptr(), *_table_args(table, **static),
                ph.data_ptr(), pl.data_ptr(), n_valid, count.data_ptr(),
                None if stats is None else stats.data_ptr(), *plan_args,
                None, stream)
        _build.check(err, "global_walk_count")
    return count


def _count_pruned(lib, table, ph, pl, n_valid: int, plan_args: tuple,
                  static: dict, count, stats, stream) -> None:
    """The count's passes where the plan prunes, added into count: each
    pass's rows pruned (in the span fhj.global.prune), then the survivors
    partitioned and walked with no bloom test, on the card's count of them.
    Scratch beside the walk's: the survivors' two planes, 8 B a row of a
    pass, and the bloom words narrowed to u32 by the first pass's prune."""
    pass_rows = plan_args[1]
    dev = ph.device
    sh, sl = torch.empty((2, pass_rows), dtype=torch.int32, device=dev)
    rows = torch.empty(2, dtype=torch.int32, device=dev)
    words = torch.empty(static["total_groups"], dtype=torch.int32, device=dev)
    walk_args = (table.keys.data_ptr(),
                 *_table_args(table, **dict(static, use_bloom=False)))
    stats_ptr = None if stats is None else stats.data_ptr()
    for p0 in range(0, n_valid, pass_rows):
        n = min(pass_rows, n_valid - p0)
        with spans.span(spans.GLOBAL_PRUNE):
            _prune(lib, table, ph.data_ptr() + 4 * p0, pl.data_ptr() + 4 * p0,
                   n, sh, sl, rows, count, stats_ptr, static, stream,
                   words, narrow=p0 == 0)
        with spans.span(spans.K_GLOBAL_WALK_COUNT):
            err = lib.fhj_global_walk_count(
                *walk_args, sh.data_ptr(), sl.data_ptr(), n,
                count.data_ptr(), stats_ptr, *plan_args, rows.data_ptr(),
                stream)
        _build.check(err, "global_walk_count")


def _prune(lib, table, ph_ptr: int, pl_ptr: int, n: int, sh, sl, rows,
           count, stats_ptr, static: dict, stream, words,
           narrow: bool) -> None:
    """One launch of the prune kernel: its memset, the bloom words
    narrowed into `words` first where `narrow`, and prune_kernel on them."""
    with spans.span(spans.K_GLOBAL_PRUNE):
        err = lib.fhj_global_prune(
            table.bloom.data_ptr() if narrow else None, words.data_ptr(),
            words.numel(), table.special.data_ptr(), static["gbits"],
            static["pre_shift"], static["bloom_k"], ph_ptr, pl_ptr, n,
            sh.data_ptr(), sl.data_ptr(), rows.data_ptr(), count.data_ptr(),
            stats_ptr, stream)
    _build.check(err, "global_prune")


def global_prune(table, ph: torch.Tensor, pl: torch.Tensor, n_valid: int, *,
                 gbits: int, group_size: int, total_groups: int,
                 bloom_k: int, max_iters: int, pre_shift: int = 0,
                 use_bloom: bool = True, stats: torch.Tensor | None = None):
    """The bloom prune of probe rows [0, n_valid) (n_valid < 2^31): (sh,
    sl, rows, count).  sh, sl: int32 planes of n_valid rows whose first
    rows[1] hold the rows that are not the u64-max key and whose bloom tag
    is inside their home group's word, in no order; rows: a (2,) int32
    tensor [0, survivors] on the card; count: a 0-d int64 tensor, the
    u64-max rows when special[0] > 0.  The survivors add into stats[2].
    Plain version: ops/hash_table.prune_plain."""
    static = dict(gbits=gbits, group_size=group_size,
                  total_groups=total_groups, use_bloom=True, bloom_k=bloom_k,
                  max_iters=max_iters, pre_shift=pre_shift)
    if not use_bloom:
        raise ValueError("the prune tests the table's bloom words")
    dev = _check(table, ph, pl, n_valid, stats=stats, **static)
    if n_valid >= 2**31:
        raise ValueError(f"the prune takes fewer than 2^31 rows, got "
                         f"{n_valid}")
    sh, sl = torch.empty((2, n_valid), dtype=torch.int32, device=dev)
    rows = torch.empty(2, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    words = torch.empty(total_groups, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _prune(_build.lib(), table, ph.data_ptr(), pl.data_ptr(), n_valid,
               sh, sl, rows, count,
               None if stats is None else stats.data_ptr(), static,
               torch.cuda.current_stream(dev).cuda_stream, words, narrow=True)
    return sh, sl, rows, count


def global_walk_materialize(table, ph: torch.Tensor, pl: torch.Tensor,
                            n_valid: int, *, gbits: int, group_size: int,
                            total_groups: int, use_bloom: bool, bloom_k: int,
                            max_iters: int, pre_shift: int = 0,
                            stats: torch.Tensor | None = None):
    """Per probe row: (hit, vh, vl), a bool mask and the int32 value planes
    of the matching slot (special[1:3] for a u64-max probe; 0 on a miss and
    at or past n_valid).  The plan's launches, on the current stream of
    the probes' device."""
    static = dict(gbits=gbits, group_size=group_size,
                  total_groups=total_groups, use_bloom=use_bloom,
                  bloom_k=bloom_k, max_iters=max_iters, pre_shift=pre_shift)
    dev = _check(table, ph, pl, n_valid, stats=stats, **static)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    with torch.cuda.device(dev):
        lib = _build.lib()
        _, plan_args, scratch = _plan_args(lib, dev, n_valid, static, True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with spans.span(spans.K_GLOBAL_WALK_MATERIALIZE):
            err = lib.fhj_global_walk_materialize(
                table.keys.data_ptr(), table.vals.data_ptr(),
                *_table_args(table, **static), ph.data_ptr(), pl.data_ptr(),
                n, n_valid, hit.data_ptr(), vh.data_ptr(), vl.data_ptr(),
                None if stats is None else stats.data_ptr(), *plan_args,
                stream)
        _build.check(err, "global_walk_materialize")
    return hit, vh, vl
