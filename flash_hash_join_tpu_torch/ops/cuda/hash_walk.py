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
--sweep, PERF.md).  The kernels add the groups they visited into stats[0]
and keep the longest walk in stats[1] (a (2,) int64 tensor on the probes'
device, or None), with no host sync.  Each wrapper call counts one
launch.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build

GROUP_SIZES = (1, 2, 4, 8, 16, 32)
L2_BYTES = 50 * 2**20       # the H100's L2, where the card does not say
SLICE_BYTES = 16 * 2**20    # the walked planes a digit covers, at most
MAX_PBITS = 7               # digits a pass: at most 2^7
PASS_ROWS = 2**27           # valid probe rows a pass partitions, at most
MIN_PROBES_PER_GROUP = 2.0  # fewer valid probes a group: 0 levels
CHUNK_ROWS = 4096           # rows a partition block stages at a time
_forced: dict = {}


class Plan(NamedTuple):
    """The walk's order: the digit bits of the one partition level (0: the
    per-probe walk over the probe planes), the valid rows a pass and the
    partition's blocks."""
    pbits: int
    pass_rows: int
    blocks: int


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
         pass_rows: int | None = None) -> Plan:
    """The walk's plan for n_valid probe rows on a card with `l2_bytes` of
    L2 and `sms` multiprocessors: 0 levels where the planes the walk reads
    fit in half of L2, or where fewer than MIN_PROBES_PER_GROUP valid
    probes a group would share each row a slice brings in; else one level
    of slice_bits, at most gbits.  pbits and pass_rows, when given, replace
    the plan's own (pbits still at most gbits); an empty probe side takes
    0 levels."""
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
    return Plan(pbits, rows, blocks)


@contextlib.contextmanager
def forced(**overrides):
    """Within the block, the wrappers plan with these overrides of `plan`
    (pbits, pass_rows): how the tests and chip_smoke.py hold both routes
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
                       ("stats", stats, 2)):
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
    """pbits, pass_rows, blocks, scratch, scratch bytes: the kernels' plan
    arguments, with the scratch they need on dev."""
    props = torch.cuda.get_device_properties(dev)
    p = plan(n_valid, static["gbits"], static["total_groups"],
             static["group_size"], static["use_bloom"], materialize,
             l2_bytes=getattr(props, "L2_cache_size", L2_BYTES),
             sms=props.multi_processor_count, **_forced)
    nbytes = lib.fhj_global_walk_scratch_bytes(static["gbits"], *p,
                                               int(materialize))
    if nbytes < 0:
        raise ValueError(f"the walk kernel does not take the plan {p}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return (*p, scratch.data_ptr() if nbytes else None, nbytes), scratch


def global_walk_count(table, ph: torch.Tensor, pl: torch.Tensor,
                      n_valid: int, *, gbits: int, group_size: int,
                      total_groups: int, use_bloom: bool, bloom_k: int,
                      max_iters: int, pre_shift: int = 0,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Count the probe rows [0, n_valid) whose key is in the table; a 0-d
    int64 tensor on the card.  The plan's launches, on the current stream
    of the probes' device."""
    static = dict(gbits=gbits, group_size=group_size,
                  total_groups=total_groups, use_bloom=use_bloom,
                  bloom_k=bloom_k, max_iters=max_iters, pre_shift=pre_shift)
    dev = _check(table, ph, pl, n_valid, stats=stats, **static)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if n_valid == 0:
        return count
    with torch.cuda.device(dev):
        lib = _build.lib()
        plan_args, scratch = _plan_args(lib, dev, n_valid, static, False)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fhj_global_walk_count(
            table.keys.data_ptr(), *_table_args(table, **static),
            ph.data_ptr(), pl.data_ptr(), n_valid, count.data_ptr(),
            None if stats is None else stats.data_ptr(), *plan_args, stream)
        global_walk_count.launches += 1
        _build.check(err, "global_walk_count")
    return count


global_walk_count.launches = 0


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
        plan_args, scratch = _plan_args(lib, dev, n_valid, static, True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fhj_global_walk_materialize(
            table.keys.data_ptr(), table.vals.data_ptr(),
            *_table_args(table, **static), ph.data_ptr(), pl.data_ptr(), n,
            n_valid, hit.data_ptr(), vh.data_ptr(), vl.data_ptr(),
            None if stats is None else stats.data_ptr(), *plan_args, stream)
        global_walk_materialize.launches += 1
        _build.check(err, "global_walk_materialize")
    return hit, vh, vl


global_walk_materialize.launches = 0
