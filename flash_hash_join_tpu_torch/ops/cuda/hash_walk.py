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
int64.  One launch walks the whole probe side, one thread a probe row:
hash, home group (after pre_shift), the bloom test, then at most max_iters
groups, each compared at once; a u64-max probe is answered from special,
rows at or past n_valid never hit.  The kernel adds the groups it visited
into stats[0] and keeps the longest walk in stats[1] (a (2,) int64 tensor
on the probes' device, or None), with no host sync.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build

GROUP_SIZES = (1, 2, 4, 8, 16, 32)


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


def global_walk_count(table, ph: torch.Tensor, pl: torch.Tensor,
                      n_valid: int, *, gbits: int, group_size: int,
                      total_groups: int, use_bloom: bool, bloom_k: int,
                      max_iters: int, pre_shift: int = 0,
                      stats: torch.Tensor | None = None) -> torch.Tensor:
    """Count the probe rows [0, n_valid) whose key is in the table; a 0-d
    int64 tensor on the card.  One launch over the whole probe side, on the
    current stream of the probes' device."""
    static = dict(gbits=gbits, group_size=group_size,
                  total_groups=total_groups, use_bloom=use_bloom,
                  bloom_k=bloom_k, max_iters=max_iters, pre_shift=pre_shift)
    dev = _check(table, ph, pl, n_valid, stats=stats, **static)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    if n_valid == 0:
        return count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.lib().fhj_global_walk_count(
            table.keys.data_ptr(), *_table_args(table, **static),
            ph.data_ptr(), pl.data_ptr(), n_valid, count.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
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
    at or past n_valid).  One launch over the whole probe side, on the
    current stream of the probes' device."""
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.lib().fhj_global_walk_materialize(
            table.keys.data_ptr(), table.vals.data_ptr(),
            *_table_args(table, **static), ph.data_ptr(), pl.data_ptr(), n,
            n_valid, hit.data_ptr(), vh.data_ptr(), vl.data_ptr(),
            None if stats is None else stats.data_ptr(), stream)
        global_walk_materialize.launches += 1
        _build.check(err, "global_walk_materialize")
    return hit, vh, vl


global_walk_materialize.launches = 0
