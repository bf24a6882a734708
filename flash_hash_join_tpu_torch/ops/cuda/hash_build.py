"""The `global` tier's table build on the card (csrc/hash_build.cu).

Replaces flash_hash_join_tpu/ops/hash_table.py:74 build_table, plain XLA
(a sort of the rows by (home group, key), a cumsum and a cummax for the
slots, a segmented scan for the bloom words, scatters), as the walk kernel
(ops/cuda/hash_walk.py) replaces the loop that searches the table.  Its
plain version is ops/hash_table.build_table_plain, which the CPU takes and
which ops/hash_table.build_table dispatches to for CPU tensors.  This
wrapper takes CUDA tensors only.

The kernels sort the rows by home group with a count, a scan and a
scatter of row ids, order each group's rows by (key, row) and keep the
first occurrence of each key (a thread a group, a block for a group of
more than 32 rows), then write each group's kept rows to consecutive
slots from its start, a max-plus scan over the groups:
start_b = max(end_{b-1}, b * G).  The bloom words are an atomic OR a row
at its home group.  The table is the JAX package's, bit for bit: keys and
vals (total_groups, 2G) int32 planes, bloom (total_groups,) int64 words
(zeros((1,)) when off), special (4,) int64 [has_max, max_vh, max_vl,
n_dropped].  About ten launches and five memsets on the current stream of
the planes' device, with no host sync.
"""

from __future__ import annotations

import threading

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.hash_walk import GROUP_SIZES

MAX_GBITS = 30          # 2^30 home groups: 4 GiB of counts a scratch array
_count_lock = threading.Lock()   # the distributed ranks build a thread a card


def _check(planes, n_valid: int, *, gbits: int, group_size: int,
           overflow_groups: int, bloom_k: int, pre_shift: int,
           max_probe_iters) -> torch.device:
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError("the build kernel takes CUDA tensors; the plain "
                         "build is ops/hash_table.build_table_plain")
    n = planes[0].numel()
    for name, p in zip(("kh", "kl", "vh", "vl"), planes):
        if (p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous()
                or p.shape != planes[0].shape or p.device != dev):
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor "
                             f"of {n} rows on {dev}, got {p.dtype} of shape "
                             f"{tuple(p.shape)} on {p.device}")
    if group_size not in GROUP_SIZES:
        raise ValueError(f"group_size must be one of {GROUP_SIZES}, got "
                         f"{group_size}")
    if not (0 <= gbits <= MAX_GBITS and 0 <= pre_shift <= 32
            and overflow_groups >= 0 and 0 <= bloom_k <= 32):
        raise ValueError(f"need 0 <= gbits <= {MAX_GBITS}, 0 <= pre_shift <= "
                         "32, overflow_groups >= 0, 0 <= bloom_k <= 32")
    if max_probe_iters is not None and not 0 <= max_probe_iters < 2**31:
        raise ValueError(f"max_probe_iters must be None or in [0, 2^31), got "
                         f"{max_probe_iters}")
    if min(n_valid, n) >= 2**31:
        raise ValueError(f"the build kernel takes fewer than 2^31 valid rows, "
                         f"got {min(n_valid, n)}")
    return dev


def global_build_table(kh: torch.Tensor, kl: torch.Tensor, vh: torch.Tensor,
                       vl: torch.Tensor, n_valid: int, *, gbits: int,
                       group_size: int, overflow_groups: int,
                       with_bloom: bool, bloom_k: int = 3, pre_shift: int = 0,
                       max_probe_iters: int | None = None):
    """(keys, vals, bloom, special) of the table over the rows [0, n_valid)
    of the int32 build planes, on their device's current stream; the
    arguments are ops/hash_table.build_table's."""
    planes = (kh, kl, vh, vl)
    dev = _check(planes, n_valid, gbits=gbits, group_size=group_size,
                 overflow_groups=overflow_groups, bloom_k=bloom_k,
                 pre_shift=pre_shift, max_probe_iters=max_probe_iters)
    n_valid = max(0, min(int(n_valid), kh.numel()))
    ntot = (1 << gbits) + overflow_groups
    keys = torch.empty((ntot, 2 * group_size), dtype=torch.int32, device=dev)
    vals = torch.empty_like(keys)
    bloom = torch.empty(ntot if with_bloom else 1, dtype=torch.int64,
                        device=dev)
    special = torch.empty(4, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = _build.lib()
        scratch = torch.empty(lib.fhj_global_build_scratch_bytes(
            gbits, n_valid), dtype=torch.uint8, device=dev)
        # the large groups' merge buffer: the value plane, cleared after it
        spare = vals if vals.numel() >= n_valid else torch.empty(
            n_valid, dtype=torch.int32, device=dev)
        err = lib.fhj_global_build(
            *(p.data_ptr() for p in planes), n_valid, gbits, group_size,
            ntot, pre_shift, bloom_k,
            -1 if max_probe_iters is None else max_probe_iters,
            keys.data_ptr(), vals.data_ptr(), bloom.data_ptr(), bloom.numel(),
            int(with_bloom), special.data_ptr(), scratch.data_ptr(),
            scratch.numel(), spare.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if n_valid:             # no kernel runs on an empty side: memsets only
            with _count_lock:
                global_build_table.launches += 1
        _build.check(err, "global_build_table")
    return keys, vals, bloom, special


global_build_table.launches = 0
