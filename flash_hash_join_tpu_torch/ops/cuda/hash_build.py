"""The `global` tier's table build on the card (csrc/hash_build.cu).

Replaces flash_hash_join_tpu/ops/hash_table.py:74 build_table, plain XLA
(a sort of the rows by (home group, key), a cumsum and a cummax for the
slots, a segmented scan for the bloom words, scatters), as the walk kernel
(ops/cuda/hash_walk.py) replaces the loop that searches the table.  Its
plain version is ops/hash_table.build_table_plain, which the CPU takes and
which ops/hash_table.build_table dispatches to for CPU tensors.  This
wrapper takes CUDA tensors only.

The kernels partition the valid rows by the top bits of their home group,
each row carried with its key and value words and its row id, in one or
two levels (`plan`: a count, a scan and a staged scatter each) into tiles
of at most TILE_TARGET rows on average and 2^MAX_TILE_BITS groups; then one
block a tile orders its rows by (home, key, row) in shared memory, keeps
the first occurrence of each key, takes its carry from the tiles before it
by a decoupled look-back over the max-plus scan start_b = max(end_{b-1},
b * G), and writes every key and value word of its slot range once, with
the bloom words of its groups.  A tile past TILE_ROWS rows is finished the
same way from device memory.  The table is the JAX package's, bit for bit:
keys and vals (total_groups, 2G) int32 planes, bloom (total_groups,) int64
words (zeros((1,)) when off), special (4,) int64 [has_max, max_vh, max_vl,
n_dropped].  3 x levels + 1 launches and three memsets on the current
stream of the planes' device, with no host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.hash_walk import GROUP_SIZES
from flash_hash_join_tpu_torch.utils import spans

MAX_GBITS = 30          # 2^30 home groups
TILE_ROWS = 2048        # rows a tile finished in shared memory (kCap)
TILE_TARGET = TILE_ROWS * 3 // 4  # rows a tile on average, at most
MAX_TILE_BITS = 9       # groups a tile: at most 2^9 (kMaxTileBits)
ONE_LEVEL_BITS = 8      # partition bits one level takes; more go in two
CHUNK_ROWS = 2048       # rows a partition block stages at a time


class Plan(NamedTuple):
    """The build's partition: the digit bits of each level (their sum, the
    partition bits, picks the tile: the home group's top bits), the blocks
    that share each parent partition, and the tile's group bits."""
    level_bits: tuple
    blocks: tuple
    tile_bits: int


def plan(n_valid: int, gbits: int, sms: int = 132) -> Plan:
    """The partition for n_valid rows over 2^gbits home groups on a card
    of `sms` multiprocessors: the fewest partition bits that leave a tile
    at most TILE_TARGET rows on average and at most 2^MAX_TILE_BITS groups
    (never more than gbits), in one level up to ONE_LEVEL_BITS bits (0
    bits: a compaction of the placeable rows), else two levels of half
    each (at most 11 bits: 21 in all); level 0 in at most 4 x sms blocks of
    at least CHUNK_ROWS rows, level 1 in about 4 x sms blocks in all.
    Uniformly hashed keys leave a tile of TILE_TARGET rows on average far
    below TILE_ROWS (its spread is about the square root); a larger one,
    from many equal keys or keys homed to few groups, is finished from
    device memory."""
    tiles_for_rows = (-(-max(n_valid, 1) // TILE_TARGET) - 1).bit_length()
    pbits = min(gbits, max(tiles_for_rows, gbits - MAX_TILE_BITS))
    bits = (pbits,) if pbits <= ONE_LEVEL_BITS else (
        (pbits + 1) // 2, pbits // 2)
    blocks = [max(1, min(-(-n_valid // CHUNK_ROWS), 4 * sms))]
    if len(bits) == 2:
        parents = 1 << bits[0]
        blocks.append(max(1, min(-(-4 * sms // parents),
                                 -(-n_valid // (parents * CHUNK_ROWS)))))
    return Plan(bits, tuple(blocks), gbits - pbits)


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
    p = plan(n_valid, gbits,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    shape = (len(p.level_bits), *(*p.level_bits, 0)[:2], *(*p.blocks, 1)[:2])
    with torch.cuda.device(dev):
        lib = _build.lib()
        scratch = torch.empty(lib.fhj_global_build_scratch_bytes(
            n_valid, gbits, *shape), dtype=torch.uint8, device=dev)
        # no kernel runs on an empty side: memsets only
        with spans.span(spans.K_GLOBAL_BUILD) if n_valid else spans.NONE:
            err = lib.fhj_global_build(
                *(q.data_ptr() for q in planes), n_valid, gbits, group_size,
                ntot, pre_shift, bloom_k,
                -1 if max_probe_iters is None else max_probe_iters,
                keys.data_ptr(), vals.data_ptr(), bloom.data_ptr(),
                bloom.numel(), int(with_bloom), special.data_ptr(),
                scratch.data_ptr(), scratch.numel(), *shape,
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "global_build_table")
    return keys, vals, bloom, special
