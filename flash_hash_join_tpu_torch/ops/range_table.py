"""Range table: the partitioned ("radix") tier, count and materialize (port
of flash_hash_join_tpu/ops/range_table.py:build_range_table,
range_join_count, range_join_count_chunked and range_join_materialize).

The JAX package bounds each probe's random-access working set to fast
memory: one lax.sort per side, the sorted build reshaped into a
rank-balanced (S, C, 128) table of lane-columns, and a Pallas kernel that
finds each sorted probe tile's columns through a W-super-row window.  That
layout exists because Mosaic has no per-element addressing.  On the H100
every probe addresses the sorted keys directly (K3/K4,
ops/cuda/range_probe.py), so the table is just

  build: the valid build rows' keys as sortable int64 (utils/u64.py),
         sorted STABLY with their value planes interleaved as one (vh, vl)
         plane (ops/cuda/range_build.py: on the card a radix sort of the
         key digits that vary, each record carrying its values; where the
         JAX package runs a plain lax.sort), and above rp.SMALL_TABLE keys
         a bucket directory over the sorted keys (range_directory, one
         thread a bucket): the Hopper form of the TPU table's column
         boundaries `bnds`;
  probe: unsorted, in input order; per row one directory read, then the
         bucket's few keys (an interpolation guess of the key's sector,
         then a lower bound over what is left); a smaller table, in L1,
         is searched whole.

Not ported, because nothing here needs them: the probe sort and tile
padding, the window and its `wstart`, SMALL and BLOCKWISE modes, the
hash / key / narrow sort orders and the w_mult retry ladder, the bloom-tag
plane (FHJ_RANGE_BLOOM) and the max-key special channel: with no window
there is nothing to overflow (special[3] is always 0), and with no
all-ones sentinel the u64-max (or u32-max) key joins like any other key.

Semantics (SURVEY.md §3): inner first-match join.  The winner among
duplicate build keys is the minimum build row — the stable sort puts it
first in its run — like the port's direct and merge strategies; the JAX
partitioned tier's winner is the minimal value within the probed column
instead.  Materialize emits probe order (the JAX large tier emits (hash,
key) order); the row multiset is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.cuda import range_build as rb
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.utils import spans


class RangeTable(NamedTuple):
    """The valid build rows sorted by key, with their bucket directory
    (device tensors; ops/cuda/range_probe.py says how K3/K4 search them).

    keys: (nb_valid,) int64 sortable keys, ascending, equal keys in build
    row order; values: their (vh, vl) value planes in the same order as one
    (nb_valid, 2) int32 tensor, or None for a count; dir: 2^p + 1 offsets
    (rp.dir_dtype), dir[b] the first index of a key whose
    (u64)(key - keys[0]) >> shift is at least b, or None up to
    rp.SMALL_TABLE keys; shift: that shift, a 0-d int64 tensor, or None.
    """

    keys: torch.Tensor
    values: torch.Tensor | None
    dir: torch.Tensor | None
    shift: torch.Tensor | None


def _no_special(dev) -> torch.Tensor:
    return torch.zeros(4, dtype=torch.int64, device=dev)


def build_range_table(kh, kl, vh, vl, nb_valid: int, *,
                      with_values: bool) -> RangeTable:
    """Sort the first nb_valid build rows by their u64 key (stable), with
    their values where with_values, then build the bucket directory over
    the sorted keys if the table needs one."""
    with spans.span(spans.PARTITIONED_BUILD):
        keys, values = rb.range_build(kh, kl, vh, vl, nb_valid,
                                      with_values=with_values)
        p = rp.directory_bits(nb_valid)
        dir_, shift = rp.range_directory(keys, p) if p else (None, None)
        return RangeTable(keys, values, dir_, shift)


def range_join_count(kh, kl, vh, vl, ph, pl, nb_valid: int, np_valid: int):
    """Fused build + probe count.  Returns (count, special4), 0-d and (4,)
    int64 tensors; special is all zeros (never unresolved)."""
    table = build_range_table(kh, kl, vh, vl, nb_valid, with_values=False)
    with spans.span(spans.PARTITIONED_PROBE):
        count = rp.range_probe_count(table, ph, pl, np_valid)
    return count, _no_special(count.device)


def range_join_count_chunked(kh, kl, vh, vl, ph, pl, nb_valid: int,
                             np_valid: int, *, n_chunks: int):
    """Count with the table built ONCE and the resident probe planes read
    in n_chunks chunks of ceil(len(ph) / n_chunks) rows, as the JAX
    package chunks them.  K3 launches once for each chunk that holds a
    valid row, on views of the planes (no copy, no padding) with the
    chunk's valid rows clipped from np_valid; the counts add up on the
    device, with no host sync between chunks.  Returns (count, special4)
    like range_join_count.

    The JAX function chunks so that its transients (the probe sort and
    tile padding) scale with the chunk and not the probe side; the port's
    count has no such transients (8.0 B a probe row, PERF.md §2).  On the
    card it builds the table once for many probe chunks, where the host
    chunk stream (api.py) builds one a chunk.  It takes none of the JAX
    layout arguments (C, tile_m, W, narrow, order, w_mult, interpret):
    they size the window and sort order this module does not port, and
    with no window no probe is unresolved, so special[3] is always 0."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be at least 1, got {n_chunks}")
    n = ph.numel()
    if not 0 <= np_valid <= n:
        raise ValueError(f"np_valid must be in [0, {n}], got {np_valid}")
    table = build_range_table(kh, kl, vh, vl, nb_valid, with_values=False)
    with spans.span(spans.PARTITIONED_PROBE):
        count = torch.zeros((), dtype=torch.int64, device=table.keys.device)
        per_chunk = max(-(-n // n_chunks), 1)
        for base in range(0, np_valid, per_chunk):
            end = base + per_chunk
            count += rp.range_probe_count(table, ph[base:end], pl[base:end],
                                          min(per_chunk, np_valid - base))
    return count, _no_special(count.device)


def range_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid: int,
                           np_valid: int):
    """Fused build + probe materialize: (count, out_kh, out_kl, out_vh,
    out_vl, special4).  The matched rows come first in probe order; the
    planes are int32 bit patterns of the probe side's length."""
    table = build_range_table(kh, kl, vh, vl, nb_valid, with_values=True)
    with spans.span(spans.PARTITIONED_PROBE):
        hit, mvh, mvl = rp.range_probe_materialize(table, ph, pl, np_valid)
    count, outs = compact_by_mask(hit, (ph, pl, mvh, mvl))
    return (count, *outs, _no_special(count.device))
