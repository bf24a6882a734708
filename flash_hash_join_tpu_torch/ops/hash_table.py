"""The `global` tier: an open-addressing hash table in device memory, built
by sorting and probed by a bounded group walk (port of
flash_hash_join_tpu/ops/hash_table.py).  Build and probe dispatch on the
device.  CUDA tensors launch the build kernel (ops/cuda/hash_build.py: the
rows partitioned by home group into tiles, each finished in shared memory
with a look-back for its carry, no host sync)
and the walk kernels (ops/cuda/hash_walk.py: by its plan, a walk in
probe order, or passes whose probes are partitioned by table slice and
walked slice by slice, no host sync).  CPU tensors take the plain versions
here: the build by two stable sorts, a cummax and a segmented scan
(build_table_plain), the walk in chunks of probe_chunk rows with a host
sync a walk step.

Semantics (SURVEY.md §3, hash_join.cpp:75-204): linear probing over
groups of G slots at a load of at most ~0.5; one winner per duplicate
build key (the first in (home, key) sort order, which the stable sorts
make the minimum build row); at most one match per probe row; a key whose
chain would run past the table, or past `max_probe_iters` groups, is
dropped and counted in special[3], and the caller reruns on `merge`.

Layout, as in the JAX package: group g's slots are one row of 2G words,
[hi_0 .. hi_{G-1}, lo_0 .. lo_{G-1}], for the keys and for the values.
Tables and outputs are int32 bit-pattern planes (utils/u64.py); the
build works on widened int64 values.  Empty slots hold the u64-max key; a
real u64-max key is never stored and is answered through `special`:
[has_max, max_val_hi, max_val_lo, n_dropped] (int64 in [0, 2^32)).
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.cuda import hash_build, hash_walk
from flash_hash_join_tpu_torch.ops.hashing import bloom_word, hash_u64
from flash_hash_join_tpu_torch.ops.segmented import (cummax, seg_ends,
                                                    segmented_scan)
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen

_NEG_LARGE = -(2 ** 30)


class WalkStats:
    """Statistics of the walks run in this process since reset(), read by
    chip_smoke.py: `chunks` (walks run: a plain chunk, or one call of a
    walk kernel's wrapper over a whole probe side), `probes` (valid probe
    rows handed to the walk), `groups` (groups visited, summed over them),
    `longest` (the most groups one probe visited) and `groups_per_probe`,
    from read().
    The kernel and the plain walk add into a (2,) int64 tensor a device
    ([groups, longest]) with no host sync; read() syncs, so call it after
    the timed calls."""

    def __init__(self):
        self._lock = threading.Lock()   # the distributed tier walks a rank a thread
        self._host, self._dev = {"chunks": 0, "probes": 0}, {}

    def reset(self) -> None:
        with self._lock:
            for t in self._dev.values():        # no walk still writes one
                if t.device.type == "cuda":
                    torch.cuda.synchronize(t.device)
            self._host, self._dev = {"chunks": 0, "probes": 0}, {}

    def add(self, dev: torch.device, chunks: int, probes: int) -> torch.Tensor:
        """Count a walk's chunks and probes; returns the device's tensor."""
        with self._lock:
            self._host["chunks"] += chunks
            self._host["probes"] += probes
            t = self._dev.get(dev)
            if t is None:
                t = self._dev[dev] = torch.zeros(2, dtype=torch.int64,
                                                 device=dev)
                if dev.type == "cuda":   # zeroed before another stream adds
                    torch.cuda.current_stream(dev).synchronize()
            return t

    def add_plain(self, t: torch.Tensor, visits: torch.Tensor) -> None:
        """The plain walk's visits (a probe's groups) into its tensor."""
        with self._lock:
            t[0] += visits.sum()
            t[1] = torch.maximum(t[1], visits.max())

    def read(self) -> dict:
        groups = longest = 0
        with self._lock:
            out = dict(self._host)
            for t in self._dev.values():
                g, m = t.tolist()
                groups, longest = groups + g, max(longest, m)
        return {**out, "groups": groups, "longest": longest,
                "groups_per_probe": groups / out["probes"] if out["probes"]
                else 0.0}


walk_stats = WalkStats()


class HashTable(NamedTuple):
    """keys, vals: (total_groups, 2G) int32 bit patterns, hi words then lo
    words; bloom: (total_groups,) int64 bloom words, or zeros((1,)) when
    off; special: (4,) int64."""

    keys: torch.Tensor
    vals: torch.Tensor
    bloom: torch.Tensor
    special: torch.Tensor


def home_group(h: torch.Tensor, gbits: int, pre_shift: int = 0) -> torch.Tensor:
    """Home group from the top gbits of the u32 hash h (int64 in [0, 2^32))
    after discarding its top pre_shift bits."""
    return ((h << pre_shift) & MASK32) >> (32 - gbits)


def _is_max(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """u64-max keys, from widened planes."""
    return (hi == MASK32) & (lo == MASK32)


def sort_rows(seg: torch.Tensor, kh: torch.Tensor, kl: torch.Tensor):
    """The permutation that sorts rows stably by (seg, u64 key): torch.sort
    takes one key, so sort by the key, then stably by seg.  kh, kl widened."""
    key = (kh - 2**31) * 2**32 + kl          # signed order == u64 order
    order = torch.sort(key, stable=True).indices
    return order[torch.sort(seg[order], stable=True).indices]


def max_key_special(kh, kl, vh, vl, row_valid):
    """(has_max, first u64-max row's vh, vl) as int64 scalars; widened
    planes."""
    is_max = _is_max(kh, kl) & row_valid
    has_max = is_max.any()
    first = torch.argmax(is_max.to(torch.uint8))   # 0 when there is none
    return (has_max.to(torch.int64), torch.where(has_max, vh[first], 0),
            torch.where(has_max, vl[first], 0))


def build_table(kh, kl, vh, vl, n_valid: int, *, gbits: int, group_size: int,
                overflow_groups: int, with_bloom: bool, bloom_k: int = 3,
                pre_shift: int = 0,
                max_probe_iters: int | None = None) -> HashTable:
    """Build the table from the first n_valid rows of the key and value
    planes (int32 bit patterns, or widened on the CPU).  CUDA tensors: the
    build kernel, on the planes' current stream with no host sync (a
    failed build or launch raises); CPU tensors: build_table_plain."""
    kw = dict(gbits=gbits, group_size=group_size,
              overflow_groups=overflow_groups, with_bloom=with_bloom,
              bloom_k=bloom_k, pre_shift=pre_shift,
              max_probe_iters=max_probe_iters)
    with spans.span(spans.GLOBAL_BUILD):
        if kh.device.type == "cuda":
            return HashTable(*hash_build.global_build_table(kh, kl, vh, vl,
                                                            n_valid, **kw))
        return build_table_plain(kh, kl, vh, vl, n_valid, **kw)


def build_table_plain(kh, kl, vh, vl, n_valid: int, *, gbits: int,
                      group_size: int, overflow_groups: int,
                      with_bloom: bool, bloom_k: int = 3, pre_shift: int = 0,
                      max_probe_iters: int | None = None) -> HashTable:
    """Plain version of the build kernel, on any device: the JAX package's
    sort-built table (planes int32 bit patterns or widened; an empty side
    gives the empty table, where the JAX build refuses an argmax of no
    rows)."""
    n, dev = kh.shape[0], kh.device
    G = group_size
    ntot = (1 << gbits) + overflow_groups
    if n == 0:
        return HashTable(
            torch.full((ntot, 2 * G), -1, dtype=torch.int32, device=dev),
            torch.zeros((ntot, 2 * G), dtype=torch.int32, device=dev),
            torch.zeros(ntot if with_bloom else 1, dtype=torch.int64,
                        device=dev),
            torch.zeros(4, dtype=torch.int64, device=dev))
    row_valid = torch.arange(n, device=dev) < n_valid
    kh = torch.where(row_valid, widen(kh), MASK32)
    kl = torch.where(row_valid, widen(kl), MASK32)
    vh, vl = widen(vh), widen(vl)
    has_max, max_vh, max_vl = max_key_special(kh, kl, vh, vl, row_valid)

    h = hash_u64(kh, kl)
    home = home_group(h, gbits, pre_shift)
    order = sort_rows(home, kh, kl)
    home_s, kh_s, kl_s, h_s = home[order], kh[order], kl[order], h[order]

    # the first occurrence of each key, without the u64-max key, is placed
    is_max_s = _is_max(kh_s, kl_s)
    first_occ = torch.ones(n, dtype=torch.bool, device=dev)
    first_occ[1:] = (kh_s[1:] != kh_s[:-1]) | (kl_s[1:] != kl_s[:-1])
    keep = first_occ & ~is_max_s

    # linear-probe slot of kept row i: rank_i + cummax(home_slot - rank)
    rank = torch.cumsum(keep, 0) - 1
    cand = torch.where(keep, home_s * G - rank, _NEG_LARGE)
    slot = rank + cummax(cand)
    in_range = slot < ntot * G
    place = keep & in_range
    n_dropped = (keep & ~in_range).sum()
    if max_probe_iters is not None:
        # a key whose chain spans max_probe_iters groups is out of the
        # bounded walk's reach: count it as dropped so the caller reruns
        n_dropped += (place & (slot // G - home_s >= max_probe_iters)).sum()

    slot = slot[place]
    flat_hi = (slot // G) * (2 * G) + slot % G
    planes = {}
    for name, fill, hi, lo in (("keys", -1, kh_s, kl_s),
                               ("vals", 0, vh[order], vl[order])):
        flat = torch.full((ntot * 2 * G,), fill, dtype=torch.int32,
                          device=dev)
        flat[flat_hi] = narrow(hi[place])
        flat[flat_hi + G] = narrow(lo[place])
        planes[name] = flat.view(ntot, 2 * G)

    if with_bloom:
        # per-group OR of the kept rows' signatures: a segmented scan over
        # the rows sorted by home group, read at each group's last row
        tag = torch.where(is_max_s, 0, bloom_word(h_s, bloom_k))
        tag_scan, = segmented_scan(lambda a, b: (a[0] | b[0],), (tag,),
                                   home_s)
        ends = seg_ends(home_s)
        bloom = torch.zeros(ntot, dtype=torch.int64, device=dev)
        bloom[home_s[ends]] = tag_scan[ends]
    else:
        bloom = torch.zeros(1, dtype=torch.int64, device=dev)
    special = torch.stack([has_max, max_vh, max_vl, n_dropped])
    return HashTable(planes["keys"], planes["vals"], bloom, special)


def _probe_chunk_state(table: HashTable, ph, pl, valid, *, gbits: int,
                       group_size: int, total_groups: int, use_bloom: bool,
                       bloom_k: int, max_iters: int, pre_shift: int = 0):
    """Resolve one chunk of probe rows (int32 planes): returns (matched,
    g_found, j_found, sp_match, visits).  The walk visits one group per
    iteration for every row not yet done, at most max_iters times; visits
    counts the groups each row visited."""
    G = group_size
    wph, wpl = widen(ph), widen(pl)
    h = hash_u64(wph, wpl)
    g = home_group(h, gbits, pre_shift)

    is_max = _is_max(wph, wpl)
    sp_match = is_max & (table.special[0] > 0) & valid
    done = ~valid | is_max
    if use_bloom:
        tag = bloom_word(h, bloom_k)
        done |= (table.bloom[g] & tag) != tag
    matched = torch.zeros_like(done)
    g_found = torch.zeros_like(g)
    j_found = torch.zeros_like(g)
    visits = torch.zeros_like(g)
    it = 0
    while it < max_iters and not bool(done.all()):
        window = table.keys[g]                     # (n, 2G): one row a probe
        wh, wl = window[:, :G], window[:, G:]
        eq = (wh == ph[:, None]) & (wl == pl[:, None])
        found = eq.any(1)
        has_empty = ((wh == -1) & (wl == -1)).any(1)
        visits += ~done
        new_found = ~done & found
        matched |= new_found
        g_found = torch.where(new_found, g, g_found)
        j_found = torch.where(new_found, torch.argmax(eq.to(torch.uint8), 1),
                              j_found)
        g_next = torch.clamp(g + 1, max=total_groups - 1)
        done |= found | has_empty | (g_next == g)  # off the end: absent
        g = torch.where(done, g, g_next)
        it += 1
    return matched, g_found, j_found, sp_match, visits


def _chunks(n: int, n_valid: int, probe_chunk: int, dev):
    """(start, stop, valid mask) of each probe chunk."""
    for start in range(0, n, probe_chunk):
        stop = min(start + probe_chunk, n)
        yield start, stop, torch.arange(start, stop, device=dev) < n_valid


def _walk_plain(table: HashTable, ph, pl, n_valid: int, probe_chunk: int,
                static: dict):
    """The plain walk over the probe side, chunk by chunk: yields each
    chunk's (matched, g_found, j_found, sp_match), and adds its visits to
    walk_stats."""
    dev = ph.device
    stats = walk_stats.add(dev, -(-ph.shape[0] // probe_chunk), n_valid)
    for start, stop, valid in _chunks(ph.shape[0], n_valid, probe_chunk,
                                      dev):
        *state, visits = _probe_chunk_state(
            table, ph[start:stop], pl[start:stop], valid, **static)
        walk_stats.add_plain(stats, visits)
        yield state


def _kernel_args(ph, pl, n_valid: int, static: dict):
    """The walk kernel's probe arguments: contiguous planes, the probe
    count and the walk statistics' tensor."""
    stats = walk_stats.add(ph.device, 1, n_valid)
    return (ph.contiguous(), pl.contiguous(), n_valid), dict(static,
                                                             stats=stats)


def probe_count_plain(table: HashTable, ph, pl, n_valid: int, *,
                      probe_chunk: int, **static) -> torch.Tensor:
    """Plain version of the walk kernel's count, on any device: the walk
    in chunks of probe_chunk rows, a host sync a walk step."""
    total = torch.zeros((), dtype=torch.int64, device=ph.device)
    for matched, _, _, sp_match in _walk_plain(table, ph, pl, n_valid,
                                               probe_chunk, static):
        total += (matched | sp_match).sum()
    return total


def probe_rows_plain(table: HashTable, ph, pl, n_valid: int, *,
                     probe_chunk: int, **static):
    """Plain version of the walk kernel's materialize, on any device:
    (hit, vh, vl) as probe_rows gives them."""
    G = static["group_size"]
    flat_vals = table.vals.view(-1)
    max_vh, max_vl = narrow(table.special[1:3])
    hits, vhs, vls = [], [], []
    for matched, g_found, j_found, sp_match in _walk_plain(
            table, ph, pl, n_valid, probe_chunk, static):
        at = g_found * (2 * G) + j_found
        hits.append(matched | sp_match)
        vhs.append(torch.where(sp_match, max_vh,
                               torch.where(matched, flat_vals[at], 0)))
        vls.append(torch.where(sp_match, max_vl,
                               torch.where(matched, flat_vals[at + G], 0)))
    if not hits:
        return ph[:0].bool(), ph[:0], pl[:0]
    return torch.cat(hits), torch.cat(vhs), torch.cat(vls)


def probe_count(table: HashTable, ph, pl, n_valid: int, *, probe_chunk: int,
                **static) -> torch.Tensor:
    """Count the probe rows [0, n_valid) whose key is in the table (probe
    multiplicity counts, build multiplicity does not); a 0-d int64.  CUDA
    tensors: the walk kernels on ops/cuda/hash_walk.plan's route (the
    probes in probe order, or partitioned by table slice and walked slice
    by slice), no host sync; CPU tensors: the plain walk
    (probe_count_plain)."""
    with spans.span(spans.GLOBAL_WALK):
        if ph.device.type == "cuda":
            args, kw = _kernel_args(ph, pl, n_valid, static)
            return hash_walk.global_walk_count(table, *args, **kw)
        return probe_count_plain(table, ph, pl, n_valid,
                                 probe_chunk=probe_chunk, **static)


def probe_rows(table: HashTable, ph, pl, n_valid: int, *, probe_chunk: int,
               **static):
    """Per probe row: (hit, vh, vl), a bool mask and the int32 value planes
    of the row's match (the first-match slot's value, special[1:3] for a
    u64-max probe; 0 on a miss and at or past n_valid), in probe order.
    CUDA tensors: the walk kernels on ops/cuda/hash_walk.plan's route (a
    partitioned walk's answers put back in probe order on the card); CPU
    tensors: the plain walk (probe_rows_plain)."""
    with spans.span(spans.GLOBAL_WALK):
        if ph.device.type == "cuda":
            args, kw = _kernel_args(ph, pl, n_valid, static)
            return hash_walk.global_walk_materialize(table, *args, **kw)
        return probe_rows_plain(table, ph, pl, n_valid,
                                probe_chunk=probe_chunk, **static)


def probe_materialize(table: HashTable, ph, pl, n_valid: int, *,
                      probe_chunk: int, **static):
    """(count, out_kh, out_kl, out_vh, out_vl): the matching probe rows
    with their build value, in probe order, compacted to the front of int32
    planes of the probe side's length (K5 on the card)."""
    if ph.shape[0] == 0:
        empty = ph[:0]
        return torch.zeros((), dtype=torch.int64, device=ph.device), \
            empty, empty, empty, empty
    hit, vh, vl = probe_rows(table, ph, pl, n_valid, probe_chunk=probe_chunk,
                             **static)
    count, outs = compact_by_mask(hit, (ph, pl, vh, vl))
    return (count, *outs)
