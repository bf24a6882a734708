"""The `global` tier's table build, written out as the CUDA kernel builds it
(csrc/hash_build.cu): a numpy model of the tiled algorithm.  It must equal
the JAX package's build_table (a stable sort by (home, key), a cumsum and a
cummax, a segmented bloom scan) and the port's build_table_plain, which the
CPU takes, bit for bit: keys, vals, bloom and special, on every case of
models/workload.global_build_cases, for 0, 1 and 2 partition levels, the
kernel's own plan, and a tile capacity so small that every tile with rows
takes the oversize path.

The model: drop the u64-max rows (the first one's value goes to special);
partition the rest by the top bits of their home group, level by level,
each partition in an arbitrary order (a seeded shuffle, as the kernel's
shared-memory atomics leave it); for each tile, in order, count and order
its rows by group, order each group by (key, row) (a group of more than 32
rows of an oversize tile in sorted chunks merged pairwise) and keep each
key's first row; compose the tile's max-plus step over its groups
({k_b, b * G + k_b}); take the value before the tile by a look-back over a
seeded number of the tiles before it (their steps, then one published
value); place each group's k_b kept rows at consecutive slots from
start_b = max(end_{b-1}, b * G); write every slot of [R_{t-1}, R_t) once
(R_t = max(end_t, (last group of t + 1) * G), the last tile to the end of
the table); a slot past the table, or max_probe_iters groups past home,
counts as dropped (the latter still written); a group's bloom word is the
OR of its kept rows' words.

Inputs come from numpy seeds, handed to both packages.  Tolerance: exact.
"""

import functools
import heapq

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops import hash_table as jht
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.api import launch_counts
from flash_hash_join_tpu_torch.models.workload import global_build_cases
from flash_hash_join_tpu_torch.ops import hash_table as tht
from flash_hash_join_tpu_torch.ops.cuda import hash_build
from flash_hash_join_tpu_torch.utils import u64 as tu64

M32 = 0xFFFFFFFF
M64 = np.uint64(2**64 - 1)
CASES = global_build_cases()


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _hash(keys: np.ndarray) -> np.ndarray:
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(M32)).astype(np.uint32)
    return _fmix32(_fmix32(lo) ^ (hi * np.uint32(0x9E3779B9)))


def _bloom_word(h: np.ndarray, k: int) -> np.ndarray:
    g = (h * np.uint32(0x9E3779B9) + np.uint32(1)).astype(np.uint64)
    word = np.zeros(h.shape, np.uint64)
    for i in range(k):
        word |= np.uint64(1) << ((g >> np.uint64(5 * i)) & np.uint64(31))
    return word


NEG = -(1 << 62)
IDENTITY = (0, NEG)


def then(f, g):
    """Max-plus steps x -> max(x + a, c): f, then g."""
    return f[0] + g[0], max(f[1] + g[0], g[1])


def apply(f, x):
    return max(x + f[0], f[1])


def _chunk_merge_sort(items: list, chunk: int) -> list:
    """An oversize group's order: sorted chunks merged pairwise."""
    runs = [sorted(items[i:i + chunk]) for i in range(0, len(items), chunk)]
    while len(runs) > 1:
        runs = [list(heapq.merge(*runs[i:i + 2]))
                for i in range(0, len(runs), 2)]
    return runs[0] if runs else []


def tiled_model(case, level_bits=None, tile_rows: int = hash_build.TILE_ROWS,
                chunk: int = 2048, seed: int = 0) -> dict:
    """The build kernel's algorithm in numpy: keys, vals (total_groups, 2G),
    bloom and special as int64 arrays of u32 values.  level_bits: the
    partition levels' digit bits (() for none; None: the kernel's plan)."""
    cfg, gbits = case.cfg, case.gbits
    G, ntot = cfg.group_size, (1 << gbits) + cfg.overflow_groups
    n_slots = ntot * G
    n = max(0, min(case.valid_rows(), case.build_keys.size))
    bk, bv = case.build_keys[:n], case.build_values[:n]
    if level_bits is None:
        level_bits = hash_build.plan(n, gbits).level_bits
    rng = np.random.default_rng(seed)
    bloom = np.zeros(ntot if case.use_bloom else 1, np.int64)
    special = np.zeros(4, np.int64)
    slot_row = np.full(n_slots, -1, np.int64)

    is_max = bk == M64
    if is_max.any():                     # the first u64-max row's value
        v = int(bv[np.argmax(is_max)])
        special[:3] = 1, v >> 32, v & M32
    h = _hash(bk)
    home = ((h.astype(np.uint64) << np.uint64(case.pre_shift))
            & np.uint64(M32)) >> np.uint64(32 - gbits)
    home = home.astype(np.int64)

    # the partition levels: each row moves to the partition of its home's
    # top bits so far, in no particular order inside it
    rows = rng.permutation(np.flatnonzero(~is_max))
    pbits = 0
    for bits in level_bits:
        pbits += bits
        part = home[rows] >> (gbits - pbits)
        rows = rows[np.lexsort((rng.random(rows.size), part))]
    tile_bits = gbits - pbits
    tiles = 1 << pbits
    bounds = np.searchsorted(home[rows] >> tile_bits, np.arange(tiles + 1))

    steps, values, written = [], [], np.zeros(n_slots, bool)
    for t in range(tiles):
        tile = rows[bounds[t]:bounds[t + 1]]
        g0 = t << tile_bits
        oversize = tile.size > tile_rows
        # a counting sort by group (a group's rows in arrival order), then
        # each group by (key, row), cut to first occurrences
        tile = tile[np.argsort(home[tile], kind="stable")]
        groups = np.split(tile, np.flatnonzero(np.diff(home[tile])) + 1) \
            if tile.size else []
        kept = {}
        for g in groups:
            items = [(int(bk[r]), int(r)) for r in g]
            order = _chunk_merge_sort(items, chunk) \
                if oversize and len(items) > 32 else sorted(items)
            kept[int(home[g[0]])] = [r for i, (k, r) in enumerate(order)
                                     if i == 0 or k != order[i - 1][0]]
        step = IDENTITY
        for b in sorted(kept):
            k = len(kept[b])
            step = then(step, (k, b * G + k))
        steps.append(step)
        # the look-back: the steps of a seeded number of tiles before this
        # one, then the value after the tile before them (0 before tile 0)
        j = t - int(rng.integers(1, t + 2)) if t else -1
        f = IDENTITY
        for q in range(j + 1, t):
            f = then(f, steps[q])
        before = apply(f, values[j] if j >= 0 else 0)
        values.append(apply(step, before))

        first = min(max(before, g0 * G), n_slots)            # R_{t-1}
        last = n_slots if t == tiles - 1 else \
            min(max(values[t], (g0 + (1 << tile_bits)) * G), n_slots)
        assert not written[first:last].any(), (t, first, last)
        written[first:last] = True
        x = before
        for b in sorted(kept):
            start = max(x, b * G)
            for j, r in enumerate(kept[b]):
                slot = start + j
                if slot >= n_slots:
                    special[3] += 1
                    continue
                assert first <= slot < last, (t, slot, first, last)
                slot_row[slot] = r
                if case.max_probe_iters is not None and \
                        slot // G - b >= case.max_probe_iters:
                    special[3] += 1      # written, but out of the walk's reach
            x = start + len(kept[b])
            if case.use_bloom:
                bloom[b] = int(np.bitwise_or.reduce(
                    _bloom_word(h[kept[b]], cfg.bloom_k)))
    assert written.all()                 # every slot of the table, once

    keys = np.full((ntot, 2 * G), M32, np.int64)
    vals = np.zeros((ntot, 2 * G), np.int64)
    slots = np.flatnonzero(slot_row >= 0)
    r = slot_row[slots]
    g, q = slots // G, slots % G
    k, v = bk[r], bv[r]
    keys[g, q], keys[g, G + q] = k >> np.uint64(32), k & np.uint64(M32)
    vals[g, q], vals[g, G + q] = v >> np.uint64(32), v & np.uint64(M32)
    return dict(keys=keys, vals=vals, bloom=bloom, special=special)


def _planes(case):
    kh, kl = ju64.split_u64(case.build_keys)
    vh, vl = ju64.split_u64(case.build_values)
    return kh, kl, vh, vl


@functools.lru_cache(maxsize=None)
def _jax_table(name: str) -> dict:
    case = BY_NAME[name]
    kw = case.build_kwargs()
    jt = jht.build_table(*(jnp.asarray(a) for a in _planes(case)),
                         case.valid_rows(), **kw)
    return {f: np.asarray(getattr(jt, f)).astype(np.int64)
            for f in ("keys", "vals", "bloom", "special")}


def _port_table(case, fn) -> dict:
    tt = fn(*(tu64.to_device(a, "cpu") for a in _planes(case)),
            case.valid_rows(), **case.build_kwargs())
    return {f: tu64.widen(getattr(tt, f)).numpy()
            for f in ("keys", "vals", "bloom", "special")}


@functools.lru_cache(maxsize=None)
def _plain_table(name: str) -> dict:
    return _port_table(BY_NAME[name], tht.build_table_plain)


def _assert_same(got: dict, want: dict, what: str):
    for f in ("keys", "vals", "bloom", "special"):
        assert got[f].shape == want[f].shape, (what, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")


BY_NAME = {c.name: c for c in CASES}
# the model's partitions: none, one level, two levels (as many bits as the
# case's groups allow), the kernel's plan, and the kernel's plan with a
# tile capacity of 16 rows and sorting chunks of 4 (oversize tiles, merged
# chunks)
VARIANTS = {
    "levels0": lambda c: dict(level_bits=()),
    "levels1": lambda c: dict(level_bits=(min(c.gbits, 2),)),
    "levels2": lambda c: dict(level_bits=(min(c.gbits, 2),
                                          min(max(c.gbits - 2, 0), 3))),
    "plan": lambda c: dict(),
    "oversize": lambda c: dict(tile_rows=16, chunk=4),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_tiled_model_equals_jax_and_plain_build(case, variant):
    model = tiled_model(case, **VARIANTS[variant](case))
    if case.build_keys.size:     # the JAX build refuses an empty side
        _assert_same(model, _jax_table(case.name), "model vs JAX")
    _assert_same(_plain_table(case.name), model, "build_table_plain vs model")


def test_tiled_model_ignores_the_order_inside_a_partition():
    # the kernel's shared-memory atomics leave a partition's and a group's
    # rows in any order, and its look-back stops at any published value
    for name in ("one_large_group_bloom", "pre_shift_2_two_levels",
                 "tile_boundary_chain"):
        case = BY_NAME[name]
        for kw in (dict(), dict(tile_rows=16, chunk=4)):
            _assert_same(tiled_model(case, seed=1, **kw),
                         tiled_model(case, seed=2, **kw), name)


def test_plan_sizes_the_tiles():
    # at most TILE_TARGET rows a tile on average, never more than 2^9 groups
    # or more partition bits than groups; J1 1e8 Q5 and config #2 in two
    # levels, small sides in one
    for n, gbits in ((10**8, 25), (10**7, 22), (6.25e7, 25), (3_000, 10),
                     (0, 4), (5_000, 1), (2_000, 18), (2**31 - 1, 30),
                     (100, 30), (1, 0)):
        n = int(n)
        p = hash_build.plan(n, gbits)
        pbits = sum(p.level_bits)
        assert p.tile_bits == gbits - pbits and 0 <= p.tile_bits <= 9
        assert len(p.level_bits) in (1, 2) and max(p.level_bits) <= 11
        assert len(p.blocks) == len(p.level_bits) and min(p.blocks) >= 1
        assert pbits == gbits or n <= hash_build.TILE_TARGET << pbits
        assert pbits == 0 or pbits == gbits - 9 or \
            n > hash_build.TILE_TARGET << (pbits - 1)
    assert hash_build.plan(10**8, 25) == ((8, 8), (528, 3), 9)
    assert hash_build.plan(10**7, 22) == ((7, 6), (528, 5), 9)
    assert hash_build.plan(3_000, 10).level_bits == (1,)


def test_cases_cover_the_build_edges():
    # what each case is there for, read off the model's table
    by = {c.name: (c, tiled_model(c)) for c in CASES}

    def written(t):
        G = t["keys"].shape[1] // 2
        return int(((t["keys"][:, :G] != M32) | (t["keys"][:, G:] != M32))
                   .sum())

    def slots_of(c, t, homes):
        # the slots of the keys homed to `homes`
        G = c.cfg.group_size
        keys = (t["keys"][:, :G] << 32) | t["keys"][:, G:]
        h = _hash(keys.reshape(-1).astype(np.uint64))
        home = h >> np.uint32(32 - c.gbits)
        return np.flatnonzero(np.isin(home, list(homes)) &
                              (keys.reshape(-1) != -1))

    c, t = by["crowded"]                                   # past the table
    unique = np.unique(c.build_keys).size
    assert written(t) < unique and t["special"][3] == unique - written(t)
    c, t = by["max_probe_iters_2"]          # counted as dropped, yet written
    assert written(t) == np.unique(c.build_keys).size and t["special"][3] > 0
    assert int(by["u64_max_repeated"][1]["special"][0]) == 1
    assert int(by["n_valid_cut"][1]["special"][0]) == 0    # max past the cut
    c, t = by["one_large_group"]
    h = _hash(c.build_keys)
    assert len(set((h >> np.uint32(28)).tolist())) == 1    # one home group
    assert c.build_keys.size > 2048 and t["special"][3] > 0
    assert {c.cfg.group_size for c in CASES} >= {1, 2, 8, 32}
    assert {c.pre_shift for c in CASES} >= {1, 2, 3}
    assert (by["duplicates_bloom"][1]["bloom"] != 0).any()

    # the kernel's tiles: 2^9 groups each at 2^12 groups
    c, t = by["tile_boundary_chain"]
    assert hash_build.plan(c.build_keys.size, c.gbits).tile_bits == 9
    G = c.cfg.group_size
    chain = slots_of(c, t, {511}) // G
    assert chain.max() >= 512 + 8 and t["special"][3] == 0   # into tile 1
    assert (slots_of(c, t, {512, 513, 520}) // G > 520).any()
    c, t = by["tile_into_overflow"]
    assert (slots_of(c, t, {4095}) // c.cfg.group_size >= 4096).any()
    assert t["special"][3] > 0                           # and past the table
    c, t = by["gbits_below_partition"]
    p = hash_build.plan(c.build_keys.size, c.gbits)
    assert p.level_bits == (1,) and p.tile_bits == 0
    h = _hash(c.build_keys)
    assert max(np.bincount(h >> np.uint32(31))) > hash_build.TILE_ROWS
    for s in (1, 2, 3):
        c, t = by[f"pre_shift_{s}_two_levels"]
        assert len(hash_build.plan(c.build_keys.size, c.gbits).level_bits) \
            == 2 and c.pre_shift == s
        assert written(t) == c.build_keys.size
    c, t = by["u64_max_tile"]
    is_max = c.build_keys == M64
    h = _hash(c.build_keys)
    assert is_max.sum() > 500 and t["special"][0] == 1
    assert not np.isin(h[~is_max] >> np.uint32(29),
                       h[is_max][:1] >> np.uint32(29)).any()


def test_build_table_on_cpu_takes_the_plain_build(monkeypatch):
    case = CASES[0]
    calls = []

    def kernel(*a, **kw):
        raise AssertionError("the build kernel was called on CPU tensors")

    def plain(*a, **kw):
        calls.append(1)
        return plain_build(*a, **kw)

    plain_build = tht.build_table_plain
    monkeypatch.setattr(hash_build, "global_build_table", kernel)
    monkeypatch.setattr(tht, "build_table_plain", plain)
    _assert_same(_port_table(case, tht.build_table), tiled_model(case),
                 "build_table on the CPU")
    assert calls == [1]


def test_build_kernel_wrapper_refuses_what_it_does_not_take():
    planes = [torch.zeros(8, dtype=torch.int32) for _ in range(4)]
    kw = dict(gbits=4, group_size=8, overflow_groups=64, with_bloom=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_build.global_build_table(*planes, 8, **kw)
    before = launch_counts()["global_build"]
    tht.build_table(*planes, 8, **kw)                      # the plain build
    assert launch_counts()["global_build"] == before
