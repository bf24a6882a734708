"""The `global` tier's walk in slice order, written out as the CUDA kernels
run it (csrc/hash_walk.cu over csrc/partition.cuh): a numpy model of the
partitioned walk.  It must equal the scalar walk (one probe at a time,
tests/test_torch_hash_walk.py), the port's plain walk (ops/hash_table.py),
which the CPU takes, and the JAX package's probe_count / probe_materialize
on the CPU, exactly: counts, hit masks, u32 value planes and each row's
groups visited, on every case of models/workload.global_walk_cases, at 0
and 1 levels, at the plan's choice (with the card's L2 and with none, so
that the plan partitions these small tables), and with passes of 1000
rows, so that the pass loop runs.

The model: the valid rows [0, n_valid) in passes of pass_rows; in a pass,
a u64-max row gets no record, the rest move to the partition of the top
pbits bits of their home group (after pre_shift), in an arbitrary order
inside each partition (a seeded shuffle, as the kernel's shared-memory
atomics leave it), and each row's record position is its dest; the
records walk in record order, each bounded by max_iters groups alone;
then each row of the pass takes its answer through dest (special's for a
u64-max row), rows at or past n_valid none; the count adds the records'
hits and has_max for each u64-max row.  (The kernels keep dest chunk by
chunk of the scatter, in its stage order, so that the restore reads the
answers in runs; that is the same permutation.)

Inputs come from numpy seeds, handed to both packages.  Tolerance: exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from flash_hash_join_tpu.ops import hash_table as jht
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models.workload import global_walk_cases
from flash_hash_join_tpu_torch.ops import hash_table as tht
from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.test_torch_hash_walk import _static, _tables, scalar_walk

M32 = 0xFFFFFFFF
NONE = -1
CASES = global_walk_cases()
BY_NAME = {c.name: c for c in CASES}


def _hash(kh: np.ndarray, kl: np.ndarray) -> np.ndarray:
    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    return fmix32(fmix32(kl.astype(np.uint32)) ^
                  (kh.astype(np.uint32) * np.uint32(0x9E3779B9)))


def _bloom_word(h: np.ndarray, k: int) -> np.ndarray:
    g = (h * np.uint32(0x9E3779B9) + np.uint32(1)).astype(np.int64)
    word = np.zeros(h.shape, np.int64)
    for i in range(k):
        word |= np.int64(1) << ((g >> (5 * i)) & 31)
    return word


def _home(h: np.ndarray, gbits: int, pre_shift: int) -> np.ndarray:
    h = h.astype(np.int64)
    return ((h << pre_shift) & M32) >> (32 - gbits)


def walk_records(tables, kh, kl, *, gbits, group_size, total_groups,
                 use_bloom, bloom_k, max_iters, pre_shift):
    """The walk of records (kh, kl), none of them u64-max, each bounded by
    max_iters groups alone: (hit, vh, vl, groups visited) per record."""
    keys, vals, bloom = tables
    G, n = group_size, kh.size
    h = _hash(kh, kl)
    g = _home(h, gbits, pre_shift)
    active = np.full(n, max_iters > 0)
    if use_bloom:
        tag = _bloom_word(h, bloom_k)
        active &= (bloom[g] & tag) == tag
    hit = np.zeros(n, bool)
    vh, vl, visits = (np.zeros(n, np.int64) for _ in range(3))
    for _ in range(max_iters):
        idx = np.flatnonzero(active)
        if idx.size == 0:
            break
        row = keys[g[idx]]
        eq = (row[:, :G] == kh[idx, None]) & (row[:, G:] == kl[idx, None])
        found = eq.any(1)
        j = eq.argmax(1)                  # the lowest matching slot
        empty = ((row[:, :G] == M32) & (row[:, G:] == M32)).any(1)
        visits[idx] += 1
        f, jf = idx[found], j[found]
        hit[f] = True
        vh[f], vl[f] = vals[g[f], jf], vals[g[f], G + jf]
        done = found | empty | (g[idx] + 1 >= total_groups)
        active[idx[done]] = False
        g[idx[~done]] += 1
    return hit, vh, vl, visits


def slice_model(table, pk: np.ndarray, n_valid: int, static: dict,
                pbits: int, pass_rows: int, seed: int = 0):
    """The kernels' partitioned walk: (count, hit, vh, vl, visits) over the
    probe rows, in probe order.  pbits 0: the walk in probe order."""
    rng = np.random.default_rng(seed)
    tables = tuple(tu64.widen(t).numpy()
                   for t in (table.keys, table.vals, table.bloom))
    has_max, max_vh, max_vl, _ = tu64.widen(table.special).tolist()
    n = pk.size
    kh = (pk >> np.uint64(32)).astype(np.int64)
    kl = (pk & np.uint64(M32)).astype(np.int64)
    hit = np.zeros(n, bool)
    vh, vl, visits = (np.zeros(n, np.int64) for _ in range(3))
    count = 0
    for p0 in range(0, max(0, min(n_valid, n)), pass_rows):
        rows = np.arange(p0, min(p0 + pass_rows, n_valid))
        is_max = (kh[rows] == M32) & (kl[rows] == M32)
        recs = rows[~is_max]
        if pbits:
            h = _hash(kh[recs], kl[recs])
            digit = _home(h, static["gbits"], static["pre_shift"]) >> (
                static["gbits"] - pbits)
            recs = recs[np.lexsort((rng.random(recs.size), digit))]
        dest = np.full(rows.size, NONE)
        dest[recs - p0] = np.arange(recs.size)
        r_hit, r_vh, r_vl, r_vis = walk_records(tables, kh[recs], kl[recs],
                                                **static)
        visits[recs] = r_vis
        d = dest                          # the restore, in probe order
        on = d != NONE
        hit[rows[on]] = r_hit[d[on]]
        vh[rows[on]], vl[rows[on]] = r_vh[d[on]], r_vl[d[on]]
        hit[rows[~on]] = has_max > 0
        vh[rows[~on]] = max_vh if has_max > 0 else 0
        vl[rows[~on]] = max_vl if has_max > 0 else 0
        count += int(r_hit.sum()) + (has_max > 0) * int(is_max.sum())
    return count, hit, vh, vl, visits


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """A case's port table and static arguments, its valid rows, and the
    scalar walk's, the plain walk's and the JAX package's answers."""
    case = BY_NAME[name]
    static = _static(case.cfg, case.gbits, case.use_bloom, case.pre_shift)
    jt, tt = _tables(case.build_keys, case.build_values, case.cfg,
                     case.gbits, case.use_bloom, case.pre_shift)
    pk = case.probe_keys
    n_valid = pk.size if case.n_valid is None else case.n_valid
    scalar = scalar_walk(tt, pk, n_valid, **static)
    ph, pl = ju64.split_u64(pk)
    tph, tpl = tu64.to_device(ph, "cpu"), tu64.to_device(pl, "cpu")
    kw = dict(probe_chunk=256, **static)
    phit, pvh, pvl = tht.probe_rows(tt, tph, tpl, n_valid, **kw)
    plain = (int(tht.probe_count(tt, tph, tpl, n_valid, **kw)),
             phit.numpy(), tu64.widen(pvh).numpy(), tu64.widen(pvl).numpy())
    jargs = (jnp.asarray(ph), jnp.asarray(pl), n_valid)
    jout = jht.probe_materialize(jt, *jargs, **kw)
    c = int(jout[0])
    jax = (int(jht.probe_count(jt, *jargs, **kw)), c,
           ju64.join_u64(np.asarray(jout[1]), np.asarray(jout[2]))[:c],
           ju64.join_u64(np.asarray(jout[3]), np.asarray(jout[4]))[:c])
    return tt, static, n_valid, scalar, plain, jax


def _plan_l2(c, static, l2_bytes):
    return hw.plan(c.probe_keys.size if c.n_valid is None else c.n_valid,
                   static["gbits"], static["total_groups"],
                   static["group_size"], static["use_bloom"], True,
                   l2_bytes=l2_bytes)


# the model's routes: 0 levels, 1 level of up to 3 digit bits, the plan
# (the card's L2, which takes 0 levels here, and no L2, which partitions),
# and 2 digit bits in passes of 1000 rows
VARIANTS = {
    "levels0": lambda c, s: (0, hw.PASS_ROWS),
    "levels1": lambda c, s: (min(3, c.gbits), hw.PASS_ROWS),
    "plan": lambda c, s: _plan_l2(c, s, hw.L2_BYTES)[:2],
    "plan_no_l2": lambda c, s: _plan_l2(c, s, 0)[:2],
    "passes_of_1000": lambda c, s: (min(2, c.gbits), 1000),
}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_slice_model_equals_scalar_plain_and_jax(case, variant):
    tt, static, n_valid, scalar, plain, jax = _reference(case.name)
    pbits, pass_rows = VARIANTS[variant](case, static)
    count, hit, vh, vl, visits = slice_model(tt, case.probe_keys, n_valid,
                                             static, pbits, pass_rows)
    for got, want, what in zip((hit, vh, vl, visits), scalar,
                               ("hit", "vh", "vl", "visits")):
        np.testing.assert_array_equal(got, want, err_msg=f"scalar {what}")
    assert count == plain[0] == jax[0] == int(hit.sum())
    for got, want, what in zip((hit, vh, vl), plain[1:], ("hit", "vh", "vl")):
        np.testing.assert_array_equal(got, want, err_msg=f"plain {what}")
    c = jax[1]
    assert c == count
    np.testing.assert_array_equal(case.probe_keys[hit], jax[2])
    np.testing.assert_array_equal(
        (vh[hit].astype(np.uint64) << np.uint64(32)) | vl[hit].astype(
            np.uint64), jax[3])


def test_slice_model_ignores_the_order_inside_a_partition():
    # the scatter's shared atomics leave a partition's records in any order
    for name in ("zipf_1_2_bloom", "slice_chains", "u64_max_partitioned"):
        case = BY_NAME[name]
        tt, static, n_valid, *_ = _reference(name)
        runs = [slice_model(tt, case.probe_keys, n_valid, static, 2, 700,
                            seed=s) for s in (1, 2)]
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1:], runs[1][1:]):
            np.testing.assert_array_equal(a, b)


def test_cases_cover_the_slice_edges():
    # what the new cases are there for, read off their tables and probes
    def homes(name):
        case = BY_NAME[name]
        pk = case.probe_keys
        h = _hash((pk >> np.uint64(32)).astype(np.int64),
                  (pk & np.uint64(M32)).astype(np.int64))
        return case, _home(h, case.gbits, case.pre_shift)

    case, home = homes("slice_chains")
    tt = _reference("slice_chains")[0]
    keys = tu64.widen(tt.keys).numpy()
    assert (keys[-1] != M32).all()                 # the last group is full
    visits = _reference("slice_chains")[3][3]
    # a walk from the last group of a 2-, 4- and 8-group slice runs on
    for last in (1, 3, 7):
        assert visits[home == last].max() >= 2, last
    case, home = homes("one_slice")
    assert home.max() < 4 and case.gbits - 3 >= 2  # one digit at 1-3 bits
    case = BY_NAME["zipf_1_2"]
    _, counts = np.unique(case.probe_keys, return_counts=True)
    assert counts.max() > 1_000                    # a hot key
    case = BY_NAME["u64_max_partitioned"]
    assert (case.probe_keys == np.uint64(2**64 - 1)).sum() == 400
    assert int(_reference(case.name)[0].special[0]) == 1
    case = BY_NAME["n_valid_pass_cut"]
    assert case.n_valid % 1000 and case.n_valid < case.probe_keys.size


def test_plan_sizes_the_slices():
    G, mb = 8, 2**20
    # J1 1e8 Q5 (2^25 + 64 groups) and config #2 (2^22 + 64), 1e8 probes
    for n, gbits in ((10**8, 25), (10**8, 22)):
        tg = (1 << gbits) + 64
        for bloom in (False, True):
            for mat in (False, True):
                p = hw.plan(n, gbits, tg, G, bloom, mat, l2_bytes=50 * mb)
                walked = hw.walked_bytes(tg, G, bloom, mat)
                assert 1 <= p.pbits <= hw.MAX_PBITS
                assert p.pbits == hw.MAX_PBITS or \
                    walked / 2**p.pbits <= hw.SLICE_BYTES < \
                    walked / 2**(p.pbits - 1)
                assert p.pass_rows == n and p.blocks == 4 * 132
    assert hw.plan(10**8, 25, (1 << 25) + 64, G, False, False).pbits == 7
    assert hw.plan(10**8, 22, (1 << 22) + 64, G, False, False).pbits == 5
    # planes that fit in half of L2, or too few probes a group: 0 levels
    assert hw.plan(10**8, 18, 2**18 + 64, G, False, False).pbits == 0
    tg = (1 << 25) + 64
    few = int(hw.MIN_PROBES_PER_GROUP * tg) - 1
    assert hw.plan(few, 25, tg, G, False, False).pbits == 0
    assert hw.plan(few + 1, 25, tg, G, False, False).pbits > 0
    assert hw.plan(0, 25, tg, G, False, False).pbits == 0
    # a long probe side in passes; overrides, pbits at most gbits
    p = hw.plan(10**9, 25, tg, G, False, False, sms=100)
    assert p.pass_rows == hw.PASS_ROWS and p.blocks == 400
    assert hw.plan(5, 2, 4, G, False, False, pbits=7, pass_rows=3) == \
        hw.Plan(2, 3, 1)


def test_plan_prunes_a_count_with_bloom_whose_words_fit_in_l2():
    G, mb = 8, 2**20
    # config #3 (2^22 + 64 groups: 16.8 MB of u32 words) and 2^23 + 64
    # groups (33.6 MB) prune; 2^24 + 64 and J1 1e8 Q5's 2^25 + 64 groups
    # (67 and 134 MB) test the bloom slice by slice
    c3 = (10**9, 22, (1 << 22) + 64, G)
    assert hw.plan(*c3, True, False, l2_bytes=50 * mb).prune
    assert hw.plan(2 * 10**8, 23, (1 << 23) + 64, G, True, False,
                   l2_bytes=50 * mb).prune
    for gbits in (24, 25):
        assert not hw.plan(10**9, gbits, (1 << gbits) + 64, G, True, False,
                           l2_bytes=50 * mb).prune
    # three quarters of L2 is the edge: 4 B a group
    tg = int(hw.PRUNE_L2_SHARE * 50 * mb) // 4
    assert hw.plan(10**9, 22, tg, G, True, False, l2_bytes=50 * mb).prune
    assert not hw.plan(10**9, 22, tg + 1, G, True, False,
                       l2_bytes=50 * mb).prune
    # never without bloom, for materialize or at 0 levels
    assert not hw.plan(*c3, False, False, l2_bytes=50 * mb).prune
    assert not hw.plan(*c3, True, True, l2_bytes=50 * mb).prune
    assert not hw.plan(*c3, True, False, l2_bytes=50 * mb, pbits=0).prune
    # the override, held to the same three
    assert not hw.plan(*c3, True, False, l2_bytes=50 * mb,
                       prune=False).prune
    assert hw.plan(10**8, 25, (1 << 25) + 64, G, True, False,
                   l2_bytes=50 * mb, prune=True).prune
    assert not hw.plan(*c3, True, True, prune=True).prune
    assert not hw.plan(*c3, False, False, prune=True).prune


def test_forced_plan_is_restored():
    with hw.forced(pbits=2, pass_rows=10):
        assert hw._forced == dict(pbits=2, pass_rows=10)
        with hw.forced(pbits=0):
            assert hw._forced == dict(pbits=0, pass_rows=10)
    assert hw._forced == {}
