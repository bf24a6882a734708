"""Port parity for the partitioned tier: flash_hash_join_tpu_torch's
range_join_count / range_join_materialize against the JAX package's
(ops/range_table.py, Pallas kernels in interpret mode, as
tests/test_range_table.py runs them) and the numpy oracle.

Inputs are numpy arrays from a fixed seed, handed to both packages; the
port runs on CPU tensors, i.e. the plain versions of K3, K4 and K5.
Tolerance: exact.  Counts must be equal everywhere.  Values are compared
with the JAX package only where build keys are unique: its duplicate-key
winner is the minimal value within the probed lane-column, the port's is
the minimum build row (checked against np.unique(return_index=True)).  The
port emits probe order, the JAX large tier (hash, key) order, so pairs are
compared sorted.
"""

import collections
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops import range_table as jrt
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.ops import merge_join as tmj
from flash_hash_join_tpu_torch.ops import range_table as trt
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.oracle import oracle_count

M64 = np.uint64(2**64 - 1)
U32MAX = np.uint64(2**32 - 1)


def _planes(bk, bv, pk):
    return [p for a in (bk, bv, pk) for p in ju64.split_u64(a)]


def _port(fn, bk, bv, pk, nb=None, npr=None):
    args = [tu64.to_device(p, "cpu") for p in _planes(bk, bv, pk)]
    return fn(*args, len(bk) if nb is None else nb,
              len(pk) if npr is None else npr)


def _jax(fn, bk, bv, pk, nb=None, npr=None, **kw):
    args = [jnp.asarray(p) for p in _planes(bk, bv, pk)]
    return fn(*args, jnp.int32(len(bk) if nb is None else nb),
              jnp.int32(len(pk) if npr is None else npr), interpret=True,
              **kw)


def _port_rows(out):
    count = int(out[0])
    return (count, tu64.to_numpy_u64(out[1], out[2], count),
            tu64.to_numpy_u64(out[3], out[4], count), int(out[5][3]))


def _jax_rows(out):
    count = int(out[0])
    keys = ju64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:count]
    vals = ju64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:count]
    return count, keys, vals, int(out[5][3])


def _sorted_pairs(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


def _first_match(bk, bv, pk):
    """numpy oracle rows in probe order, minimum-build-row winner."""
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=max(uniq.size - 1, 0))
    hit = uniq[pos] == pk if uniq.size else np.zeros(pk.size, bool)
    return pk[hit], bv[first[pos[hit]]]


def _case(name):
    """(bk, bv, pk, JAX keyword args) — the cases of
    tests/test_range_table.py, at the two shapes the JAX tests compile
    (3000 x 9000 is its SMALL mode, 20000 x 60000 its windowed mode)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nb, npr = (20_000, 60_000) if name == "random_large" else (3_000, 9_000)
    bk = rng.integers(0, int(nb * 1.5), nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.5), npr, dtype=np.uint64)
    kw = {}
    if name == "match_0":
        bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
        pk = rng.integers(2**63, 2**64 - 2, npr, dtype=np.uint64)
    elif name == "match_100":
        bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
        pk = rng.choice(bk, npr)
    elif name == "sentinel":
        bk[17] = M64
        pk[-9:] = M64
    elif name == "zipf":
        bk = np.minimum(rng.zipf(1.3, nb), 2**40).astype(np.uint64)
        pk = np.minimum(rng.zipf(1.3, npr), 2**40).astype(np.uint64)
    elif name in ("narrow", "narrow_u32max"):
        kw = {"narrow": True}
        if name == "narrow_u32max":
            bk[11] = U32MAX
            pk[-5:] = U32MAX
    return bk, bv, pk, kw


COUNT_CASES = ["random_small", "random_large", "match_0", "match_100",
               "sentinel", "zipf", "narrow", "narrow_u32max"]


@pytest.mark.parametrize("name", COUNT_CASES)
def test_range_join_count_matches_jax_and_oracle(name):
    bk, bv, pk, kw = _case(name)
    count, special = _port(trt.range_join_count, bk, bv, pk)
    jcount, jspecial = _jax(jrt.range_join_count, bk, bv, pk, **kw)
    assert int(jspecial[3]) == 0
    assert special.tolist() == [0, 0, 0, 0] and count.dtype == torch.int64
    assert int(count) == int(jcount) == oracle_count(bk, pk)


def test_range_count_padding_and_nvalid():
    # pad rows hold keys that WOULD match; only the valid prefixes count
    bk, bv, pk, _ = _case("random_small")
    bk, pk = bk.copy(), pk.copy()
    bk[2_000:] = pk[0]
    pk[7_000:] = bk[0]
    count, _ = _port(trt.range_join_count, bk, bv, pk, nb=2_000, npr=7_000)
    jcount, jspecial = _jax(jrt.range_join_count, bk, bv, pk, nb=2_000,
                            npr=7_000)
    assert int(jspecial[3]) == 0
    assert int(count) == int(jcount) == oracle_count(bk[:2_000], pk[:7_000])
    got = _port_rows(_port(trt.range_join_materialize, bk, bv, pk, nb=2_000,
                           npr=7_000))
    want = _first_match(bk[:2_000], bv[:2_000], pk[:7_000])
    assert got[0] == len(want[0])
    np.testing.assert_array_equal(got[1], want[0])
    np.testing.assert_array_equal(got[2], want[1])


def test_range_giant_dup_run_is_exact():
    """The JAX kernel reports unresolved probes here (rank inflation past
    its window) and the engine falls back to merge; the port has no window,
    so it must count exactly with special[3] == 0."""
    nb = 120_000
    bk = np.full(nb, 42, np.uint64)
    bk[:2_000] = np.arange(2_000, dtype=np.uint64) + 100
    bv = np.arange(nb, dtype=np.uint64)
    pk = np.random.default_rng(3).integers(0, 4_000, 50_000, dtype=np.uint64)
    count, special = _port(trt.range_join_count, bk, bv, pk)
    assert int(special[3]) == 0
    assert int(count) == oracle_count(bk, pk)
    got = _port_rows(_port(trt.range_join_materialize, bk, bv, pk))
    want = _first_match(bk, bv, pk)
    np.testing.assert_array_equal(got[1], want[0])
    np.testing.assert_array_equal(got[2], want[1])    # row 2000: value 2000
    assert got[3] == 0


@pytest.mark.parametrize("nb,npr", [(3_000, 9_000), (20_000, 60_000)])
def test_range_materialize_unique_keys_matches_jax(nb, npr):
    rng = np.random.default_rng(nb)
    bk = rng.permutation(np.arange(nb, dtype=np.uint64) * np.uint64(3))
    bk[5] = M64
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    pk = rng.integers(0, 6 * nb, npr, dtype=np.uint64)
    pk[:4] = M64
    got = _port_rows(_port(trt.range_join_materialize, bk, bv, pk))
    want = _jax_rows(_jax(jrt.range_join_materialize, bk, bv, pk))
    assert got[3] == want[3] == 0
    assert got[0] == want[0] == oracle_count(bk, pk)
    for g, w in zip(_sorted_pairs(*got[1:3]), _sorted_pairs(*want[1:3])):
        np.testing.assert_array_equal(g, w)
    # the port keeps probe order
    for g, w in zip(got[1:3], _first_match(bk, bv, pk)):
        np.testing.assert_array_equal(g, w)


def test_range_materialize_dups_and_sentinel():
    rng = np.random.default_rng(6)
    bk = rng.integers(0, 300, 3_000, dtype=np.uint64)
    bk[7] = M64
    bk[900] = M64
    bv = rng.integers(0, 2**63, 3_000, dtype=np.uint64)
    pk = np.concatenate([rng.integers(0, 400, 8_997, dtype=np.uint64),
                         np.full(3, M64, np.uint64)])
    out = _port(trt.range_join_materialize, bk, bv, pk)
    count, keys, vals, unres = _port_rows(out)
    assert unres == 0 and count == oracle_count(bk, pk)
    # minimum-build-row winner, probe order
    want = _first_match(bk, bv, pk)
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(vals, want[1])
    # the port's merge picks the same winner
    m = tmj.merge_join_materialize(*(tu64.to_device(p, "cpu")
                                     for p in _planes(bk, bv, pk)),
                                   len(bk), len(pk))
    mkeys = tu64.to_numpy_u64(m[1], m[2], int(m[0]))
    mvals = tu64.to_numpy_u64(m[3], m[4], int(m[0]))
    for g, w in zip(_sorted_pairs(keys, vals), _sorted_pairs(mkeys, mvals)):
        np.testing.assert_array_equal(g, w)
    # the JAX package: same count and key multiset, values from the run
    jcount, jkeys, jvals, junres = _jax_rows(
        _jax(jrt.range_join_materialize, bk, bv, pk))
    assert junres == 0 and jcount == count
    assert collections.Counter(jkeys.tolist()) == collections.Counter(
        keys.tolist())
    runs = collections.defaultdict(set)
    for k, v in zip(bk.tolist(), bv.tolist()):
        runs[k].add(v)
    assert all(v in runs[k] for k, v in zip(jkeys.tolist(), jvals.tolist()))


def test_range_tiny_build_and_probe():
    bk = np.array([5, 9], dtype=np.uint64)
    bv = np.array([50, 90], dtype=np.uint64)
    pk = np.array([9, 9, 5, 1], dtype=np.uint64)
    count, keys, vals, _ = _port_rows(_port(trt.range_join_materialize, bk,
                                            bv, pk))
    assert count == 3
    assert list(zip(keys.tolist(), vals.tolist())) == [(9, 90), (9, 90),
                                                       (5, 50)]
    jcount, jkeys, jvals, _ = _jax_rows(_jax(jrt.range_join_materialize, bk,
                                             bv, pk))
    assert jcount == 3
    assert sorted(zip(jkeys.tolist(), jvals.tolist())) == sorted(
        zip(keys.tolist(), vals.tolist()))


def test_build_range_table_is_stable_and_ordered():
    edge = np.array([0, 1, 2**31, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                     2**64 - 2, 2**64 - 1], np.uint64)
    bk = np.concatenate([edge[::-1], edge, edge[3:6]])
    bv = np.arange(bk.size, dtype=np.uint64)
    kh, kl = tu64.device_planes(bk, "cpu")
    vh, vl = tu64.device_planes(bv, "cpu")
    table = trt.build_range_table(kh, kl, vh, vl, bk.size - 2,
                                  with_values=True)
    order = np.argsort(bk[:-2], kind="stable")      # u64 order, row ties
    assert table.keys.tolist() == [int(k) - 2**63 for k in bk[order]]
    np.testing.assert_array_equal(tu64.to_numpy_u64(
        table.values[:, 0], table.values[:, 1], order.size), order)
    assert trt.build_range_table(kh, kl, vh, vl, 0,
                                 with_values=False).keys.numel() == 0


# ---- the bucket directory (K3/K4's first search level) ----------------------

EDGE_BUILDS = ["empty", "one", "all_equal", "ends", "full_span", "crowded",
               "dup_run", "uniform"]


def _edge_build(name):
    """(bk of 3000 rows, nb_valid): builds that stress the directory, padded
    to one shape so that the JAX package compiles once."""
    rng = np.random.default_rng(sum(map(ord, name)) + 11)
    n = 3_000
    bk = rng.integers(0, 2**64, n, dtype=np.uint64)
    nb = n
    if name == "empty":
        nb = 0
    elif name == "one":
        nb = 1
    elif name == "all_equal":                          # span 0
        bk[:] = bk[0]
    elif name == "ends":             # span 2^64-1 in two keys: no directory
        bk[:2] = [0, M64]
        nb = 2
    elif name == "full_span":                          # shift 64 - p
        bk[[5, 9]] = [0, M64]
    elif name == "crowded":        # 99 % of the keys in one bucket, outliers
        bk[30:] = rng.integers(10**6, 10**6 + n, n - 30, dtype=np.uint64)
        bk[[3, 4]] = [0, M64]
    elif name == "dup_run":                            # a 2000-row run
        bk[500:2_500] = bk[7]
    elif name == "uniform":
        bk = rng.integers(0, int(n * 1.1), n, dtype=np.uint64)
        bk[17] = M64
    return bk, nb


def _edge_probes(bk, nb):
    """9000 probes: build keys, their neighbours (misses inside buckets),
    the ends of the key space and random keys."""
    rng = np.random.default_rng(nb + 5)
    valid = bk[:nb] if nb else np.array([12345], np.uint64)
    near = rng.choice(valid, 2_000)
    pk = np.concatenate([rng.choice(valid, 4_000), near + np.uint64(1),
                         near - np.uint64(1),
                         rng.integers(0, 2**64, 1_000, dtype=np.uint64)])
    pk[:4] = [0, 1, M64, M64 - np.uint64(1)]
    pk[4:6] = np.array([valid.min(), valid.max()]) + np.array([M64, 1],
                                                             np.uint64)
    return pk


def _numpy_directory(keys_u64, p):
    """(dir, shift) from the definition: bucket = (key - keys[0]) >> shift
    over the sorted u64 keys, shift = max(0, bit_length(span) - p), and
    dir[b] = the first index whose bucket is >= b, for b in [0, 2^p]."""
    keys = np.sort(keys_u64)
    shift = max(0, (int(keys[-1]) - int(keys[0])).bit_length() - p)
    buckets = (keys - keys[0]) >> np.uint64(shift)
    return np.searchsorted(buckets, np.arange(2**p + 1, dtype=np.uint64)), shift


def _sorted_keys(bk, nb):
    kh, kl = tu64.device_planes(bk[:nb], "cpu")
    return torch.sort(tu64.sortable(kh, kl))[0]


@pytest.mark.parametrize("name", EDGE_BUILDS)
def test_range_directory_matches_numpy(name):
    bk, nb = _edge_build(name)
    kh, kl = tu64.device_planes(bk, "cpu")
    table = trt.build_range_table(kh, kl, kh, kl, nb, with_values=False)
    if nb <= rp.SMALL_TABLE:                   # a small table: no directory
        assert rp.directory_bits(nb) == 0
        assert table.dir is None and table.shift is None
        return
    p = min(math.ceil(math.log2(nb)) - 2, 23)
    assert rp.directory_bits(nb) == p
    want, shift = _numpy_directory(bk[:nb], p)
    assert table.dir.dtype == torch.int32 and table.dir.numel() == 2**p + 1
    np.testing.assert_array_equal(table.dir.numpy(), want)
    assert int(table.shift) == shift
    if name == "full_span":
        assert shift == 64 - p
    if name == "all_equal":
        assert shift == 0 and table.dir[1:].tolist() == [nb] * 2**p


@pytest.mark.parametrize("name", [n for n in EDGE_BUILDS if n != "empty"])
@pytest.mark.parametrize("p", [1, 6, 14])
def test_range_directory_at_any_size_matches_numpy(name, p):
    """range_directory at a forced size, down to two buckets: shift 63
    when the keys span all of u64."""
    bk, nb = _edge_build(name)
    dir_, shift = rp.range_directory(_sorted_keys(bk, nb), p)
    want, want_shift = _numpy_directory(bk[:nb], p)
    np.testing.assert_array_equal(dir_.numpy(), want)
    assert int(shift) == want_shift
    if name in ("ends", "full_span"):
        assert want_shift == 64 - p


@pytest.mark.parametrize("name", EDGE_BUILDS)
def test_range_probe_plain_on_either_layout(name):
    """The plain K3/K4 give the oracle's answer whether the table has no
    directory or one of any size."""
    bk, nb = _edge_build(name)
    bv = np.random.default_rng(4).integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = _edge_probes(bk, nb)
    kh, kl = tu64.device_planes(bk, "cpu")
    vh, vl = tu64.device_planes(bv, "cpu")
    built = trt.build_range_table(kh, kl, vh, vl, nb, with_values=True)
    ph, pl = tu64.device_planes(pk, "cpu")
    want = _first_match(bk[:nb], bv[:nb], pk)
    layouts = [None] + ([1, 6, 14] if nb else [])
    for p in layouts:
        dir_, shift = (rp.range_directory(built.keys, p) if p
                       else (None, None))
        table = trt.RangeTable(built.keys, built.values, dir_, shift)
        assert int(rp.range_probe_count(table, ph, pl, pk.size)) == len(
            want[0]), p
        hit, mvh, mvl = rp.range_probe_materialize(table, ph, pl, pk.size)
        hit = hit.numpy()
        np.testing.assert_array_equal(pk[hit], want[0])
        np.testing.assert_array_equal(
            tu64.to_numpy_u64(mvh, mvl, pk.size)[hit], want[1])


@pytest.mark.parametrize("name", EDGE_BUILDS)
def test_range_join_on_directory_edge_builds(name):
    bk, nb = _edge_build(name)
    bv = np.random.default_rng(3).integers(0, 2**64, bk.size,
                                           dtype=np.uint64)
    pk = _edge_probes(bk, nb)
    count, special = _port(trt.range_join_count, bk, bv, pk, nb=nb)
    jcount, jspecial = _jax(jrt.range_join_count, bk, bv, pk, nb=nb)
    assert int(jspecial[3]) == 0 and special.tolist() == [0, 0, 0, 0]
    assert int(count) == int(jcount) == oracle_count(bk[:nb], pk)
    got = _port_rows(_port(trt.range_join_materialize, bk, bv, pk, nb=nb))
    want = _first_match(bk[:nb], bv[:nb], pk)
    assert got[0] == len(want[0]) == int(count) and got[3] == 0
    np.testing.assert_array_equal(got[1], want[0])     # probe order
    np.testing.assert_array_equal(got[2], want[1])     # minimum build row
    jrows = _jax_rows(_jax(jrt.range_join_materialize, bk, bv, pk, nb=nb))
    assert jrows[0] == got[0] and jrows[3] == 0
    np.testing.assert_array_equal(np.sort(jrows[1]), np.sort(got[1]))
    if np.unique(bk[:nb]).size == nb:                  # winner pinned
        for g, w in zip(_sorted_pairs(*got[1:3]), _sorted_pairs(*jrows[1:3])):
            np.testing.assert_array_equal(g, w)


def test_range_directory_and_probes_refuse_bad_tables():
    keys = _sorted_keys(np.arange(10, dtype=np.uint64), 10)
    for bad in ((keys[:0], 3, None), (keys, 0, None), (keys, 31, None),
                (keys, 3, torch.int16), (keys.to(torch.int32), 3, None)):
        with pytest.raises(ValueError):
            rp.range_directory(*bad)
    dir_, shift = rp.range_directory(keys, 3)
    ph, pl = tu64.device_planes(np.arange(4, dtype=np.uint64), "cpu")
    for table in (trt.RangeTable(keys, None, dir_[:-1], shift),
                  trt.RangeTable(keys, None, dir_.to(torch.int16), shift),
                  trt.RangeTable(keys, None, dir_, None)):
        with pytest.raises(ValueError):
            rp.range_probe_count(table, ph, pl, 4)
    assert int(rp.range_probe_count(trt.RangeTable(keys, None, dir_, shift),
                                    ph, pl, 4)) == 4
