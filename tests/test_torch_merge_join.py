"""Port parity: hashing, segmented scans and the sort-merge count of
flash_hash_join_tpu_torch against the JAX package and the numpy oracle.

Inputs are numpy arrays from a fixed seed, handed to both packages; the
port runs on CPU tensors.  Tolerance: exact equality — hashes are bit
patterns and counts are integers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flash_hash_join_tpu.ops import hashing as jh
from flash_hash_join_tpu.ops import merge_join as jmj
from flash_hash_join_tpu.ops import segmented as jseg
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.ops import hashing as th
from flash_hash_join_tpu_torch.ops import merge_join as tmj
from flash_hash_join_tpu_torch.ops import segmented as tseg
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.oracle import oracle_count

EDGE_U32 = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 0xFFFFFFFE,
                     0xFFFFFFFF, 0x85EBCA6B, 0x9E3779B9], np.uint32)


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE_U32,
                           rng.integers(0, 2**32, n, dtype=np.uint32)])


def _t(a) -> torch.Tensor:
    return tu64.to_device(np.asarray(a, np.uint32), "cpu")


def _np32(t: torch.Tensor) -> np.ndarray:
    return tu64.to_numpy_u32(t)


def test_fmix32_bit_parity():
    x = _u32(20_000, 1)
    want = np.asarray(jh.fmix32(jnp.asarray(x)))
    np.testing.assert_array_equal(_np32(th.fmix32(_t(x))), want)
    # widened int64 input gives the same bits as the int32 pattern
    np.testing.assert_array_equal(_np32(th.fmix32(tu64.widen(_t(x)))), want)


def test_hash_u64_bit_parity():
    hi, lo = _u32(20_000, 2), _u32(20_000, 3)[::-1].copy()
    want = np.asarray(jh.hash_u64(jnp.asarray(hi), jnp.asarray(lo)))
    got = th.hash_u64(_t(hi), _t(lo))
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    np.testing.assert_array_equal(_np32(got), want)


@pytest.mark.parametrize("n_segments", [1, 7, 400])
def test_segmented_scan_parity(n_segments):
    rng = np.random.default_rng(n_segments)
    n = 3_001
    seg = np.sort(rng.integers(0, n_segments, n)).astype(np.int32)
    flag = rng.integers(0, 2, n).astype(np.uint32)
    val = rng.integers(0, 2**32, n, dtype=np.uint32)
    small = rng.integers(0, 1_000, n).astype(np.uint32)

    def comb(xp):
        # the merge join's (has-build, first value) combine, plus a run sum
        def f(a, b):
            fa, va, sa = a
            fb, vb, sb = b
            return xp.maximum(fa, fb), xp.where(fa > 0, va, vb), sa + sb
        return f

    jout = jseg.segmented_scan(
        comb(jnp),
        (jnp.asarray(flag), jnp.asarray(val), jnp.asarray(small)),
        jnp.asarray(seg))
    tout = tseg.segmented_scan(
        comb(torch),
        (tu64.widen(_t(flag)), tu64.widen(_t(val)), tu64.widen(_t(small))),
        torch.from_numpy(seg))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(_np32(t), np.asarray(j))
    seg_t = torch.from_numpy(seg)
    np.testing.assert_array_equal(tseg.seg_starts(seg_t).numpy(),
                                  np.asarray(jseg.seg_starts(seg)))
    np.testing.assert_array_equal(tseg.seg_ends(seg_t).numpy(),
                                  np.asarray(jseg.seg_ends(seg)))


@pytest.mark.parametrize("op", ["add_u64", "min_u64", "max_u64"])
def test_u64_pair_helpers_parity(op):
    ah, al, bh, bl = (_u32(5_000, s) for s in (4, 5, 6, 7))
    al[:9] = 0xFFFFFFFF                                 # force carries
    jout = getattr(jseg, op)((jnp.asarray(ah), jnp.asarray(al)),
                             (jnp.asarray(bh), jnp.asarray(bl)))
    w = lambda a: tu64.widen(_t(a))                     # noqa: E731
    tout = getattr(tseg, op)((w(ah), w(al)), (w(bh), w(bl)))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(_np32(t), np.asarray(j))


def _merge_args(bk, bv, pk):
    return [p for a in (bk, bv, pk) for p in ju64.split_u64(a)]


def _both(bk, bv, pk, nb_valid=None, np_valid=None):
    nbv = len(bk) if nb_valid is None else nb_valid
    npv = len(pk) if np_valid is None else np_valid
    planes = _merge_args(bk, bv, pk)
    want = int(jmj.merge_join_count(*(jnp.asarray(p) for p in planes),
                                    nbv, npv))
    got = tmj.merge_join_count(*(_t(p) for p in planes), nbv, npv)
    assert got.dtype == torch.int64
    return int(got), want


@pytest.mark.parametrize("nb,npr", [(1_000, 1_000), (50, 5_000), (5_000, 50)])
def test_merge_join_count_full_range_keys(nb, npr):
    rng = np.random.default_rng(nb + 3 * npr)
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(0, 2**64, npr - npr // 2,
                                      dtype=np.uint64)])
    got, want = _both(bk, bv, pk)
    assert got == want == oracle_count(bk, pk)


def test_merge_join_count_duplicates_and_max_key():
    m = np.uint64(2**64 - 1)
    bk = np.array([7, 7, 7, m, 3, 2**32, 2**32], dtype=np.uint64)
    bv = np.array([70, 71, 72, 99, 30, 1, 2], dtype=np.uint64)
    pk = np.array([7, m, 4, 7, m, 3, 2**32, 2**32 + 1, 0], dtype=np.uint64)
    got, want = _both(bk, bv, pk)
    assert got == want == oracle_count(bk, pk) == 6


def test_merge_join_count_validity_padding():
    # pad rows hold keys that WOULD match (0 and a live key); only the
    # valid prefixes may count
    rng = np.random.default_rng(9)
    bk = rng.integers(0, 3_000, 2_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 2_000, dtype=np.uint64)
    pk = rng.integers(0, 3_000, 4_000, dtype=np.uint64)
    bk[1_500:] = 0
    pk[3_100:] = bk[0]
    got, want = _both(bk, bv, pk, nb_valid=1_500, np_valid=3_100)
    assert got == want == oracle_count(bk[:1_500], pk[:3_100])


def test_sorted_runs_build_rows_lead_each_run():
    bk = np.array([5, 5, 9], dtype=np.uint64)
    bv = np.array([50, 51, 90], dtype=np.uint64)
    pk = np.array([9, 5, 6, 5], dtype=np.uint64)
    planes = [_t(p) for p in _merge_args(bk, bv, pk)]
    match, chs, cls, bvh, bvl, orig = tmj._sorted_runs(*planes, 3, 4)
    assert int(match.sum()) == 3
    # a matched probe row carries the FIRST build value of its run
    vals = dict(zip(orig[match].tolist(), bvl[match].tolist()))
    assert vals == {0: 90, 1: 50, 3: 50}


def _materialize_both(bk, bv, pk, nb_valid=None, np_valid=None):
    """(port rows, JAX rows): (count, keys, values) of the [:count]
    prefixes, in each package's (hash, key) output order."""
    nbv = len(bk) if nb_valid is None else nb_valid
    npv = len(pk) if np_valid is None else np_valid
    planes = _merge_args(bk, bv, pk)
    got = tmj.merge_join_materialize(*(_t(p) for p in planes), nbv, npv)
    want = jmj.merge_join_materialize(*(jnp.asarray(p) for p in planes),
                                      nbv, npv)
    c, jc = int(got[0]), int(want[0])
    assert got[0].dtype == torch.int64
    assert all(o.dtype == torch.int32 and o.numel() == len(pk)
               for o in got[1:])
    return ((c, tu64.to_numpy_u64(got[1], got[2], c),
             tu64.to_numpy_u64(got[3], got[4], c)),
            (jc, ju64.join_u64(np.asarray(want[1]), np.asarray(want[2]))[:jc],
             ju64.join_u64(np.asarray(want[3]), np.asarray(want[4]))[:jc]))


def _min_row_pairs(bk, bv, pk):
    """numpy oracle: matched (key, value) pairs, minimum-build-row winner,
    sorted."""
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    keys, vals = pk[hit], bv[first[pos[hit]]]
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


@pytest.mark.parametrize("nb,npr", [(2_000, 6_000), (50, 5_000)])
def test_merge_join_materialize_unique_keys_matches_jax(nb, npr):
    rng = np.random.default_rng(nb + npr)
    bk = np.unique(rng.integers(0, 2**64, nb, dtype=np.uint64))
    bk[-1] = np.uint64(2**64 - 1)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(0, 2**64, npr - npr // 2,
                                      dtype=np.uint64)])
    (c, keys, vals), (jc, jkeys, jvals) = _materialize_both(bk, bv, pk)
    assert c == jc == oracle_count(bk, pk)
    # same (hash, key) order in both packages: equal row for row
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(vals, jvals)
    order = np.lexsort((vals, keys))
    for g, w in zip((keys[order], vals[order]), _min_row_pairs(bk, bv, pk)):
        np.testing.assert_array_equal(g, w)


def test_merge_join_materialize_duplicates_and_padding():
    rng = np.random.default_rng(12)
    bk = rng.integers(0, 500, 3_000, dtype=np.uint64)
    bk[9] = np.uint64(2**64 - 1)
    bv = rng.integers(0, 2**63, 3_000, dtype=np.uint64)
    pk = rng.integers(0, 700, 8_000, dtype=np.uint64)
    pk[5] = np.uint64(2**64 - 1)
    bk[2_500:] = pk[0]                                  # pad rows that
    pk[7_000:] = bk[0]                                  # would match
    (c, keys, vals), (jc, jkeys, _) = _materialize_both(
        bk, bv, pk, nb_valid=2_500, np_valid=7_000)
    assert c == jc == oracle_count(bk[:2_500], pk[:7_000])
    np.testing.assert_array_equal(np.sort(keys), np.sort(jkeys))
    # the port's winner is the minimum build row of each key
    order = np.lexsort((vals, keys))
    for g, w in zip((keys[order], vals[order]),
                    _min_row_pairs(bk[:2_500], bv[:2_500], pk[:7_000])):
        np.testing.assert_array_equal(g, w)
