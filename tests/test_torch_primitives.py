"""The port's query primitives (flash_hash_join_tpu_torch/ops: aggregate,
filter, sort) against the JAX package's on the CPU, and the filter ->
join -> aggregate pipeline of tests/test_pipeline.py through the port.

Inputs are numpy arrays from a fixed seed, handed to both packages as
(hi, lo) u32 planes; the port runs on CPU tensors (compaction takes K5's
plain version).  Tolerance: exact equality.  hash_aggregate, the
predicates, filter_columns and sort_u64 are compared element for element
(the same (home, key) group order, input order, stable sort);
radix_partition_by_hash's offsets and ids element for element, its rows as
a multiset a partition (the JAX sort is unstable within a partition).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu.ops import aggregate as jagg
from flash_hash_join_tpu.ops import filter as jfilt
from flash_hash_join_tpu.ops import sort as jsort
from flash_hash_join_tpu.ops.hashing import hash_u64
from flash_hash_join_tpu_torch import ops as tops
from flash_hash_join_tpu_torch.ops import filter as tfilt
from flash_hash_join_tpu_torch.utils import u64 as tu64

M64 = 2**64 - 1
PREDICATES = ("eq_u64", "lt_u64", "gt_u64", "le_u64", "ge_u64")


def _planes(x: np.ndarray):
    """(jax hi, jax lo, torch hi, torch lo) of a u64 column."""
    hi, lo = tu64.split_u64(x)
    return (jnp.asarray(hi), jnp.asarray(lo), tu64.to_device(hi, "cpu"),
            tu64.to_device(lo, "cpu"))


def _same(jax_out, torch_out) -> None:
    """One JAX array and one port tensor hold the same values (u32 planes
    as bit patterns)."""
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def _keys(rng, n: int, kind: str) -> np.ndarray:
    if kind == "dups":                            # heavy duplication
        return rng.integers(0, 50, n, dtype=np.uint64)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)   # above 2^63 too
    keys[::7] = M64
    keys[3::11] = keys[5]
    return keys


@pytest.mark.parametrize("kind", ["dups", "wide"])
@pytest.mark.parametrize("n_valid", [5_000, 3_999, 0])
@pytest.mark.parametrize("gbits", [4, 20])
def test_hash_aggregate_matches_jax(kind, n_valid, gbits):
    rng = np.random.default_rng(gbits + n_valid)
    keys = _keys(rng, 5_000, kind)
    keys[n_valid:n_valid + 3] = keys[0]           # the invalid tail's key
    vals = rng.integers(0, 2**64, 5_000, dtype=np.uint64)
    jkh, jkl, tkh, tkl = _planes(keys)
    jvh, jvl, tvh, tvl = _planes(vals)
    want = jagg.hash_aggregate(jkh, jkl, jvh, jvl, n_valid, gbits=gbits)
    got = tops.hash_aggregate(tkh, tkl, tvh, tvl, n_valid, gbits=gbits)
    assert int(got.n_groups) == len(np.unique(keys[:n_valid]))
    for field in want._fields:
        _same(getattr(want, field), getattr(got, field))


def test_hash_aggregate_against_numpy():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 4_000, "wide")
    vals = rng.integers(0, 2**64, 4_000, dtype=np.uint64)
    got = tops.hash_aggregate(*_planes(keys)[2:], *_planes(vals)[2:], 4_000)
    ng = int(got.n_groups)
    gkeys = tu64.to_numpy_u64(got.key_hi, got.key_lo, ng)
    gsum = tu64.to_numpy_u64(got.sum_hi, got.sum_lo, ng)
    gmin = tu64.to_numpy_u64(got.min_hi, got.min_lo, ng)
    gmax = tu64.to_numpy_u64(got.max_hi, got.max_lo, ng)
    assert ng == len(np.unique(keys))
    for i, k in enumerate(gkeys):
        sel = vals[keys == k]
        assert int(got.count[i]) == sel.size
        assert int(gsum[i]) == sum(int(v) for v in sel) % 2**64
        assert gmin[i] == sel.min() and gmax[i] == sel.max()


@pytest.mark.parametrize("const", [0, 5, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                                   2**63 + 2**32 + 7, M64])
def test_predicates_match_jax(const):
    rng = np.random.default_rng(const % 1_000)
    x = np.concatenate([
        np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, M64 - 1, M64],
                 np.uint64),
        rng.integers(0, 2**64, 3_000, dtype=np.uint64),
        np.full(5, const, np.uint64)])
    jh, jl, th, tl = _planes(x)
    chi, clo = const >> 32, const & 0xFFFFFFFF
    for name in PREDICATES:
        want = getattr(jfilt, name)(jh, jl, chi, clo)
        got = getattr(tfilt, name)(th, tl, chi, clo)
        _same(want, got)
        np.testing.assert_array_equal(got.numpy(), {
            "eq_u64": x == const, "lt_u64": x < const, "gt_u64": x > const,
            "le_u64": x <= const, "ge_u64": x >= const}[name])
    upper = (min(const + 2**40, M64) >> 32, min(const + 2**40, M64) & 0xFFFFFFFF)
    _same(jfilt.between_u64(jh, jl, (chi, clo), upper),
          tfilt.between_u64(th, tl, (chi, clo), upper))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_filter_columns_matches_jax(density):
    rng = np.random.default_rng(int(density * 10))
    x = rng.integers(0, 2**64, 6_001, dtype=np.uint64)
    y = rng.integers(0, 2**32, 6_001, dtype=np.uint64)
    jxh, jxl, txh, txl = _planes(x)
    jyh, jyl, tyh, tyl = _planes(y)
    cut = np.uint64(min(int(density * 2**64), M64))
    chi, clo = int(cut >> np.uint64(32)), int(cut & np.uint64(0xFFFFFFFF))
    jmask = jfilt.le_u64(jxh, jxl, chi, clo) if density else \
        jfilt.lt_u64(jxh, jxl, 0, 0)
    tmask = tfilt.le_u64(txh, txl, chi, clo) if density else \
        tfilt.lt_u64(txh, txl, 0, 0)
    want = jfilt.filter_columns(jmask, jxh, jxl, jyh, jyl, jxh)
    # five planes, compacted four at a time
    got = tops.filter_columns(tmask, txh, txl, tyh, tyl, txh)
    assert int(got[0]) == int(want[0]) == int((x <= cut).sum() if density
                                              else 0)
    for w, g in zip(want[1:], got[1:]):
        _same(w, g)
    with pytest.raises(ValueError):
        tops.filter_columns(tmask, torch.from_numpy(y.view(np.int64)))


def test_sort_u64_matches_jax():
    rng = np.random.default_rng(2)
    x = _keys(rng, 10_000, "wide")
    x[::5] = 2**63 + rng.integers(0, 3, x[::5].size, dtype=np.uint64)
    payload = np.arange(10_000, dtype=np.int32)
    jh, jl, th, tl = _planes(x)
    want = jsort.sort_u64(jh, jl, jnp.asarray(payload))
    got = tops.sort_u64(th, tl, torch.from_numpy(payload))
    for w, g in zip(want, got):                   # both stable
        _same(w, g)
    np.testing.assert_array_equal(tu64.to_numpy_u64(got[0], got[1], x.size),
                                  np.sort(x))


@pytest.mark.parametrize("pbits,pre_shift", [(4, 0), (8, 0), (3, 5)])
def test_radix_partition_matches_jax(pbits, pre_shift):
    rng = np.random.default_rng(pbits)
    x = _keys(rng, 8_192, "wide")
    v = rng.integers(0, 2**64, x.size, dtype=np.uint64)
    jxh, jxl, txh, txl = _planes(x)
    jvh, jvl, tvh, tvl = _planes(v)
    want = jsort.radix_partition_by_hash((jxh, jxl, jvh, jvl), jxh, jxl,
                                         pbits=pbits, pre_shift=pre_shift)
    got = tops.radix_partition_by_hash((txh, txl, tvh, tvl), txh, txl,
                                       pbits=pbits, pre_shift=pre_shift)
    assert got.offsets.numel() == 2**pbits + 1
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(
        want.offsets))
    np.testing.assert_array_equal(got.pid.numpy(), np.asarray(want.pid))
    offs = got.offsets.numpy()
    wrows = np.stack([tu64.join_u64(np.asarray(want.cols[0]),
                                    np.asarray(want.cols[1])),
                      tu64.join_u64(np.asarray(want.cols[2]),
                                    np.asarray(want.cols[3]))], 1)
    grows = np.stack([tu64.to_numpy_u64(got.cols[0], got.cols[1], x.size),
                      tu64.to_numpy_u64(got.cols[2], got.cols[3], x.size)], 1)
    for p in range(2**pbits):
        a, b = offs[p], offs[p + 1]
        assert collections.Counter(map(tuple, grows[a:b].tolist())) == \
            collections.Counter(map(tuple, wrows[a:b].tolist()))
    # stable: each partition keeps the input order
    h = np.asarray(hash_u64(jxh, jxl)).astype(np.uint64)
    pid = ((h << np.uint64(pre_shift)) & np.uint64(0xFFFFFFFF)) >> np.uint64(
        32 - pbits)
    order = np.argsort(pid, kind="stable")
    np.testing.assert_array_equal(grows, np.stack([x, v], 1)[order])


def _pipeline_port(bk, bv, pk, cut):
    """SELECT key, count(*), sum(v) FROM probe JOIN build USING(key) WHERE
    probe.key < cut GROUP BY key, through the port's primitives."""
    ph, pl = tu64.device_planes(pk, "cpu")
    mask = tfilt.lt_u64(ph, pl, int(cut >> np.uint64(32)),
                        int(cut & np.uint64(0xFFFFFFFF)))
    kept, fh, fl = tops.filter_columns(mask, ph, pl)
    pk_f = tu64.to_numpy_u64(fh, fl, int(kept))
    count, _, jk, jv = ft.join_materialize(bk, bv, pk_f, device="cpu",
                                           return_arrays=True)
    g = tops.hash_aggregate(*tu64.device_planes(jk, "cpu"),
                            *tu64.device_planes(jv, "cpu"), count, gbits=10)
    ng = int(g.n_groups)
    keys = tu64.to_numpy_u64(g.key_hi, g.key_lo, ng)
    sums = tu64.to_numpy_u64(g.sum_hi, g.sum_lo, ng)
    return count, {int(k): (int(c), int(s)) for k, c, s in
                   zip(keys, g.count[:ng].tolist(), sums)}


def test_filter_join_aggregate_pipeline_matches_jax_and_numpy():
    rng = np.random.default_rng(30)
    nb, npr = 4_000, 30_000
    bk = rng.permutation(np.arange(nb, dtype=np.uint64) * np.uint64(5))
    bv = rng.integers(1, 1_000, nb, dtype=np.uint64)
    pk = rng.integers(0, 5 * nb, npr, dtype=np.uint64)
    cut = np.uint64(5 * nb // 3)
    count, got = _pipeline_port(bk, bv, pk, cut)

    lut = dict(zip(bk.tolist(), bv.tolist()))
    want = collections.defaultdict(lambda: [0, 0])
    for k in pk.tolist():
        if k < cut and k in lut:
            want[k][0] += 1
            want[k][1] += lut[k]
    assert count == sum(c for c, _ in want.values())
    assert got == {k: tuple(v) for k, v in want.items()}

    # the JAX package's pipeline on the same inputs
    jph, jpl = jnp.asarray(tu64.split_u64(pk)[0]), jnp.asarray(
        tu64.split_u64(pk)[1])
    jmask = jfilt.lt_u64(jph, jpl, 0, int(cut))
    jkept, jfh, jfl = jfilt.filter_columns(jmask, jph, jpl)
    pk_f = tu64.join_u64(np.asarray(jfh), np.asarray(jfl))[:int(jkept)]
    jcount, _, jk, jv = fj.join_materialize(bk, bv, pk_f, return_arrays=True)
    assert jcount == count


def test_join_then_filter_values():
    rng = np.random.default_rng(31)
    bk = np.arange(2_000, dtype=np.uint64)
    bv = rng.integers(0, 100, 2_000, dtype=np.uint64)
    pk = rng.integers(0, 4_000, 10_000, dtype=np.uint64)
    count, _, jk, jv = ft.join_materialize(bk, bv, pk, device="cpu",
                                           return_arrays=True)
    vh, vl = tu64.device_planes(jv, "cpu")
    kept, *_ = tops.filter_columns(tfilt.lt_u64(vh, vl, 0, 50), vh, vl)
    lut = dict(zip(bk.tolist(), bv.tolist()))
    assert int(kept) == sum(1 for k in pk.tolist()
                            if k in lut and lut[k] < 50)
