"""Port parity for the `global` tier: flash_hash_join_tpu_torch's
ops/hash_table.py (plain torch on the CPU) against the JAX package's
ops/hash_table.py and the numpy oracle.

Inputs are numpy arrays from a fixed seed, handed to both packages.
Tolerance: exact — the built tables (key and value planes, bloom words,
special) are equal element for element, and counts and materialized rows
(probe order) are equal.  With duplicate build keys the port's values are
the minimum build row's, which is also the JAX package's winner (first in
its stable (home, key) sort).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu.ops import hash_table as jht
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu.utils.config import JoinConfig as JConfig
from flash_hash_join_tpu_torch import engine as teng
from flash_hash_join_tpu_torch.ops import hash_table as tht
from flash_hash_join_tpu_torch.ops import hashing as thash
from flash_hash_join_tpu_torch.utils import u64 as tu64
from flash_hash_join_tpu_torch.utils.config import JoinConfig
from tests.oracle import oracle_count, oracle_materialize

CFG = JoinConfig(probe_chunk=1 << 12)
M64 = np.uint64(2**64 - 1)


def _static(cfg, gbits, with_bloom):
    return dict(gbits=gbits, group_size=cfg.group_size,
                total_groups=(1 << gbits) + cfg.overflow_groups,
                use_bloom=with_bloom, bloom_k=cfg.bloom_k,
                max_iters=cfg.max_probe_iters)


def _build_both(bk, bv, *, with_bloom, n_valid=None, cfg=CFG,
                max_probe_iters=None):
    kh, kl = ju64.split_u64(bk)
    vh, vl = ju64.split_u64(bv)
    n = len(bk) if n_valid is None else n_valid
    kw = dict(gbits=cfg.group_bits(len(bk)), group_size=cfg.group_size,
              overflow_groups=cfg.overflow_groups, with_bloom=with_bloom,
              bloom_k=cfg.bloom_k, max_probe_iters=max_probe_iters)
    jt = jht.build_table(*(jnp.asarray(a) for a in (kh, kl, vh, vl)), n, **kw)
    tt = tht.build_table(*(tu64.to_device(a, "cpu") for a in (kh, kl, vh, vl)),
                         n, **kw)
    return jt, tt, _static(cfg, kw["gbits"], with_bloom)


def _assert_tables_equal(jt, tt):
    for name in ("keys", "vals", "bloom", "special"):
        want = np.asarray(getattr(jt, name)).astype(np.int64)
        got = tu64.widen(getattr(tt, name)).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _probe_both(jt, tt, static, pk, n_valid=None, probe_chunk=1 << 12):
    ph, pl = ju64.split_u64(pk)
    n = len(pk) if n_valid is None else n_valid
    jargs = (jnp.asarray(ph), jnp.asarray(pl), n)
    targs = (tu64.to_device(ph, "cpu"), tu64.to_device(pl, "cpu"), n)
    jcount = int(jht.probe_count(jt, *jargs, probe_chunk=probe_chunk,
                                 **static))
    tcount = int(tht.probe_count(tt, *targs, probe_chunk=probe_chunk,
                                 **static))
    jout = jht.probe_materialize(jt, *jargs, probe_chunk=probe_chunk,
                                 **static)
    tout = tht.probe_materialize(tt, *targs, probe_chunk=probe_chunk,
                                 **static)
    c = int(tout[0])
    assert c == int(jout[0]) == tcount == jcount
    rows = [ju64.join_u64(np.asarray(jout[i]), np.asarray(jout[i + 1]))[:c]
            for i in (1, 3)]
    trows = [tu64.to_numpy_u64(tout[i], tout[i + 1], c) for i in (1, 3)]
    for g, w in zip(trows, rows):
        np.testing.assert_array_equal(g, w)
    return c, trows


def _rand(rng, n, hi=2**64):
    return rng.integers(0, hi, n, dtype=np.uint64)


def test_bloom_word_matches_jax():
    from flash_hash_join_tpu.ops import hashing as jhash
    rng = np.random.default_rng(0)
    h = np.concatenate([np.array([0, 1, 2**31, 2**32 - 1], np.uint32),
                        rng.integers(0, 2**32, 10_000, dtype=np.uint32)])
    for k in (1, 3, 6):
        want = np.asarray(jhash.bloom_word(jnp.asarray(h), k))
        got = thash.bloom_word(tu64.to_device(h, "cpu"), k)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("with_bloom", [False, True])
@pytest.mark.parametrize("nb,npr", [(100, 1000), (1000, 100), (5000, 5000)])
def test_build_and_probe_match_jax(with_bloom, nb, npr):
    rng = np.random.default_rng(nb * 7 + npr)
    bk, bv = _rand(rng, nb), _rand(rng, nb)
    bk[nb // 2: nb // 2 + nb // 10] = bk[:nb // 10]        # duplicates
    pk = np.concatenate([rng.choice(bk, npr // 2), _rand(rng, npr - npr // 2)])
    rng.shuffle(pk)
    jt, tt, static = _build_both(bk, bv, with_bloom=with_bloom)
    _assert_tables_equal(jt, tt)
    assert int(tt.special[3]) == 0
    count, (keys, _) = _probe_both(jt, tt, static, pk)
    assert count == oracle_count(bk, pk)
    np.testing.assert_array_equal(keys, pk[np.isin(pk, bk)])  # probe order


@pytest.mark.parametrize("with_bloom", [False, True])
def test_materialize_unique_build_matches_oracle(with_bloom):
    rng = np.random.default_rng(42)
    bk = np.unique(_rand(rng, 4000))
    bv = _rand(rng, len(bk))
    pk = np.concatenate([rng.choice(bk, 3000), _rand(rng, 3000)])
    rng.shuffle(pk)
    jt, tt, static = _build_both(bk, bv, with_bloom=with_bloom)
    count, (keys, vals) = _probe_both(jt, tt, static, pk)
    o_count, o_keys, o_vals = oracle_materialize(bk, bv, pk)
    assert count == o_count
    np.testing.assert_array_equal(keys, o_keys)
    np.testing.assert_array_equal(vals, o_vals)


def test_all_same_key():
    bk = np.full(10_000, 12345, dtype=np.uint64)
    bv = np.arange(10_000, dtype=np.uint64)
    pk = np.array([12345, 12346, 12345], dtype=np.uint64)
    jt, tt, static = _build_both(bk, bv, with_bloom=True)
    _assert_tables_equal(jt, tt)
    count, (keys, vals) = _probe_both(jt, tt, static, pk)
    assert count == 2 and set(keys.tolist()) == {12345}
    assert vals.tolist() == [0, 0]                       # minimum build row


def test_u64_max_key_rides_special():
    bk = np.array([1, 2, M64, 7, M64], dtype=np.uint64)
    bv = np.array([10, 20, 99, 70, 98], dtype=np.uint64)
    pk = np.array([M64, 1, 5, M64], dtype=np.uint64)
    jt, tt, static = _build_both(bk, bv, with_bloom=True)
    _assert_tables_equal(jt, tt)
    assert tu64.widen(tt.special[:3]).tolist() == [1, 0, 99]
    count, (keys, vals) = _probe_both(jt, tt, static, pk)
    assert count == 3
    assert list(zip(keys.tolist(), vals.tolist())) == [
        (2**64 - 1, 99), (1, 10), (2**64 - 1, 99)]
    jt, tt, static = _build_both(bk[:2], bv[:2], with_bloom=False)
    assert _probe_both(jt, tt, static, pk)[0] == 1


def test_padding_rows_are_ignored():
    rng = np.random.default_rng(6)
    bk, bv = _rand(rng, 1000), _rand(rng, 1000)
    pk = rng.choice(bk[:600], 500)
    pad_b = np.concatenate([bk, bk[:200]])     # padding duplicates real keys
    pad_v = np.concatenate([bv, bv[:200]])
    jt, tt, static = _build_both(pad_b, pad_v, with_bloom=True, n_valid=600)
    _assert_tables_equal(jt, tt)
    pad_p = np.concatenate([pk, bk[:64]])
    count, _ = _probe_both(jt, tt, static, pad_p, n_valid=500)
    assert count == oracle_count(bk[:600], pk)


@pytest.mark.parametrize("probe_chunk", [128, 1000])
def test_several_probe_chunks(probe_chunk):
    rng = np.random.default_rng(7)
    bk = np.unique(_rand(rng, 512))
    bv = _rand(rng, len(bk))
    pk = np.concatenate([rng.choice(bk, 700), _rand(rng, 333)])
    jt, tt, static = _build_both(bk, bv, with_bloom=True)
    tht.walk_stats.reset()
    count, (keys, vals) = _probe_both(jt, tt, static, pk, n_valid=1000,
                                      probe_chunk=probe_chunk)
    assert count == oracle_count(bk, pk[:1000])
    stats = tht.walk_stats.read()
    assert stats["chunks"] == 2 * -(-len(pk) // probe_chunk)
    assert stats["probes"] == 2 * 1000
    assert 1 <= stats["longest"] <= static["max_iters"]
    assert stats["longest"] <= stats["groups"] <= 2 * 1000 * stats["longest"]


def test_chain_drop_counts_and_falls_back_to_merge(monkeypatch):
    # with a one-group walk, every key placed past its home group is out of
    # reach: both packages count it in special[3] ...
    rng = np.random.default_rng(9)
    bk = np.unique(_rand(rng, 5000))
    bv = _rand(rng, len(bk))
    jt, tt, _ = _build_both(bk, bv, with_bloom=False, max_probe_iters=1)
    _assert_tables_equal(jt, tt)
    assert int(tt.special[3]) > 0
    # ... and the API reruns such a join on merge, exactly
    monkeypatch.setattr(teng, "DEFAULT_CONFIG", JoinConfig(max_probe_iters=1))
    pk = np.concatenate([rng.choice(bk, 3000), _rand(rng, 3000)])
    count, _, info = ft.hash_join_count(bk, bv, pk, device="cpu",
                                        return_info=True)
    assert count == oracle_count(bk, pk)
    assert info["retried"] and info["strategy"] == "merge"
    assert JConfig().max_probe_iters == JoinConfig().max_probe_iters


@pytest.mark.parametrize("n", [1, 64, 65, 1_000, 4_097])
def test_blockwise_cummax_matches_torch(n):
    from flash_hash_join_tpu_torch.ops.segmented import cummax
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(-2**40, 2**40, n))
    x[::7] = torch.iinfo(torch.int64).min                # the fill value
    for block in (64, 4096):
        assert torch.equal(cummax(x, block), torch.cummax(x, 0).values)
