"""Port parity for the `vmem` tier: flash_hash_join_tpu_torch's
ops/bucket_table.py and the plain versions of K10 / K11
(ops/cuda/bucket_probe.py, on CPU tensors) against the JAX package's
ops/bucket_table.py and its Pallas kernels in interpret mode, and the numpy
oracle; and the kernels' own layouts of the table (K11's bucket-major keys
and values, K10's keys alone, the fences) against numpy.

Inputs are numpy arrays from a fixed seed, handed to both packages.  The
JAX kernels run on 8-row probe tiles (block_m=8: 1024 probes a tile) so
interpret mode stays quick.  Tolerance: exact — tables, buckets, counts,
hit masks and value planes are equal element for element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu.ops import bucket_table as jbt
from flash_hash_join_tpu.ops.pallas import bucket_probe as jbp
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.ops import bucket_table as tbt
from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as tbp
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.oracle import oracle_count

M64 = np.uint64(2**64 - 1)


def _planes(*cols):
    """numpy u64 columns -> (JAX planes, torch CPU planes)."""
    split = [p for c in cols for p in ju64.split_u64(c)]
    return ([jnp.asarray(p) for p in split],
            [tu64.to_device(p, "cpu") for p in split])


def _build_keys(rng, n, dups=True):
    bk = rng.integers(0, 2**64, n, dtype=np.uint64)
    if dups:
        bk[n // 2: n // 2 + n // 5] = bk[:n // 5]
    bk[:2] = M64
    return bk


def _u32(t: torch.Tensor) -> np.ndarray:
    return tu64.to_numpy_u32(t)


def _assert_tables_equal(jt, tt):
    for name in jt._fields:
        want = np.asarray(getattr(jt, name)).astype(np.int64)
        got = tu64.widen(getattr(tt, name)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("r_slots,nb,nb_valid", [
    (8, 600, 600),            # over capacity: drops counted
    (8, 300, 250),            # padding rows past nb_valid
    (512, 20_000, 20_000),    # the top rung
    (512, 3_000, 2_999),
])
def test_build_bucket_table_matches_jax(r_slots, nb, nb_valid):
    rng = np.random.default_rng(nb)
    bk, bv = _build_keys(rng, nb), rng.integers(0, 2**64, nb, dtype=np.uint64)
    (jkh, jkl, jvh, jvl), (tkh, tkl, tvh, tvl) = _planes(bk, bv)
    for with_values in (False, True):
        jt = jbt.build_bucket_table(jkh, jkl, jvh, jvl, nb_valid,
                                    r_slots=r_slots, with_values=with_values)
        tt = tbt.build_bucket_table(tkh, tkl, tvh, tvl, nb_valid,
                                    r_slots=r_slots, with_values=with_values)
        _assert_tables_equal(jt, tt)
    assert (int(tt.special[3]) > 0) == (r_slots == 8 and nb == 600)
    # every column is ascending by u64 key, empty slots last: what K10/K11
    # search
    keys = tu64.sortable(tt.tk_hi, tt.tk_lo)
    assert bool((keys[1:] >= keys[:-1]).all())


def test_probe_buckets_match_jax_prep():
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 2**64, 3_000, dtype=np.uint64)
    pk[:4] = M64
    (jph, jpl), (tph, tpl) = _planes(pk)
    for pre_shift in (0, 5):
        _, _, pbkt, is_max = jbt._prep_probe(jph, jpl, 2_990,
                                             pre_shift=pre_shift, block_m=8)
        want = np.asarray(pbkt).reshape(-1)[:pk.size]
        got = tbp.probe_buckets(tph, tpl, pre_shift).numpy()
        real = pk != M64                  # JAX sends u64-max rows to bucket 0
        real[2_990:] = False              # and pads past n_valid
        np.testing.assert_array_equal(got[real], want[real])
        assert (want[~real] == 0).all()
        assert np.asarray(is_max).sum() == 4


@pytest.mark.parametrize("r_slots,nb", [(8, 700), (16, 1_500), (128, 9_000),
                                        (512, 30_000)])
def test_kernels_plain_match_jax_kernels(r_slots, nb):
    rng = np.random.default_rng(r_slots)
    bk, bv = _build_keys(rng, nb), rng.integers(0, 2**64, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 1_200),
                         rng.integers(0, 2**64, 900, dtype=np.uint64)])
    pk[5:8] = M64
    np_valid = pk.size - 37
    (jkh, jkl, jvh, jvl, jph, jpl), (tkh, tkl, tvh, tvl, tph, tpl) = \
        _planes(bk, bv, pk)
    jt = jbt.build_bucket_table(jkh, jkl, jvh, jvl, nb, r_slots=r_slots,
                                with_values=True)
    tt = tbt.build_bucket_table(tkh, tkl, tvh, tvl, nb, r_slots=r_slots,
                                with_values=True)
    ph_b, pl_b, pbkt_b, _ = jbt._prep_probe(jph, jpl, np_valid, pre_shift=0,
                                            block_m=8)
    jcount = jbp.probe_count_vmem(jt.tk_hi, jt.tk_lo, ph_b, pl_b, pbkt_b,
                                  r_slots=r_slots, block_m=8, interpret=True)
    tcount = tbp.probe_count_vmem(tt.tk_hi, tt.tk_lo, tph, tpl, np_valid)
    assert tcount.dtype == torch.int64 and int(tcount) == int(jcount) > 0
    jout = jbp.probe_materialize_vmem(jt.tk_hi, jt.tk_lo, jt.tv_hi, jt.tv_lo,
                                      ph_b, pl_b, pbkt_b, r_slots=r_slots,
                                      block_m=8, interpret=True)
    tout = tbp.probe_materialize_vmem(tt.tk_hi, tt.tk_lo, tt.tv_hi, tt.tv_lo,
                                      tph, tpl, np_valid)
    assert tout[0].dtype == torch.bool and int(tout[0].sum()) == int(tcount)
    for got, want in zip(tout, jout):
        want = np.asarray(want).reshape(-1)[:pk.size].astype(np.int64)
        np.testing.assert_array_equal(tu64.widen(got.to(torch.int32)).numpy(),
                                      want)


@pytest.mark.parametrize("r_slots", [64, 256])
def test_bucket_joins_match_jax_and_oracle(r_slots):
    rng = np.random.default_rng(r_slots + 1)
    bk = rng.integers(0, 2**64, 1_000, dtype=np.uint64)
    bk[[3, 9]] = M64
    bk[500:600] = bk[100:200]                       # duplicates
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 2_000),
                         rng.integers(0, 2**64, 1_000, dtype=np.uint64)])
    pk[:2] = M64
    np_valid = pk.size - 11
    jargs, targs = _planes(bk, bv, pk)
    jc, jsp = jbt.bucket_join_count(*jargs, bk.size, np_valid,
                                    r_slots=r_slots, interpret=True)
    tc, tsp = tbt.bucket_join_count(*targs, bk.size, np_valid,
                                    r_slots=r_slots)
    want = oracle_count(bk, pk[:np_valid])
    assert int(tc) == int(jc) == want and int(tsp[3]) == 0
    np.testing.assert_array_equal(tu64.widen(tsp).numpy(),
                                  np.asarray(jsp).astype(np.int64))
    jout = jbt.bucket_join_materialize(*jargs, bk.size, np_valid,
                                       r_slots=r_slots, interpret=True)
    tout = tbt.bucket_join_materialize(*targs, bk.size, np_valid,
                                       r_slots=r_slots)
    c = int(tout[0])
    assert c == int(jout[0]) == want
    for i in (1, 3):                                  # keys, then values
        np.testing.assert_array_equal(
            tu64.to_numpy_u64(tout[i], tout[i + 1], c),
            ju64.join_u64(np.asarray(jout[i]), np.asarray(jout[i + 1]))[:c])
    # probe order, minimum-build-row winner
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk[:np_valid]).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk[:np_valid]
    np.testing.assert_array_equal(tu64.to_numpy_u64(tout[3], tout[4], c),
                                  bv[first[pos[hit]]])


def test_overflow_counts_drops_and_vmem_falls_back(monkeypatch):
    rng = np.random.default_rng(8)
    bk = np.unique(rng.integers(0, 2**63, 4_000, dtype=np.uint64))
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([bk[:50], rng.integers(0, 2**63, 50,
                                               dtype=np.uint64)])
    jargs, targs = _planes(bk, bv, pk)
    _, jsp = jbt.bucket_join_count(*jargs, bk.size, pk.size, r_slots=8,
                                   interpret=True)
    _, tsp = tbt.bucket_join_count(*targs, bk.size, pk.size, r_slots=8)
    assert int(tsp[3]) == int(jsp[3]) > 0
    monkeypatch.setattr(tbt, "r_slots_for", lambda n_build: 8)
    for fn in (ft.join_count, ft.join_materialize):
        out = fn(bk, bv, pk, strategy="vmem", device="cpu", return_info=True)
        assert out[0] == oracle_count(bk, pk)
        assert out[-1]["retried"] and out[-1]["strategy"] == "merge"


def test_r_slots_for_matches_jax():
    for n in (0, 1, 100, 1_000, 4_000, 40_000, 10**6):
        assert tbt.r_slots_for(n) == jbt.r_slots_for(n)
    assert tbt.MAX_BUILD_ROWS == jbt.MAX_BUILD_ROWS
    assert tbt.MAX_R_SLOTS == jbt.MAX_R_SLOTS


def _np_bucket(keys: np.ndarray) -> np.ndarray:
    """The vmem bucket of u64 keys in numpy: the top 7 bits of murmur3's
    32-bit finalizer over the two words (ops/hashing.py), pre_shift 0."""
    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    hi, lo = ju64.split_u64(keys)
    with np.errstate(over="ignore"):
        h = fmix32(fmix32(lo) ^ (hi * np.uint32(0x9E3779B9)))
    return (h >> np.uint32(25)).astype(np.int64)


def _layout_spec(bk, bv, r_slots, staged_max=tbp.STAGED_MAX_R_SLOTS):
    """The kernels' layout from its definition, in numpy: row b of the keys
    holds bucket b's distinct non-max keys ascending (the first r_slots of
    them), then u64-max; the values (K11's; None when bv is None) the (hi,
    lo) words of each key's first build row, then 0; the fences every
    fence_stride(R, staged_max)-th key of every row (every key up to
    staged_max rows: K11's STAGED_MAX_R_SLOTS by default)."""
    keys = np.full((128, r_slots), M64, np.uint64)
    vals = np.zeros((128, r_slots), np.uint64)
    uniq, first = np.unique(bk, return_index=True)
    keep = uniq != M64
    uniq, first = uniq[keep], first[keep]
    bucket = _np_bucket(uniq)
    for b in range(128):
        k = uniq[bucket == b][:r_slots]
        keys[b, :k.size] = k
        if bv is not None:
            vals[b, :k.size] = bv[first[bucket == b][:r_slots]]
    fences = keys[:, ::tbp.fence_stride(r_slots, staged_max)].T
    if bv is None:
        return keys, None, fences
    pairs = np.stack(ju64.split_u64(vals.reshape(-1)), axis=-1)
    return keys, pairs.reshape(128, r_slots, 2), fences


def _search_like_kernels(fences, keys, vals, pk):
    """The search of the K10 / K11 kernels, in numpy: the last fence at or
    under the key (branch-free over the bucket's fences), then the key's
    run of R // len(fences) keys compared at once (the fence itself when
    every key is a fence).  (hit, vh, vl); (hit,) alone when vals is None
    (K10)."""
    run_len = keys.shape[1] // fences.shape[0]
    b = _np_bucket(pk)
    run = np.zeros(pk.size, np.int64)
    span = fences.shape[0]
    while span > 1:
        half = span // 2
        run = np.where(fences[run + half, b] <= pk, run + half, run)
        span //= 2
    line = keys[b[:, None], run[:, None] * run_len + np.arange(run_len)]
    eq = line == pk[:, None]
    hit = eq.any(1) & (pk != M64)
    if vals is None:
        return (hit,)
    slot = run * run_len + eq.argmax(1)
    return (hit, *(np.where(hit, vals[b, slot, w], 0) for w in (0, 1)))


def _full_bucket_keys(rng, r_slots):
    """Build keys for the layout tests: about 30 % load, buckets 5 and 77
    empty, bucket 0 full to its last slot, the u64-max key and 20
    duplicates."""
    bk = rng.integers(0, 2**64, int(0.3 * 128 * r_slots), dtype=np.uint64)
    cand = rng.integers(0, 2**64, 300 * r_slots, dtype=np.uint64)
    bk = np.concatenate([bk[~np.isin(_np_bucket(bk), [0, 5, 77])],
                         cand[_np_bucket(cand) == 0][:r_slots]])
    bk[:2] = M64                                       # u64-max build key
    bk[10:30] = bk[-20:]                               # duplicates
    return bk


@pytest.mark.parametrize("r_slots", [8, 16, 128, 512])
def test_bucket_layout_matches_numpy(r_slots):
    # K11's layout, built in plain torch from the table (the bucket-major
    # keys and (vh, vl) pairs of bucket_major, the fences of bucket_fences:
    # every slot up to R 32, every 8th above), against numpy from the build
    # keys: a bucket full to its last slot, empty buckets, the u64-max key
    # and duplicates; then the kernels' search run in numpy over that
    # layout finds every key
    rng = np.random.default_rng(r_slots + 40)
    bk = _full_bucket_keys(rng, r_slots)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    _, (tkh, tkl, tvh, tvl) = _planes(bk, bv)
    tt = tbt.build_bucket_table(tkh, tkl, tvh, tvl, bk.size,
                                r_slots=r_slots, with_values=True)
    keys, vals = tbp.bucket_major(tt.tk_hi, tt.tk_lo, tt.tv_hi, tt.tv_lo)
    fences = tbp.bucket_fences(tt.tk_hi, tt.tk_lo)
    want_keys, want_vals, want_fences = _layout_spec(bk, bv, r_slots)
    assert keys.dtype == fences.dtype == torch.int64
    assert vals.dtype == torch.int32 and vals.shape == (128, r_slots, 2)
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), want_keys)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32), want_vals)
    np.testing.assert_array_equal(fences.numpy().view(np.uint64),
                                  want_fences)
    assert (want_keys[0] != M64).all()                 # bucket 0 full
    assert (want_keys[[5, 77]] == M64).all()           # empty buckets
    pk = np.concatenate([rng.choice(bk, 3_000),
                         rng.integers(0, 2**64, 1_000, dtype=np.uint64)])
    got = _search_like_kernels(want_fences, want_keys, want_vals, pk)
    _, (tph, tpl) = _planes(pk)
    plain = tbp.probe_materialize_vmem_plain(tt.tk_hi, tt.tk_lo, tt.tv_hi,
                                             tt.tv_lo, tph, tpl, pk.size)
    np.testing.assert_array_equal(got[0], plain[0].numpy())
    for g, w in zip(got[1:], plain[1:]):
        np.testing.assert_array_equal(g.astype(np.uint32), _u32(w))
    assert got[0].sum() > 2_000 and not got[0][pk == M64].any()


@pytest.mark.parametrize("r_slots", [8, 16, 64, 128, 512])
def test_count_layout_matches_numpy_and_jax(r_slots):
    # K10's layout: the keys-only bucket-major copy (bucket_major_keys, in
    # plain torch) of a table built without values, and its fences, against
    # numpy from the build keys (a full bucket, empty buckets, the u64-max
    # key, duplicates); then the kernels' search run in numpy over that
    # layout counts what probe_count_vmem_plain and the JAX kernel in
    # interpret mode count, np_valid < npr
    rng = np.random.default_rng(r_slots + 80)
    bk = _full_bucket_keys(rng, r_slots)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 2_000),
                         rng.integers(0, 2**64, 1_000, dtype=np.uint64)])
    pk[7:9] = M64
    np_valid = pk.size - 29
    (jkh, jkl, jvh, jvl, jph, jpl), (tkh, tkl, tvh, tvl, tph, tpl) = \
        _planes(bk, bv, pk)
    tt = tbt.build_bucket_table(tkh, tkl, tvh, tvl, bk.size,
                                r_slots=r_slots, with_values=False)
    assert tt.tv_hi.shape == (1, 128)                  # no value planes
    keys = tbp.bucket_major_keys(tt.tk_hi, tt.tk_lo)
    staged_max = tbp.COUNT_STAGED_MAX_R_SLOTS
    want_keys, _, want_fences = _layout_spec(bk, None, r_slots, staged_max)
    assert keys.dtype == torch.int64 and keys.shape == (128, r_slots)
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), want_keys)
    np.testing.assert_array_equal(
        tbp.bucket_fences(tt.tk_hi, tt.tk_lo, staged_max).numpy().view(
            np.uint64), want_fences)
    hit = _search_like_kernels(want_fences, want_keys, None,
                               pk[:np_valid])[0]
    plain = tbp.probe_count_vmem_plain(tt.tk_hi, tt.tk_lo, tph, tpl,
                                       np_valid)
    jt = jbt.build_bucket_table(jkh, jkl, jvh, jvl, bk.size,
                                r_slots=r_slots, with_values=False)
    ph_b, pl_b, pbkt_b, _ = jbt._prep_probe(jph, jpl, np_valid, pre_shift=0,
                                            block_m=8)
    jcount = jbp.probe_count_vmem(jt.tk_hi, jt.tk_lo, ph_b, pl_b, pbkt_b,
                                  r_slots=r_slots, block_m=8, interpret=True)
    assert int(hit.sum()) == int(plain) == int(jcount) > 1_500
    assert int(tbp.probe_count_vmem(tt.tk_hi, tt.tk_lo, tph, tpl,
                                    np_valid)) == int(plain)


def test_kernel_wrappers_refuse_bad_inputs():
    tk = torch.full((8, 128), -1, dtype=torch.int32)
    ph = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError):                     # not (R, 128)
        tbp.probe_count_vmem(tk[:, :64].contiguous(), tk[:, :64].contiguous(),
                             ph, ph, 10)
    with pytest.raises(ValueError):                     # too many slot rows
        big = torch.full((1024, 128), -1, dtype=torch.int32)
        tbp.probe_count_vmem(big, big, ph, ph, 10)
    with pytest.raises(ValueError):                     # np_valid past n
        tbp.probe_count_vmem(tk, tk, ph, ph, 11)
    with pytest.raises(ValueError):                     # int64 probes
        tbp.probe_materialize_vmem(tk, tk, tk, tk, ph.long(), ph.long(), 10)
    with pytest.raises(ValueError):
        tbp.probe_count_vmem(tk, tk, ph, ph[:9], 9)
    assert int(tbp.probe_count_vmem(tk, tk, ph, ph, 10)) == 0
    odd = torch.full((12, 128), -1, dtype=torch.int32)  # off the rungs
    with pytest.raises(ValueError):
        tbp.probe_materialize_vmem(odd, odd, odd, odd, ph, ph, 10)
    with pytest.raises(ValueError):
        tbp.probe_count_vmem(odd, odd, ph, ph, 10)
    with pytest.raises(ValueError):
        tbp.bucket_major(odd, odd, odd, odd)
    with pytest.raises(ValueError):
        tbp.bucket_major_keys(odd, odd)
