"""Port parity: K1's domain entry (flash_hash_join_tpu_torch.ops.cuda.
dense_bitmap.fused_domain_bitmap_join), which maps the key planes to domain
indices inside the kernel, against the JAX package's
direct_join_count_large (its Pallas kernel in interpret mode, as the JAX
package's own tests run it), against the port's int64 mapping composed
with the index form, and against the function's definition in numpy.

CPU tensors take the entry's plain version; the CUDA kernel runs only on a
card (tests/test_torch_cuda.py).  Tolerance: exact equality — the count
and the bad-row count are integers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flash_hash_join_tpu.ops import direct_bitmap as jdb
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models import workload
from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb
from flash_hash_join_tpu_torch.ops import domain_map as tdm
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as tbp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as tdbm
from flash_hash_join_tpu_torch.utils import u64 as tu64

D_ROWS = 512                                     # 2^21 slots
D_BITS = D_ROWS * 4096
U32_MAX = 2**32 - 1


def _case(name):
    """(build keys, probe keys, nb_valid, np_valid) of one case.  Keys stay
    dense where they are in the domain, so the TPU kernel's row windows
    resolve every row and its special[3] holds the bad build rows alone."""
    rng = np.random.default_rng(len(name))
    lo = 987_654_321
    if name == "validity_tails":
        bk = rng.integers(lo, lo + 9_000, 5_000, dtype=np.uint64)
        pk = rng.integers(lo - 300, lo + 9_300, 7_000, dtype=np.uint64)
        return bk, pk, 4_321, 6_007
    if name == "hi_word_rows":
        # hi-word rows on both sides, one of them with a low word below
        # every good build key: it must neither set lo nor count
        bk = rng.integers(lo, lo + 8_000, 4_000, dtype=np.uint64)
        bk[[3, 70, 900]] = [2**40 + 5, 2**33 + lo + 10, 2**32 + lo]
        pk = rng.integers(lo, lo + 8_000, 6_000, dtype=np.uint64)
        pk[:40] = 2**40 + 5
        pk[40:60] = 2**32 + bk[100]
        return bk, pk, len(bk), len(pk)
    if name == "below_lo_and_u32_max":
        # probes below lo wrap to huge indices and miss; 2^32 - 1 is a bad
        # build row (past the domain) and a probe that misses
        bk = rng.integers(lo, lo + 7_000, 4_000, dtype=np.uint64)
        bk[[8, 9]] = U32_MAX
        pk = rng.integers(lo, lo + 7_000, 6_000, dtype=np.uint64)
        pk[:500] = rng.integers(0, lo, 500, dtype=np.uint64)
        pk[500:510] = lo - 1
        pk[510:520] = U32_MAX
        return bk, pk, len(bk), len(pk)
    if name == "domain_at_the_top":
        # lo near 2^32: the domain's slots past 2^32 - 1 are reached by
        # probes with small keys, which wrap in but find no bit set
        bk = rng.integers(U32_MAX - 3_000, U32_MAX + 1, 2_000,
                          dtype=np.uint64)
        pk = np.concatenate([rng.choice(bk, 2_000),
                             np.arange(0, 2_000, dtype=np.uint64)])
        return bk, pk, len(bk), len(pk)
    if name == "every_build_row_bad":
        # no good build row: lo = 0xFFFFFFFF, every valid row is bad, and a
        # probe of 0xFFFFFFFF lands on slot 0, which is empty
        bk = rng.integers(0, 5_000, 3_000, dtype=np.uint64) | np.uint64(2**36)
        pk = rng.integers(0, 5_000, 4_000, dtype=np.uint64)
        pk[:10] = U32_MAX
        return bk, pk, 2_500, len(pk)
    if name == "empty_build":
        return (np.zeros(0, np.uint64), np.arange(lo, lo + 100,
                                                  dtype=np.uint64), 0, 100)
    if name == "empty_probe":
        bk = rng.integers(lo, lo + 3_000, 2_000, dtype=np.uint64)
        bk[5] = 2**35                                  # still counted bad
        return bk, np.zeros(0, np.uint64), len(bk), 0
    raise KeyError(name)


CASES = ["validity_tails", "hi_word_rows", "below_lo_and_u32_max",
         "domain_at_the_top", "every_build_row_bad", "empty_build",
         "empty_probe"]


def _torch_planes(keys):
    return tu64.device_planes(np.asarray(keys, np.uint64), "cpu")


def _entry(bk, pk, nbv, npv):
    count, n_bad = tdbm.fused_domain_bitmap_join(
        *_torch_planes(bk), *_torch_planes(pk), nbv, npv, D_ROWS)
    assert count.dtype == n_bad.dtype == torch.int64
    assert count.dim() == n_bad.dim() == 0
    return int(count), int(n_bad)


def _numpy_spec(bk, pk, nbv, npv):
    """The function from its definition: lo over the valid build rows with
    a zero high word, u32 wrap-around, bad rows, membership."""
    bk, pk = bk[:nbv], pk[:npv]
    zero_hi = bk[bk < 2**32]
    lo = int(zero_hi.min()) if zero_hi.size else U32_MAX
    bdiff = (bk - np.uint64(lo)) & np.uint64(U32_MAX)
    good = (bk < 2**32) & (bdiff < D_BITS)
    pdiff = (pk - np.uint64(lo)) & np.uint64(U32_MAX)
    pin = (pk < 2**32) & (pdiff < D_BITS)
    count = int(np.isin(pdiff[pin], bdiff[good]).sum())
    return count, int((~good).sum())


@pytest.mark.parametrize("name", CASES)
def test_domain_entry_plain_matches_jax(name):
    bk, pk, nbv, npv = _case(name)
    (kh, kl), (ph, pl) = ju64.split_u64(bk), ju64.split_u64(pk)
    cnt, special = jdb.direct_join_count_large(
        jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(ph), jnp.asarray(pl),
        np.int32(nbv), np.int32(npv), d_rows=D_ROWS, interpret=True)
    want = int(cnt), int(np.asarray(special)[3])
    assert _entry(bk, pk, nbv, npv) == want
    count, special = tdb.direct_join_count_large(
        *_torch_planes(bk), *_torch_planes(pk), nbv, npv, d_rows=D_ROWS)
    assert (int(count), int(special[3])) == want
    assert [int(x) for x in special[:3]] == [0, 0, 0]


@pytest.mark.parametrize("name", CASES)
def test_domain_entry_matches_index_composition(name):
    # the mapping the path ran before K1 took it in: int64 lo, build and
    # probe domain indices, then the index form's plain version
    bk, pk, nbv, npv = _case(name)
    kh, kl = _torch_planes(bk)
    ph, pl = _torch_planes(pk)
    bvalid = torch.arange(kh.shape[0]) < nbv
    lo = tdm.masked_min(tu64.widen(kl), bvalid & (kh == 0))
    n_bad, bidx = tdm.build_domain_idx(kh, kl, bvalid, lo, D_BITS)
    pidx = tdm.probe_domain_idx(ph, pl, npv, lo, D_BITS)
    count = tdbm.fused_bitmap_join_plain(bidx, pidx, D_ROWS)
    assert _entry(bk, pk, nbv, npv) == (int(count), int(n_bad))


@pytest.mark.parametrize("name", CASES)
def test_domain_entry_matches_numpy_spec(name):
    bk, pk, nbv, npv = _case(name)
    want = _numpy_spec(bk, pk, nbv, npv)
    assert _entry(bk, pk, nbv, npv) == want
    if name in ("below_lo_and_u32_max", "every_build_row_bad"):
        assert want[1] > 0


@pytest.mark.parametrize("d_rows", [512, 16384, 28672])
def test_domain_entry_at_every_rung_matches_numpy_spec(d_rows):
    # rungs of the large band and the XL band: keys spread over the whole
    # domain, its last slot among them, and one slot past it
    rng = np.random.default_rng(d_rows)
    n_bits, lo = d_rows * 4096, 3_000_000
    bk = rng.integers(lo, lo + n_bits, 20_000, dtype=np.uint64)
    bk[:3] = [lo, lo + n_bits - 1, lo + n_bits]
    pk = np.concatenate([rng.choice(bk, 10_000),
                         rng.integers(0, lo + 2 * n_bits, 10_000,
                                      dtype=np.uint64)])
    pk[:2] = [lo + n_bits - 1, lo + n_bits]
    got = tdbm.fused_domain_bitmap_join(*_torch_planes(bk), *_torch_planes(pk),
                                        len(bk), len(pk), d_rows)
    assert (int(got[0]), int(got[1])) == _numpy_spec_at(bk, pk, n_bits)


@pytest.mark.parametrize("offs", [(0, 0), (1, 1), (1, 3), (2, 0)])
def test_domain_entry_on_edge_key_views_matches_numpy_spec(offs):
    # the edge keys and plane views the card tests and chip_smoke.py give
    # the kernel, here through its plain version
    rng = np.random.default_rng(sum(offs))
    lo = 123_456_789
    bk = workload.dense_domain_keys(rng, 5_003, lo, D_BITS)
    pk = workload.dense_domain_keys(rng, 7_001, lo, D_BITS)
    pk[::3] = rng.choice(bk, pk[::3].size)
    assert (bk >= 2**32).any() and (bk < lo).any() and (bk == U32_MAX).any()
    kh, kl = workload.offset_plane_views(bk, "cpu", *offs)
    ph, pl = workload.offset_plane_views(pk, "cpu", *offs[::-1])
    assert (kh.storage_offset(), kl.storage_offset()) == offs
    assert np.array_equal(tu64.to_numpy_u64(kh, kl, len(bk)), bk)
    assert np.array_equal(tu64.to_numpy_u64(ph, pl, len(pk)), pk)
    for nbv, npv in ((len(bk), len(pk)), (len(bk) - 5, len(pk) - 3)):
        got = tdbm.fused_domain_bitmap_join(kh, kl, ph, pl, nbv, npv, D_ROWS)
        assert [int(x) for x in got] == list(_numpy_spec(bk, pk, nbv, npv))


def _numpy_spec_at(bk, pk, n_bits):
    lo = int(bk[bk < 2**32].min())
    good = (bk - np.uint64(lo)) < n_bits
    pin = (pk >= lo) & (pk - np.uint64(lo) < n_bits)
    return int(np.isin(pk[pin], bk[good]).sum()), int((~good).sum())


def test_domain_entry_checks_its_inputs():
    kh, kl = _torch_planes(np.arange(10, dtype=np.uint64))
    with pytest.raises(ValueError):                    # past the XL rung
        tdbm.fused_domain_bitmap_join(kh, kl, kh, kl, 10, 10,
                                      tdbm.MAX_D_ROWS + 4096)
    with pytest.raises(ValueError):                    # planes of two lengths
        tdbm.fused_domain_bitmap_join(kh, kl[:9], kh, kl, 9, 10, 512)
    with pytest.raises(ValueError):                    # not contiguous
        tdbm.fused_domain_bitmap_join(kh[::2], kl[::2], kh, kl, 5, 10, 512)
    with pytest.raises(ValueError):                    # nb_valid past the rows
        tdbm.fused_domain_bitmap_join(kh, kl, kh, kl, 11, 10, 512)
    with pytest.raises(ValueError):                    # int64 planes
        tdbm.fused_domain_bitmap_join(kh.long(), kl.long(), kh, kl, 10, 10,
                                      512)
    assert [int(x) for x in tdbm.fused_domain_bitmap_join(
        kh, kl, kh, kl, 10, 10, 512)] == [10, 0]
