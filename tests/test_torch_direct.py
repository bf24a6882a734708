"""Port parity: the dense-domain count of flash_hash_join_tpu_torch against
the JAX package.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
port's counterparts on CPU tensors, which take the kernels' plain PyTorch
versions.  Tolerance: exact equality — every output is an integer count.

The CUDA kernels themselves run only on a card: test_torch_cuda.py
compares each with its plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flash_hash_join_tpu.ops import direct_bitmap as jdb
from flash_hash_join_tpu.ops.pallas import bitmap_probe as jbp
from flash_hash_join_tpu.ops.pallas import dense_bitmap as jdbm
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models import workload
from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as tbp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as tdbm
from flash_hash_join_tpu_torch.utils import u64 as tu64

SENTINEL = 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    """numpy u32 values -> the port's int32 bit-pattern tensor on the CPU."""
    return tu64.to_device(np.asarray(a, np.uint32), "cpu")


def _planes(keys):
    hi, lo = ju64.split_u64(np.asarray(keys, np.uint64))
    return hi, lo


def _jax_count(fn, bk, pk, nb_valid, np_valid, d_rows, **kw):
    kh, kl = _planes(bk)
    ph, pl = _planes(pk)
    cnt, special = fn(jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(ph),
                      jnp.asarray(pl), np.int32(nb_valid), np.int32(np_valid),
                      d_rows=d_rows, interpret=True, **kw)
    return int(cnt), int(np.asarray(special)[3])


def _torch_count(fn, bk, pk, nb_valid, np_valid, d_rows):
    kh, kl = _planes(bk)
    ph, pl = _planes(pk)
    cnt, special = fn(_t(kh), _t(kl), _t(ph), _t(pl), nb_valid, np_valid,
                      d_rows=d_rows)
    return int(cnt), int(special[3])


# --- K2: the index form's plain version, and scan_domain_count ---------------

@pytest.mark.parametrize("d_rows", [8, 16, 256])
def test_k2_plain_matches_pallas(d_rows):
    rng = np.random.default_rng(d_rows)
    n_bits = d_rows * jbp.BITS_PER_ROW
    bitmap = rng.integers(0, 2**32, (d_rows, 128), dtype=np.uint32)
    bitmap &= rng.integers(0, 2**32, (d_rows, 128), dtype=np.uint32)
    n = 40 * 128 - 37                                   # ragged tail
    idx = rng.integers(0, n_bits, n, dtype=np.uint32)
    idx[rng.random(n) < 0.2] = SENTINEL
    idx[:50] = rng.integers(n_bits, 2**32 - 1, 50, dtype=np.uint32)
    padded = np.concatenate([idx, np.full(37, SENTINEL, np.uint32)])
    want = int(jbp.probe_count_bitmap(
        jnp.asarray(bitmap), jnp.asarray(padded.reshape(-1, 128)),
        d_rows=d_rows, block_m=40, interpret=True))
    got = tbp.probe_count_bitmap_plain(_t(bitmap), _t(idx), d_rows)
    assert got.dtype == torch.int64 and int(got) == want
    assert int(tbp.probe_count_bitmap_plain(_t(bitmap), _t(padded),
                                            d_rows)) == want


def test_k2_wrapper_checks_its_inputs():
    kh, kl = tu64.device_planes(np.arange(10, dtype=np.uint64), "cpu")
    with pytest.raises(ValueError):                       # past the scan band
        tbp.scan_domain_count(kh, kl, kh, kl, 10, 10, 512)
    with pytest.raises(ValueError):                       # int64 planes
        tbp.scan_domain_count(kh.long(), kl.long(), kh, kl, 10, 10, 8)
    with pytest.raises(ValueError):                       # planes of two lengths
        tbp.scan_domain_count(kh, kl, kh[:4], kl, 4, 4, 8)
    with pytest.raises(ValueError):                       # np_valid past the rows
        tbp.scan_domain_count(kh, kl, kh, kl, 10, 11, 8)
    with pytest.raises(ValueError):                       # not contiguous
        tbp.scan_domain_count(kh[::2], kl[::2], kh, kl, 5, 10, 8)
    count, n_bad = tbp.scan_domain_count(kh, kl, kh[:0], kl[:0], 10, 0, 8)
    assert (int(count), int(n_bad)) == (0, 0)
    assert [int(x) for x in tbp.scan_domain_count(kh, kl, kh, kl, 10, 10,
                                                  8)] == [10, 0]


def _scan_spec(bk, pk, nbv, npv, d_rows):
    """The scan band's count from its definition, in numpy: lo over EVERY
    valid build row (high-word rows too), u32 wrap-around, bad rows,
    membership."""
    bk, pk = bk[:nbv], pk[:npv]
    lo = int((bk & np.uint64(SENTINEL)).min()) if bk.size else SENTINEL
    d_bits = d_rows * 4096
    bdiff = (bk - np.uint64(lo)) & np.uint64(SENTINEL)
    good = (bk < 2**32) & (bdiff < d_bits)
    pdiff = (pk - np.uint64(lo)) & np.uint64(SENTINEL)
    pin = (pk < 2**32) & (pdiff < d_bits)
    return int(np.isin(pdiff[pin], bdiff[good]).sum()), int((~good).sum())


def _scan_domain_case(name, d_rows):
    """(build keys, probe keys, nb_valid, np_valid) of one scan-band case
    in a domain of d_rows * 4096 slots.  Keys stay dense, so the JAX scan
    band (which has no window) and the spec see the same rows."""
    rng = np.random.default_rng(len(name) + d_rows)
    d_bits = d_rows * 4096
    lo = 3_000_000_000
    bk = rng.integers(lo, lo + d_bits, 3_000, dtype=np.uint64)
    pk = rng.integers(lo - d_bits // 8, lo + d_bits + d_bits // 8, 9_000,
                      dtype=np.uint64)
    pk[::4] = rng.choice(bk, pk[::4].size)
    nbv, npv = len(bk), len(pk)
    if name == "hi_word_rows_set_lo":
        # a hi-word row with the least low word: it sets lo (lo - 64), is
        # bad, and shifts the domain down under the top build keys
        bk[[7, 90]] = [2**40 + lo - 64, 2**33 + lo + 5]
        pk[:20] = 2**40 + lo - 64
    elif name == "below_lo_and_hi_probes":
        pk[:600] = rng.integers(0, lo, 600, dtype=np.uint64)
        pk[600:620] = lo - 1
        pk[620:700] = bk[:80] + np.uint64(2**32)            # hi-word probes
    elif name == "u32_and_u64_max":
        # 2^32 - 1 sits past a domain from 3e9 + small spans: a bad build
        # row and a missing probe; 2^64 - 1 a hi-word row on both sides
        bk[[3, 4]] = [2**32 - 1, 2**64 - 1]
        pk[:10] = 2**32 - 1
        pk[10:20] = 2**64 - 1
    elif name == "u32_max_in_domain":
        # a domain at the top of u32: 2^32 - 1 is a build key and its probes
        # join; small probe keys wrap into the slots past 2^32 - 1 and miss
        bk = rng.integers(2**32 - 2_000, 2**32, 3_000, dtype=np.uint64)
        bk[0] = 2**32 - 1
        pk = np.concatenate([rng.choice(bk, 6_000),
                             np.arange(3_000, dtype=np.uint64)])
        pk[:10] = 2**32 - 1
    elif name == "padding_tail":
        # in-domain build and probe keys past the valid counts count nothing
        nbv, npv = 2_500, 7_000
        bk[nbv:] = rng.integers(lo - 5_000, lo, bk.size - nbv,
                                dtype=np.uint64)          # would move lo
        pk[npv:] = rng.choice(bk[:nbv], pk.size - npv)
    elif name == "empty_valid_build":
        nbv = 0
    elif name == "empty_valid_probe":
        npv = 0
    elif name == "no_zero_hi_build":
        # every valid build row has a high word: lo is their least low word
        # and every one of them is bad
        bk |= np.uint64(2**36)
    elif name == "hi_under_domain_sides":
        # the card tests' and chip_smoke's case where the two bands' lo
        # part: a high-word build row whose low word is under every other
        # row's sets the scan band's lo, and about half of the build rows
        # leave the domain
        bk, pk = workload.domain_sides(rng, 3_005, 9_001, 50_000_000, d_bits,
                                       below_lo=False, hi_under=True)
        nbv, npv = len(bk) - 5, len(pk) - 3
    else:
        raise KeyError(name)
    return bk, pk, nbv, npv


SCAN_DOMAIN_CASES = ["hi_word_rows_set_lo", "below_lo_and_hi_probes",
                     "u32_and_u64_max", "u32_max_in_domain", "padding_tail",
                     "empty_valid_build", "empty_valid_probe",
                     "no_zero_hi_build", "hi_under_domain_sides"]


@pytest.mark.parametrize("name", SCAN_DOMAIN_CASES)
@pytest.mark.parametrize("d_rows", [8, 64])
def test_scan_domain_count_plain_matches_jax_and_spec(name, d_rows):
    bk, pk, nbv, npv = _scan_domain_case(name, d_rows)
    kh, kl = _planes(bk)
    ph, pl = _planes(pk)
    got = tbp.scan_domain_count(_t(kh), _t(kl), _t(ph), _t(pl), nbv, npv,
                                d_rows)
    assert all(x.dtype == torch.int64 and x.dim() == 0 for x in got)
    got = tuple(int(x) for x in got)
    assert got == _jax_count(jdb.direct_join_count, bk, pk, nbv, npv, d_rows)
    assert got == _scan_spec(bk, pk, nbv, npv, d_rows)
    assert got == _torch_count(tdb.direct_join_count, bk, pk, nbv, npv,
                               d_rows)
    if name in ("hi_word_rows_set_lo", "u32_and_u64_max", "no_zero_hi_build"):
        assert got[1] > 0
    if name == "u32_max_in_domain":
        assert got == (6_000, 0)
    if name == "hi_under_domain_sides":       # not the large band's lo
        assert got[1] > nbv // 3
        assert got != tuple(int(x) for x in tdbm.fused_domain_bitmap_join_plain(
            _t(kh), _t(kl), _t(ph), _t(pl), nbv, npv, d_rows))


@pytest.mark.parametrize("d_rows", [8, 16, 32, 64, 128, 256])
def test_scan_domain_count_at_every_rung_matches_numpy_spec(d_rows):
    # the edge keys of the card tests: hi-word, past-domain, below-lo and
    # u32-max rows on both sides, the domain's last slot and one past it
    rng = np.random.default_rng(d_rows)
    n_bits, lo = d_rows * 4096, 7_000_000
    bk = workload.dense_domain_keys(rng, 9_000, lo, n_bits)
    pk = workload.dense_domain_keys(rng, 12_000, lo, n_bits)
    pk[::3] = rng.choice(bk, pk[::3].size)
    base = int(bk.min())                   # the scan band's lo: every row
    bk[5:7] = [base + n_bits - 1, base + n_bits]
    pk[5:7] = [base + n_bits - 1, base + n_bits]
    for nbv, npv in ((len(bk), len(pk)), (len(bk) - 7, len(pk) - 5)):
        got = tbp.scan_domain_count(*tu64.device_planes(bk, "cpu"),
                                    *tu64.device_planes(pk, "cpu"), nbv, npv,
                                    d_rows)
        assert [int(x) for x in got] == list(_scan_spec(bk, pk, nbv, npv,
                                                        d_rows))


@pytest.mark.parametrize("offs", [(0, 0), (1, 1), (1, 3), (2, 0)])
def test_scan_domain_count_on_edge_key_views_matches_numpy_spec(offs):
    # plane views that start 0-3 words into longer planes, the two planes
    # of a side each its own way, as the card tests give the kernel
    rng = np.random.default_rng(sum(offs) + 50)
    d_rows, lo = 16, 123_456_789
    bk = workload.dense_domain_keys(rng, 5_003, lo, d_rows * 4096)
    pk = workload.dense_domain_keys(rng, 7_001, lo, d_rows * 4096)
    pk[::3] = rng.choice(bk, pk[::3].size)
    kh, kl = workload.offset_plane_views(bk, "cpu", *offs)
    ph, pl = workload.offset_plane_views(pk, "cpu", *offs[::-1])
    assert (kh.storage_offset(), kl.storage_offset()) == offs
    for nbv, npv in ((len(bk), len(pk)), (len(bk) - 5, len(pk) - 3)):
        got = tbp.scan_domain_count(kh, kl, ph, pl, nbv, npv, d_rows)
        assert [int(x) for x in got] == list(_scan_spec(bk, pk, nbv, npv,
                                                        d_rows))


# --- K1: the index form's plain version ----------------------------------------

def test_k1_plain_matches_pallas_on_sorted_stream():
    # the JAX kernel takes its blockwise-sorted stream and `rs` windows; the
    # port's takes the same indices unsorted.  Small blocks keep interpret
    # mode fast and the dense span keeps JAX's unresolved counts at 0.
    rng = np.random.default_rng(7)
    d_rows, block_rows, sort_block, sels = 512, 8, 1024, 8
    base, span = 1_500_000, 100_000
    bidx = rng.integers(base, base + span, 3_000, dtype=np.uint32)
    pidx = rng.integers(base - 1_000, base + span + 1_000, 2_900,
                        dtype=np.uint32)
    pidx[rng.random(pidx.size) < 0.1] = SENTINEL
    bidx[:40] = SENTINEL
    bs = jdb._blockwise_sorted_idx(jnp.asarray(bidx), sort_block)
    ps = jdb._blockwise_sorted_idx(jnp.asarray(pidx), sort_block)
    idx_all = jnp.concatenate([bs, ps])
    rs = jnp.clip((idx_all[:, 0] >> jnp.uint32(12)).astype(jnp.int32),
                  0, d_rows - sels)
    cnt, ub, up = jdbm.fused_bitmap_join(
        idx_all, rs.reshape(-1, 1, block_rows),
        nbb=bs.shape[0] // block_rows, d_rows=d_rows,
        block_rows=block_rows, sels=sels, interpret=True)
    assert (int(ub), int(up)) == (0, 0)
    count = tdbm.fused_bitmap_join_plain(_t(bidx), _t(pidx), d_rows)
    assert count.dtype == torch.int64 and int(count) == int(cnt)
    assert int(count) == int(np.isin(pidx, bidx[bidx != SENTINEL]).sum())


def test_k1_wrapper_checks_its_inputs():
    # K1's one entry, the domain form: rung and plane checks, empty sides
    kh, kl = tu64.device_planes(np.arange(10, dtype=np.uint64), "cpu")
    with pytest.raises(ValueError):
        tdbm.fused_domain_bitmap_join(kh, kl, kh, kl, 10, 10,
                                      tdbm.MAX_D_ROWS + 4096)
    with pytest.raises(ValueError):                       # not contiguous
        tdbm.fused_domain_bitmap_join(kh, kl, kh[::2], kl[::2], 10, 5, 512)
    for nbv, npv in ((0, 10), (10, 0)):
        assert [int(x) for x in tdbm.fused_domain_bitmap_join(
            kh, kl, kh, kl, nbv, npv, 512)] == [0, 0]


# --- direct_join_count (scan band) ----------------------------------------------

def _scan_case(name):
    rng = np.random.default_rng(len(name))
    if name == "nonzero_lo":
        bk = rng.integers(4_000_000_000, 4_000_004_400, 4_000, dtype=np.uint64)
        pk = rng.integers(3_999_999_000, 4_000_006_000, 20_000,
                          dtype=np.uint64)
        return bk, pk, len(bk), len(pk)
    if name == "duplicates":
        base = rng.integers(0, 30_000, 3_000, dtype=np.uint64)
        bk = np.concatenate([base, base, base[:700]])
        pk = rng.integers(0, 33_000, 15_000, dtype=np.uint64)
        return bk, pk, len(bk), len(pk)
    if name == "validity_tails":
        bk = rng.integers(0, 60_000, 5_000, dtype=np.uint64)
        pk = rng.integers(0, 70_000, 9_000, dtype=np.uint64)
        return bk, pk, 4_321, 7_333
    if name == "hi_word_rows":
        # a hi-word build row with the smallest low word: the scan band
        # takes lo over every valid row, so lo drops to 3 and the top of
        # the 16-row domain no longer holds the high keys
        bk = rng.integers(50_000, 80_000, 3_000, dtype=np.uint64)
        bk[[5, 17]] = [2**40 + 3, 2**33 + 60_000]
        pk = rng.integers(40_000, 90_000, 10_000, dtype=np.uint64)
        pk[:30] = 2**40 + 3
        return bk, pk, len(bk), len(pk)
    if name == "empty_build":
        return (np.zeros(0, np.uint64), np.arange(100, dtype=np.uint64), 0,
                100)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["nonzero_lo", "duplicates", "validity_tails",
                                  "hi_word_rows", "empty_build"])
def test_direct_join_count_scan_band_parity(name):
    bk, pk, nbv, npv = _scan_case(name)
    d_rows = 16 if name == "hi_word_rows" else 32
    want = _jax_count(jdb.direct_join_count, bk, pk, nbv, npv, d_rows)
    got = _torch_count(tdb.direct_join_count, bk, pk, nbv, npv, d_rows)
    assert got == want
    if want[1] == 0:
        assert want[0] == int(np.isin(pk[:npv], bk[:nbv]).sum())


# --- direct_join_count_large (K1 band) ----------------------------------------

def test_direct_join_count_large_parity():
    # nonzero lo, duplicate build keys, validity tails and a hi-word build
    # row in one case: one interpret-mode call of the JAX large band
    rng = np.random.default_rng(21)
    lo = 123_456_789
    base = rng.integers(lo, lo + 9_000, 4_000, dtype=np.uint64)
    bk = np.concatenate([base, base[:2_000]])
    bk[11] = 2**36 + 5                                  # bad: hi word != 0
    pk = rng.integers(lo - 500, lo + 10_500, 9_000, dtype=np.uint64)
    nbv, npv = 5_500, 8_200
    d_rows = 512
    want = _jax_count(jdb.direct_join_count_large, bk, pk, nbv, npv, d_rows)
    got = _torch_count(tdb.direct_join_count_large, bk, pk, nbv, npv, d_rows)
    assert want[1] == 1                                  # the hi-word row
    assert got == want
    assert got[0] == int(np.isin(pk[:npv], bk[:nbv]).sum())


def test_direct_join_count_large_gap_is_exact():
    # the JAX package's gap case (test_direct_large.py): a key-space gap
    # wider than the TPU kernel's row window leaves rows unresolved there.
    # K1 addresses every word, so the port counts exactly with nothing
    # unresolved.
    d_rows = 512
    d_bits = d_rows * 4096
    bk = np.concatenate([np.arange(1_000, dtype=np.uint64),
                         np.arange(d_bits - 1_000, d_bits, dtype=np.uint64)])
    pk = np.concatenate([np.arange(500, dtype=np.uint64),
                         np.arange(d_bits - 300, d_bits + 300,
                                   dtype=np.uint64)])
    jax_cnt, jax_sp3 = _jax_count(jdb.direct_join_count_large, bk, pk,
                                  len(bk), len(pk), d_rows)
    assert jax_sp3 > 0
    got = _torch_count(tdb.direct_join_count_large, bk, pk, len(bk), len(pk),
                       d_rows)
    assert got == (int(np.isin(pk, bk).sum()), 0)


@pytest.mark.parametrize("band", ["scan", "large"])
@pytest.mark.parametrize("empty", ["build", "probe"])
def test_direct_join_count_empty_sides(band, empty):
    # the JAX package pins (0, 0) for the large band (test_direct_large.py);
    # its scan band cannot take an empty probe side, which api.py never
    # hands it, so these hold the port to the contract alone
    fn, d_rows = ((tdb.direct_join_count, 32) if band == "scan"
                  else (tdb.direct_join_count_large, 512))
    keys = np.arange(100, dtype=np.uint64)
    none = np.zeros(0, np.uint64)
    bk, pk = (none, keys) if empty == "build" else (keys, none)
    assert _torch_count(fn, bk, pk, len(bk), len(pk), d_rows) == (0, 0)


def test_direct_join_count_dispatches_on_rung():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 1_500_000, 20_000, dtype=np.uint64)
    pk = rng.integers(0, 1_600_000, 20_000, dtype=np.uint64)
    d_rows = tdb.d_rows_for(int(bk.max() - bk.min()) + 1)
    assert d_rows > tbp.MAX_D_ROWS
    via_dispatch = _torch_count(tdb.direct_join_count, bk, pk, len(bk),
                                len(pk), d_rows)
    assert via_dispatch == _torch_count(tdb.direct_join_count_large, bk, pk,
                                        len(bk), len(pk), d_rows)
    assert via_dispatch == (int(np.isin(pk, bk).sum()), 0)


def test_constants_and_d_rows_for_match_jax():
    for name in ("MAX_DOMAIN_BITS", "MAX_LARGE_D_ROWS", "MAX_LARGE_DOMAIN_BITS",
                 "MAX_XL_D_ROWS", "MAX_XL_DOMAIN_BITS", "XL_STEP_ROWS"):
        assert getattr(tdb, name) == getattr(jdb, name), name
    spans = [1, 4096, 8 * 4096, 8 * 4096 + 1, 44_000, 2**19, 2**20,
             2**20 + 1, 2**25, 44_000_000, 2**26, 2**26 + 1, 110_000_000,
             jdb.MAX_XL_DOMAIN_BITS]
    r = 8
    while r <= jdb.MAX_LARGE_D_ROWS:                   # every pow2 rung edge
        spans += [r * 4096, r * 4096 + 1]
        r *= 2
    for span in spans:
        assert tdb.d_rows_for(span) == jdb.d_rows_for(span), span
