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


# --- K2: probe_count_bitmap ---------------------------------------------------

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
    got = tbp.probe_count_bitmap(_t(bitmap), _t(idx), d_rows)
    assert got.dtype == torch.int64 and int(got) == want
    assert int(tbp.probe_count_bitmap(_t(bitmap), _t(padded), d_rows)) == want


def test_k2_wrapper_checks_its_inputs():
    bitmap = _t(np.zeros((8, 128), np.uint32))
    idx = _t(np.arange(10, dtype=np.uint32))
    with pytest.raises(ValueError):
        tbp.probe_count_bitmap(bitmap, idx, 512)          # past the scan band
    with pytest.raises(ValueError):
        tbp.probe_count_bitmap(bitmap, idx.to(torch.int64), 8)
    with pytest.raises(ValueError):
        tbp.probe_count_bitmap(bitmap[:4], idx, 8)
    assert int(tbp.probe_count_bitmap(bitmap, idx[:0], 8)) == 0


# --- K1: fused_bitmap_join ----------------------------------------------------

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
    count, ub_t, up_t = tdbm.fused_bitmap_join(_t(bidx), _t(pidx), d_rows)
    assert int(count) == int(cnt)
    assert (ub_t, up_t) == (0, 0)
    assert int(count) == int(np.isin(pidx, bidx[bidx != SENTINEL]).sum())


def test_k1_wrapper_checks_its_inputs():
    idx = _t(np.arange(10, dtype=np.uint32))
    with pytest.raises(ValueError):
        tdbm.fused_bitmap_join(idx, idx, tdbm.MAX_D_ROWS + 4096)
    with pytest.raises(ValueError):
        tdbm.fused_bitmap_join(idx, idx[::2], 512)         # not contiguous
    assert int(tdbm.fused_bitmap_join(idx[:0], idx, 512)[0]) == 0
    assert int(tdbm.fused_bitmap_join(idx, idx[:0], 512)[0]) == 0


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
