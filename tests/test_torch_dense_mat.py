"""Port parity: the dense-domain materialize of flash_hash_join_tpu_torch
(K7, K8, K9 and ops/direct_bitmap.direct_join_materialize) against the JAX
package and the numpy oracle.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
port's counterparts on CPU tensors, which take the kernels' plain PyTorch
versions.  Tolerance: exact equality — every output is a count, a hit flag
or a u32 bit pattern.

Output order: the port emits probe order in both bands, the JAX scan band
probe order and the JAX staged band ascending domain order, so staged
rows are compared with the JAX package as sorted (key, value) pairs and
with the oracle in probe order.  The duplicate-key winner is the minimum
build row in both packages.  The JAX staged calls stay at or below 16,000
probes, one interpret-mode sort block, so they share one compile per
value-plane count.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu.ops import direct_bitmap as jdb
from flash_hash_join_tpu.ops.pallas import bitmap_probe as jbp
from flash_hash_join_tpu.ops.pallas import dense_values as jdv
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models import workload
from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as tbp
from flash_hash_join_tpu_torch.ops.cuda import dense_values as tdv
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.torch_gates import open_gates

SENTINEL = 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    """numpy u32 values -> the port's int32 bit-pattern tensor on the CPU."""
    return tu64.to_device(np.asarray(a, np.uint32), "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return tu64.to_numpy_u32(t).reshape(-1)


def _oracle_rows(bk, bv, pk):
    """numpy rows in probe order, minimum-build-row winner."""
    if bk.size == 0:
        return pk[:0], bv[:0]
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    return pk[hit], bv[first[pos[hit]]]


def _sorted(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


# --- K7: probe_gather_bitmap ---------------------------------------------------

@pytest.mark.parametrize("v_rows,n_planes", [(8, 1), (128, 2)])
def test_k7_plain_matches_pallas(v_rows, n_planes):
    # the TPU kernel's index form: its plain version, on indices past the
    # planes and past the bitmap
    rng = np.random.default_rng(v_rows + n_planes)
    d_rows = max(8, v_rows // 32)
    bitmap = rng.integers(0, 2**32, (d_rows, 128), dtype=np.uint32)
    planes = [rng.integers(0, 2**32, (v_rows, 128), dtype=np.uint32)
              for _ in range(n_planes)]
    n = 40 * 128
    idx = rng.integers(0, 2 * v_rows * 128, n, dtype=np.uint32)  # past planes
    idx[rng.random(n) < 0.1] = SENTINEL
    idx[:20] = rng.integers(d_rows * 4096, SENTINEL, 20)      # past bitmap
    outs = jbp.probe_gather_bitmap(
        jnp.asarray(bitmap), tuple(jnp.asarray(p) for p in planes),
        jnp.asarray(idx.reshape(-1, 128)), d_rows=d_rows, v_rows=v_rows,
        block_m=40, interpret=True)
    hit, *vals = tbp.probe_gather_bitmap_plain(
        _t(bitmap), [_t(p) for p in planes], _t(idx), d_rows, v_rows)
    want_hit = np.asarray(outs[0]).reshape(-1)
    assert set(np.unique(want_hit).tolist()) == {0, 1}
    assert hit.dtype == torch.bool
    np.testing.assert_array_equal(hit.numpy(), want_hit == 1)
    assert len(vals) == n_planes
    for g, w in zip(vals, outs[1:]):
        np.testing.assert_array_equal(_u32(g), np.asarray(w).reshape(-1))


def _lo(value: int) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int64)


# one domain base per rung: 0, inside u32, a domain at the top of u32 (small
# keys wrap into the slots past 2^32 - 1) and SENTINEL (no zero-hi build
# row)
K7_LOS = {8: 0, 16: 123_456_789, 64: 2**32 - 1 - 64 * 64, 128: SENTINEL}


@pytest.mark.parametrize("v_rows", [8, 16, 64, 128])
@pytest.mark.parametrize("n_planes", [1, 2])
def test_k7_domain_entry_matches_jax_scan_band(v_rows, n_planes):
    # K7's entry on the probe key planes (on the CPU: the int64 mapping,
    # then the index form's plain version) against the JAX scan band on
    # the same numpy inputs: _probe_idx, then the TPU kernel in interpret
    # mode, exact
    rng = np.random.default_rng(v_rows * 10 + n_planes)
    v_slots, lo = v_rows * 128, K7_LOS[v_rows]
    bitmap = rng.integers(0, 2**32, (8, 128), dtype=np.uint32)
    flat = bitmap.reshape(-1)
    flat[0] |= 1                                   # the first slot and
    flat[(v_slots - 1) >> 5] |= np.uint32(1 << 31)  # the last, occupied
    planes = [rng.integers(0, 2**32, (v_rows, 128), dtype=np.uint32)
              for _ in range(n_planes)]
    n, npv = 40 * 128, 40 * 128 - 7
    pk = workload.dense_domain_keys(rng, n, lo, v_slots)
    # lo, the last slot, past it, below lo (lo itself at lo 0), a high
    # word, u32-max, u64-max
    pk[10:17] = np.array([lo, lo + v_slots - 1, lo + v_slots,
                          max(lo, 1) - 1, 2**32 + lo, 2**32 - 1, 2**64 - 1],
                         np.uint64)
    pk[npv:] = lo                          # in the domain, past np_valid
    jph, jpl = (jnp.asarray(a) for a in ju64.split_u64(pk))
    pidx = jdb._probe_idx(jph, jpl, np.int32(npv), jnp.uint32(lo), v_slots)
    outs = jbp.probe_gather_bitmap(
        jnp.asarray(bitmap), tuple(jnp.asarray(p) for p in planes),
        pidx.reshape(-1, 128), d_rows=8, v_rows=v_rows, block_m=40,
        interpret=True)
    ph, pl = tu64.device_planes(pk, "cpu")
    hit, *vals = tbp.probe_gather_bitmap(_t(bitmap), [_t(p) for p in planes],
                                         ph, pl, npv, _lo(lo), v_rows)
    assert hit.dtype == torch.bool and len(vals) == n_planes
    want_hit = np.asarray(outs[0]).reshape(-1) == 1
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    for g, w in zip(vals, outs[1:]):
        np.testing.assert_array_equal(_u32(g), np.asarray(w).reshape(-1))
    assert want_hit.any() and not want_hit[npv:].any()
    # the first slot; the last, unless a high word puts it out of reach
    assert want_hit[10] and (want_hit[11] or lo + v_slots > 2**32)
    assert not want_hit[[12, 14, 16]].any()    # past the domain, hi word, max
    assert (np.asarray(outs[1]).reshape(-1)[npv:] == 0).all()


def test_k7_wrapper_checks_its_inputs():
    bitmap = _t(np.zeros((8, 128), np.uint32))
    plane = _t(np.zeros((128, 128), np.uint32))
    ph, pl = tu64.device_planes(np.arange(10, dtype=np.uint64), "cpu")
    args = (ph, pl, 10, _lo(0))
    with pytest.raises(ValueError):                       # shape != (v_rows, 128)
        tbp.probe_gather_bitmap(bitmap, [plane], *args, 64)
    with pytest.raises(ValueError):                       # three planes
        tbp.probe_gather_bitmap(bitmap, [plane] * 3, *args, 128)
    with pytest.raises(ValueError):                       # past the band
        tbp.probe_gather_bitmap(bitmap, [_t(np.zeros((256, 128), np.uint32))],
                                *args, 256)
    with pytest.raises(ValueError):                       # bitmap rows
        tbp.probe_gather_bitmap(bitmap[:4], [plane], *args, 128)
    with pytest.raises(ValueError):                       # int64 key planes
        tbp.probe_gather_bitmap(bitmap, [plane], ph.long(), pl.long(), 10,
                                _lo(0), 128)
    with pytest.raises(ValueError):                       # int32 lo
        tbp.probe_gather_bitmap(bitmap, [plane], ph, pl, 10, _lo(0).int(),
                                128)
    with pytest.raises(ValueError):                       # np_valid past rows
        tbp.probe_gather_bitmap(bitmap, [plane], ph, pl, 11, _lo(0), 128)
    hit, val = tbp.probe_gather_bitmap(bitmap, [plane], *args, 128)
    assert hit.dtype == torch.bool and not hit.any() and not val.any()
    hit, val = tbp.probe_gather_bitmap(bitmap, [plane], ph[:0], pl[:0], 0,
                                       _lo(0), 128)
    assert hit.numel() == val.numel() == 0


# --- K8: the index form's plain version, and the domain entry -------------------

def test_k8_plain_matches_pallas_on_sorted_stream():
    # the JAX kernel takes block-sorted indices and `rs` windows; the port's
    # takes any order, so it gets the JAX path's sorted stream here.  The
    # dense probe side keeps JAX's unresolved count at 0.
    rng = np.random.default_rng(8)
    v_rows, block_rows, sels = 256, 16, 8
    presence = (rng.random((v_rows, 128)) < 0.6).astype(np.uint32)
    planes = [presence] + [rng.integers(0, 2**32, (v_rows, 128),
                                        dtype=np.uint32) for _ in range(2)]
    n = 4096 - 37
    idx = rng.integers(1_000, 1_000 + 8_192, n, dtype=np.uint32)
    idx[rng.random(n) < 0.1] = SENTINEL
    s = jdb._blockwise_sorted_idx(jnp.asarray(idx), 4096)
    rs = jnp.clip((s[:, 0] >> jnp.uint32(7)).astype(jnp.int32), 0,
                  v_rows - sels)
    mask, keys, vh, vl, unres = jdv.probe_gather_staged(
        tuple(jnp.asarray(p) for p in planes), s,
        rs.reshape(-1, 1, block_rows), v_rows=v_rows, block_rows=block_rows,
        sels=sels, interpret=True)
    assert int(unres) == 0
    sorted_idx = np.array(s).reshape(-1)
    np.testing.assert_array_equal(np.asarray(keys).reshape(-1), sorted_idx)
    hit, got_vh, got_vl = tdv.probe_gather_staged_plain(
        [_t(p) for p in planes], _t(sorted_idx), v_rows)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(mask).reshape(-1) != 0)
    np.testing.assert_array_equal(_u32(got_vh), np.asarray(vh).reshape(-1))
    np.testing.assert_array_equal(_u32(got_vl), np.asarray(vl).reshape(-1))
    # unsorted: the same rows, in the input's order
    hit_u, _, vl_u = tdv.probe_gather_staged_plain(
        [_t(p) for p in planes], _t(idx), v_rows)
    order = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(hit_u.numpy()[order],
                                  hit.numpy()[:n])
    np.testing.assert_array_equal(_u32(vl_u)[order], _u32(got_vl)[:n])


def test_k8_wrapper_checks_its_inputs():
    v_rows = 256
    occ = np.zeros(v_rows * 128, bool)
    presence = _presence(occ, v_rows)
    plane = _t(np.zeros((v_rows, 128), np.uint32))
    ph, pl = tu64.device_planes(np.arange(10, dtype=np.uint64), "cpu")
    args = (ph, pl, 10, _lo(0))
    with pytest.raises(ValueError):                       # no value plane
        tdv.probe_gather_staged(presence, [], *args, v_rows)
    with pytest.raises(ValueError):                       # past the band
        tdv.probe_gather_staged(presence, [plane], *args, 16384)
    with pytest.raises(ValueError):                       # the scan band's
        tdv.probe_gather_staged(presence, [plane], *args, 128)
    with pytest.raises(ValueError):                       # plane of 128 rows
        tdv.probe_gather_staged(presence, [plane[:128]], *args, v_rows)
    with pytest.raises(ValueError):                       # presence rows
        tdv.probe_gather_staged(presence[:4], [plane], *args, v_rows)
    with pytest.raises(ValueError):                       # int32 lo
        tdv.probe_gather_staged(presence, [plane], ph, pl, 10,
                                _lo(0).int(), v_rows)
    with pytest.raises(ValueError):                       # np_valid past rows
        tdv.probe_gather_staged(presence, [plane], ph, pl, 11, _lo(0), v_rows)
    hit, val = tdv.probe_gather_staged(presence, [plane], *args, v_rows)
    assert hit.dtype == torch.bool and not hit.any() and not val.any()
    hit, val = tdv.probe_gather_staged(presence, [plane], ph[:0], pl[:0], 0,
                                       _lo(0), v_rows)
    assert hit.numel() == val.numel() == 0


def _presence(occ: np.ndarray, v_rows: int) -> torch.Tensor:
    """The presence input of K8's entry for the occupied slots `occ`: the
    bitmap of (v_rows // 32, 128) words, slot s at bit s & 31 of word
    s >> 5."""
    words = np.packbits(occ.reshape(-1, 32), axis=1, bitorder="little")
    return _t(words.view(np.uint32).reshape(v_rows // 32, 128))


def _staged_spec(occ, vplanes, pk, npv, lo):
    """K8's entry from its definition, in numpy, per probe row: (hit,
    *values) in probe order."""
    v_slots = occ.size
    pdiff = (pk - np.uint64(lo)) & np.uint64(SENTINEL)
    ok = (np.arange(pk.size) < npv) & (pk < 2**32) & (pdiff < v_slots)
    slot = np.where(ok, pdiff, 0).astype(np.int64)
    hit = ok & occ[slot]
    return (hit, *(np.where(hit, p.reshape(-1)[slot], 0) for p in vplanes))


def _check_staged_entry(rng, v_rows, ph, pl, pk, npv, lo, n_planes,
                        density=0.6):
    occ = rng.random(v_rows * 128) < density
    occ[[0, -1]] = True                    # the first and the last slot
    vplanes = [rng.integers(0, 2**32, (v_rows, 128), dtype=np.uint32)
               for _ in range(n_planes)]
    got = tdv.probe_gather_staged(_presence(occ, v_rows),
                                  [_t(p) for p in vplanes], ph, pl, npv,
                                  _lo(lo), v_rows)
    want = _staged_spec(occ, vplanes, pk, npv, lo)
    assert got[0].dtype == torch.bool and len(got) == 1 + n_planes
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_u32(g), w)
    return want[0]


@pytest.mark.parametrize("v_rows", [256, 512, 1024, 2048, 4096, 8192])
def test_k8_domain_at_every_rung_matches_numpy_spec(v_rows):
    # a lo inside u32, lo 0, a domain at the top of u32 (2^32 - 1 at its
    # first slot, small keys wrapping into the slots past it) and lo =
    # SENTINEL (no zero-hi build row: 2^32 - 1 lands on slot 0)
    rng = np.random.default_rng(v_rows)
    v_slots = v_rows * 128
    for lo in (123_456_789, 0, 2**32 - 1 - v_slots // 2, SENTINEL):
        pk = workload.dense_domain_keys(rng, 6_001, lo, v_slots)
        pk[7:9] = [lo + v_slots - 1, lo + v_slots]         # last slot, past
        pk[9:11] = [2**32 - 1, 2**64 - 1]
        ph, pl = tu64.device_planes(pk, "cpu")
        for npv in (pk.size, pk.size - 5):
            hit = _check_staged_entry(rng, v_rows, ph, pl, pk, npv, lo,
                                      1 + (lo % 2))
            assert hit.any() and not hit[npv:].any()


@pytest.mark.parametrize("offs", [(0, 0), (1, 1), (1, 3), (2, 0)])
def test_k8_domain_on_edge_key_views_matches_numpy_spec(offs):
    # probe planes that start 0-3 words into longer planes, each its own way
    rng = np.random.default_rng(sum(offs) + 80)
    v_rows, lo = 1024, 987_654_321
    pk = workload.dense_domain_keys(rng, 5_003, lo, v_rows * 128)
    ph, pl = workload.offset_plane_views(pk, "cpu", *offs)
    assert (ph.storage_offset(), pl.storage_offset()) == offs
    for n_planes in (1, 2):
        _check_staged_entry(rng, v_rows, ph, pl, pk, pk.size - 3, lo,
                            n_planes)


# --- K9: materialize_copy -------------------------------------------------------

def test_k9_plain_matches_pallas():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, (256, 128), dtype=np.uint32)
    want = np.asarray(jdv.materialize_copy(jnp.asarray(x), interpret=True))
    src = _t(x)
    got = tdv.materialize_copy(src)
    assert got.shape == src.shape and got.data_ptr() != src.data_ptr()
    np.testing.assert_array_equal(tu64.to_numpy_u32(got), want)
    flat = src.reshape(-1)
    for view in (flat[1:8], flat[3:], flat[:0]):            # misaligned, odd
        assert torch.equal(tdv.materialize_copy(view), view)
    with pytest.raises(ValueError):
        tdv.materialize_copy(src[:, ::2])


# --- direct_join_materialize ------------------------------------------------------

def _planes_of(bk, bv, pk):
    return [*ju64.split_u64(bk), *ju64.split_u64(bv), *ju64.split_u64(pk)]


def _jax_mat(bk, bv, pk, nbv, npv, v_rows, narrow):
    out = jdb.direct_join_materialize(
        *(jnp.asarray(a) for a in _planes_of(bk, bv, pk)), np.int32(nbv),
        np.int32(npv), v_rows=v_rows, narrow_values=narrow, interpret=True)
    count = int(out[0])
    return (count,
            ju64.join_u64(np.asarray(out[1]), np.asarray(out[2]))[:count],
            ju64.join_u64(np.asarray(out[3]), np.asarray(out[4]))[:count],
            int(np.asarray(out[5])[3]))


def _port_mat(bk, bv, pk, nbv, npv, v_rows, narrow):
    out = tdb.direct_join_materialize(
        *(_t(a) for a in _planes_of(bk, bv, pk)), nbv, npv, v_rows=v_rows,
        narrow_values=narrow)
    count = int(out[0])
    assert all(o.shape == (len(pk),) for o in out[1:5])
    if narrow:
        assert not out[3].any()
    return (count, tu64.to_numpy_u64(out[1], out[2], count),
            tu64.to_numpy_u64(out[3], out[4], count), int(out[5][3]))


def _case(name):
    """(bk, bv, pk, nb_valid, np_valid, v_rows); narrow when every value
    is below 2^32."""
    rng = np.random.default_rng(len(name))
    if name == "scan_j1_q1":                       # v_rows 8, values 1..100
        bk = rng.integers(1_000, 1_044, 40, dtype=np.uint64)
        bv = rng.integers(1, 101, 40, dtype=np.uint64)
        pk = rng.integers(990, 1_060, 6_000, dtype=np.uint64)
    elif name == "scan_top_wide":                  # v_rows 128, u64 values
        bk = rng.integers(2**31, 2**31 + 16_000, 3_000, dtype=np.uint64)
        bv = rng.integers(0, 2**64, 3_000, dtype=np.uint64)
        pk = rng.integers(2**31 - 500, 2**31 + 20_000, 12_000,
                          dtype=np.uint64)
    elif name == "scan_dups_tails":                # row ids as values
        base = rng.integers(0, 900, 600, dtype=np.uint64)
        bk = np.concatenate([base, base, base[:100]])
        bv = np.arange(bk.size, dtype=np.uint64)
        pk = rng.integers(0, 1_100, 5_000, dtype=np.uint64)
        pk[::97] = 2**33 + pk[::97]                # hi-word probes
        return bk, bv, pk, 1_150, 4_321, tdb.v_rows_for(900)
    elif name == "scan_bad_rows":                  # hi-word and past-rung rows
        bk = rng.integers(0, 900, 700, dtype=np.uint64)
        bk[[3, 50]] = [2**40 + 5, 5_000]
        bv = rng.integers(1, 101, 700, dtype=np.uint64)
        pk = rng.integers(0, 6_000, 4_000, dtype=np.uint64)
        return bk, bv, pk, 700, 4_000, 8
    elif name == "staged_narrow":                  # J1 Q2-like, v_rows 256
        bk = rng.integers(5, 5 + 20_000, 15_000, dtype=np.uint64)
        bv = rng.integers(1, 101, 15_000, dtype=np.uint64)
        pk = rng.integers(0, 24_000, 16_000, dtype=np.uint64)
    elif name == "staged_wide":                    # u64 values, 3 planes
        bk = rng.integers(5, 5 + 20_000, 15_000, dtype=np.uint64)
        bv = rng.integers(0, 2**64, 15_000, dtype=np.uint64)
        pk = rng.integers(0, 24_000, 16_000, dtype=np.uint64)
    elif name == "staged_dups_tails":              # duplicates, tails, hi words
        base = rng.integers(100, 20_100, 9_000, dtype=np.uint64)
        bk = np.concatenate([base, base[::-1]])
        bv = np.arange(bk.size, dtype=np.uint64)
        pk = rng.integers(0, 22_000, 16_000, dtype=np.uint64)
        pk[::51] = 2**35 + pk[::51]
        return bk, bv, pk, 17_000, 15_000, 256
    elif name == "all_miss":
        bk = np.arange(50, dtype=np.uint64)
        bv = np.arange(50, dtype=np.uint64)
        pk = np.arange(1_000, 2_000, dtype=np.uint64)
        return bk, bv, pk, 50, 1_000, 8
    else:
        raise KeyError(name)
    span = int(bk.max() - bk.min()) + 1
    return bk, bv, pk, len(bk), len(pk), tdb.v_rows_for(span)


@pytest.mark.parametrize("name", [
    "scan_j1_q1", "scan_top_wide", "scan_dups_tails", "scan_bad_rows",
    "staged_narrow", "staged_wide", "staged_dups_tails", "all_miss"])
def test_direct_join_materialize_matches_jax_and_oracle(name):
    bk, bv, pk, nbv, npv, v_rows = _case(name)
    narrow = int(bv.max()) < 2**32
    staged = v_rows > tdb.MAT_SCAN_MAX_V_ROWS
    assert staged == name.startswith("staged")
    want = _jax_mat(bk, bv, pk, nbv, npv, v_rows, narrow)
    got = _port_mat(bk, bv, pk, nbv, npv, v_rows, narrow)
    assert got[0] == want[0] and got[3] == want[3]
    assert (got[3] > 0) == (name == "scan_bad_rows")
    if staged:                                     # JAX: domain order
        for g, w in zip(_sorted(*got[1:3]), _sorted(*want[1:3])):
            np.testing.assert_array_equal(g, w)
    else:                                          # both: probe order
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    if got[3] == 0:                                # the oracle, probe order
        keys, vals = _oracle_rows(bk[:nbv], bv[:nbv], pk[:npv])
        assert got[0] == keys.size
        np.testing.assert_array_equal(got[1], keys)
        np.testing.assert_array_equal(got[2], vals)


def _staged_domain_case(name):
    """(bk, pk, nb_valid, np_valid) of one staged-band case: 15,000 build
    rows over a span of 20,000 keys and 16,000 probe rows (the shapes of
    the staged cases above, so the JAX calls share their compiles), dense
    enough that the TPU kernel's window resolves every probe."""
    rng = np.random.default_rng(len(name) + 100)
    base = 700_000_000
    bk = rng.integers(base, base + 20_000, 15_000, dtype=np.uint64)
    pk = rng.integers(base - 2_000, base + 22_000, 16_000, dtype=np.uint64)
    nbv, npv = len(bk), len(pk)
    if name == "hi_word_rows":
        # bad hi-word build rows, one with a low word below lo, which must
        # not set it (the materialize lo is over zero-hi rows); hi-word
        # probes whose low word is a build key
        bk[[3, 70]] = [2**40 + 5, 2**33 + base - 10]
        pk[:40] = 2**40 + 5
        pk[40:60] = bk[100] + np.uint64(2**32)
    elif name == "below_lo":
        pk[:800] = rng.integers(0, base, 800, dtype=np.uint64)
        pk[800:810] = base - 1
    elif name == "u32_and_u64_max":
        # a domain at the top of u32: 2^32 - 1 joins; small probe keys wrap
        # into the slots past it and miss; 2^64 - 1 is a bad build row and
        # a probe that misses
        bk = rng.integers(2**32 - 20_000, 2**32, 15_000, dtype=np.uint64)
        bk[0], bk[1] = 2**32 - 1, 2**64 - 1
        pk = np.concatenate([rng.choice(bk[2:], 13_000),
                             np.arange(3_000, dtype=np.uint64)])
        pk[:5], pk[5:10] = 2**32 - 1, 2**64 - 1
    elif name == "padding_tail":
        # rows past the valid counts: build keys below lo that would move
        # it, probes of build keys that must not join
        nbv, npv = 12_000, 14_000
        bk[nbv:] = rng.integers(base - 5_000, base, bk.size - nbv,
                                dtype=np.uint64)
        pk[npv:] = rng.choice(bk[:nbv], pk.size - npv)
    elif name == "empty_valid_build":
        nbv = 0
    elif name == "empty_valid_probe":
        npv = 0
    elif name == "no_zero_hi_build":
        # no zero-hi build row: lo = SENTINEL, every build row is bad, and a
        # probe of 2^32 - 1 maps to slot 0, which is empty
        bk |= np.uint64(2**36)
        pk[:10] = 2**32 - 1
    else:
        raise KeyError(name)
    return bk, pk, nbv, npv


def _good_rows_spec(bk, bv, pk, nbv, npv, v_rows):
    """The staged band's rows from their definition, in probe order: the
    oracle over the valid build rows in the domain (lo over the zero-hi
    ones), and the bad-row count."""
    bk, bv, pk = bk[:nbv], bv[:nbv], pk[:npv]
    zero_hi = bk[bk < 2**32]
    lo = int(zero_hi.min()) if zero_hi.size else SENTINEL
    bdiff = (bk - np.uint64(lo)) & np.uint64(SENTINEL)
    good = (bk < 2**32) & (bdiff < v_rows * 128)
    keys, vals = _oracle_rows(bk[good], bv[good], pk)
    return keys, vals, int((~good).sum())


STAGED_DOMAIN_CASES = ["hi_word_rows", "below_lo", "u32_and_u64_max",
                       "padding_tail", "empty_valid_build",
                       "empty_valid_probe", "no_zero_hi_build"]


@pytest.mark.parametrize("name", STAGED_DOMAIN_CASES)
@pytest.mark.parametrize("v_rows", [256, 1024])
def test_staged_domain_entry_matches_jax_and_spec(name, v_rows):
    # narrow values at v_rows 256, u64 values (two value planes) at 1024;
    # JAX emits domain order (compared as sorted pairs), the port and the
    # spec probe order
    bk, pk, nbv, npv = _staged_domain_case(name)
    rng = np.random.default_rng(v_rows)
    narrow = v_rows == 256
    bv = rng.integers(1, 101 if narrow else 2**64, bk.size, dtype=np.uint64)
    got = _port_mat(bk, bv, pk, nbv, npv, v_rows, narrow)
    want = _jax_mat(bk, bv, pk, nbv, npv, v_rows, narrow)
    assert (got[0], got[3]) == (want[0], want[3])
    for g, w in zip(_sorted(*got[1:3]), _sorted(*want[1:3])):
        np.testing.assert_array_equal(g, w)
    keys, vals, n_bad = _good_rows_spec(bk, bv, pk, nbv, npv, v_rows)
    assert got[3] == n_bad and got[0] == keys.size
    np.testing.assert_array_equal(got[1], keys)
    np.testing.assert_array_equal(got[2], vals)
    if name in ("hi_word_rows", "u32_and_u64_max", "no_zero_hi_build"):
        assert n_bad > 0
    if name == "u32_and_u64_max":
        assert (keys == 2**32 - 1).sum() == 5


@pytest.mark.parametrize("v_rows", [8, 1024])
@pytest.mark.parametrize("empty", ["build", "probe"])
def test_direct_join_materialize_empty_sides(v_rows, empty):
    # the JAX scan band cannot take an empty probe side, which api.py never
    # hands it, so these hold the port to the contract alone
    keys = np.arange(100, dtype=np.uint64)
    none = np.zeros(0, np.uint64)
    bk, pk = (none, keys) if empty == "build" else (keys, none)
    got = _port_mat(bk, bk, pk, len(bk), len(pk), v_rows, True)
    assert (got[0], got[3]) == (0, 0)


@pytest.mark.parametrize("v_rows", [4, 200, 288, 16384])
def test_direct_join_materialize_takes_only_its_rungs(v_rows):
    # v_rows_for's rungs are the powers of two from 8 to MAT_MAX_V_ROWS; K8
    # stages v_rows // 32 bitmap rows, so an off-rung v_rows is refused at
    # the band's entry, not inside a kernel's wrapper
    keys = np.arange(100, dtype=np.uint64)
    with pytest.raises(ValueError, match="power of two"):
        tdb.direct_join_materialize(
            *(_t(a) for a in _planes_of(keys, keys, keys)), 100, 100,
            v_rows=v_rows)


def test_staged_gap_is_exact():
    # the JAX package's gap shape (test_direct_mat.py::
    # test_staged_gap_overflow_unresolved): keys at both ends of a 2^19-slot
    # span leave tile rows straddling the gap outside the TPU kernel's
    # window, so JAX reports special[3] > 0.  K8 has no window: the port
    # materializes exactly with special[3] == 0 (oracle only: the JAX run of
    # this shape is slow in interpret mode).
    span = 1 << 19
    bk = np.concatenate([np.arange(500, dtype=np.uint64),
                         np.arange(span - 500, span, dtype=np.uint64)])
    bv = np.arange(1_000, dtype=np.uint64)
    pk = np.concatenate([np.arange(400, dtype=np.uint64),
                         np.arange(span - 400, span, dtype=np.uint64)])
    pk = np.tile(pk, 40)                                   # 32K probes
    v_rows = tdb.v_rows_for(span)
    assert v_rows > tdb.MAT_SCAN_MAX_V_ROWS
    count, keys, vals, sp3 = _port_mat(bk, bv, pk, len(bk), len(pk), v_rows,
                                       True)
    want = _oracle_rows(bk, bv, pk)
    assert (count, sp3) == (want[0].size, 0)
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(vals, want[1])


def test_constants_and_v_rows_for_match_jax():
    for name in ("MAT_SCAN_MAX_V_ROWS", "MAT_MAX_V_ROWS", "MAX_BUILD_ROWS"):
        assert getattr(tdb, name) == getattr(jdb, name), name
    spans = [1, 44, 1_024, 1_025, 11_000, 16_384, 16_385, 44_000, 110_000,
             2**19, 2**20 - 1, 2**20, 2**20 + 1]
    for span in spans:
        assert tdb.v_rows_for(span) == jdb.v_rows_for(span), span
    with pytest.raises(ValueError):
        _port_mat(np.arange(9, dtype=np.uint64), np.arange(9, dtype=np.uint64),
                  np.arange(9, dtype=np.uint64), 9, 9, 16_384, True)


# --- through the API --------------------------------------------------------------

def _j1_like(nb, npr, seed):
    """db-benchmark J1-shaped columns: keys uniform over 1.1x the build
    rows, values 1..100 (models/workload.py:j1_suite)."""
    rng = np.random.default_rng(seed)
    universe = int(nb * 1.1)
    return (rng.integers(0, universe, nb, dtype=np.uint64),
            rng.integers(1, 101, nb, dtype=np.uint64),
            rng.integers(0, universe, npr, dtype=np.uint64))


@pytest.mark.parametrize("band,nb,npr", [("scan", 200, 50_000),
                                         ("staged", 15_000, 16_000)])
def test_api_routes_direct_and_matches_jax(band, nb, npr, monkeypatch):
    open_gates(monkeypatch)          # adaptive as direct takes the keys
    bk, bv, pk = _j1_like(nb, npr, seed=nb)
    want = _oracle_rows(bk, bv, pk)
    jcount, _, jkeys, jvals = fj.join_materialize(
        bk, bv, pk, strategy="direct", return_arrays=True)
    for strategy in ("adaptive", "direct"):
        count, secs, keys, vals, info = ft.join_materialize(
            bk, bv, pk, strategy=strategy, device="cpu", return_arrays=True,
            return_info=True)
        assert info["strategy"] == "direct" and not info["retried"]
        assert (info["d_rows"] > tdb.MAT_SCAN_MAX_V_ROWS) == (band == "staged")
        assert count == jcount == want[0].size and secs > 0.0
        np.testing.assert_array_equal(keys, want[0])       # probe order
        np.testing.assert_array_equal(vals, want[1])
        for g, w in zip(_sorted(keys, vals), _sorted(jkeys, jvals)):
            np.testing.assert_array_equal(g, w)
    count, _, info = ft.adaptive_join(bk, bv, pk, device="cpu",
                                      return_info=True)
    assert count == want[0].size and info["strategy"] == "direct"


def test_api_bad_build_rows_rerun_on_merge(monkeypatch):
    # a rung too small for the span puts build rows outside the domain:
    # special[3] > 0, and the API reruns the join on the exact merge path
    bk, bv, pk = _j1_like(2_000, 20_000, seed=4)
    monkeypatch.setattr(tdb, "v_rows_for", lambda span: 8)
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, strategy="direct", device="cpu", return_arrays=True,
        return_info=True)
    assert info["retried"] and info["strategy"] == "merge"
    want = _oracle_rows(bk, bv, pk)
    assert count == want[0].size
    for g, w in zip(_sorted(keys, vals), _sorted(*want)):
        np.testing.assert_array_equal(g, w)


def test_cross_strategy_materialize_multi_block():
    # more probe rows than three JAX interpret-mode sort blocks (3 x 2^14):
    # the shape at which the JAX package's fusion-barrier copy (K9) was
    # needed.  Every strategy gives the same count and row multiset.
    rng = np.random.default_rng(12)
    bk = rng.integers(0, 60_000, 20_000, dtype=np.uint64)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = rng.integers(0, 66_000, 3 * 2**14 + 5_000, dtype=np.uint64)
    want = _oracle_rows(bk, bv, pk)
    rows = {}
    for strategy in ("adaptive", "direct", "partitioned", "merge"):
        count, _, keys, vals, info = ft.join_materialize(
            bk, bv, pk, strategy=strategy, device="cpu", return_arrays=True,
            return_info=True)
        assert not info["retried"] and count == want[0].size
        rows[info["strategy"]] = _sorted(keys, vals)
        if strategy in ("direct", "partitioned"):          # probe order
            np.testing.assert_array_equal(keys, want[0])
            np.testing.assert_array_equal(vals, want[1])
    assert set(rows) == {"direct", "partitioned", "merge"}
    for g, w in zip(rows["merge"], _sorted(*want)):
        np.testing.assert_array_equal(g, w)


def test_api_direct_materialize_rejects_ineligible_builds():
    rng = np.random.default_rng(2)
    pk = rng.integers(0, 1_000, 2_000, dtype=np.uint64)
    wide = rng.integers(0, 1_000, 100, dtype=np.uint64)
    wide[7] = 2**32                                        # key >= 2^32
    sparse = np.array([0, 2**20], np.uint64)                # span 2^20 + 1
    many = np.arange(tdb.MAX_BUILD_ROWS + 1, dtype=np.uint64)  # > 2^20 rows
    for bk in (wide, sparse, many):
        with pytest.raises(ValueError, match="direct"):
            ft.join_materialize(bk, bk, pk, strategy="direct", device="cpu")
        # the adaptive entry takes the partitioned tier instead
        count, _, info = ft.adaptive_join(bk, bk, pk, device="cpu",
                                          return_info=True)
        assert info["strategy"] == "partitioned"
        assert count == _oracle_rows(bk, bk, pk)[0].size
    # span of exactly 2^20 slots is the last eligible one
    edge = np.array([0, 2**20 - 1], np.uint64)
    count, _, info = ft.join_materialize(edge, edge, pk, strategy="direct",
                                         device="cpu", return_info=True)
    assert info["strategy"] == "direct" and info["d_rows"] == 8192
    assert count == _oracle_rows(edge, edge, pk)[0].size
