"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the count and materialize paths end to end against the numpy
oracle.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality — every output is an integer count or a u32 bit
pattern.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch.models.workload import (
    RAGGED_KINDS, RangeBuildCase, WalkCase, dense_domain_keys, domain_sides,
    global_build_cases, global_walk_cases, homed_keys, offset_plane_views,
    ragged_counts, range_build_cases)
from flash_hash_join_tpu_torch.ops import bucket_table as bt
from flash_hash_join_tpu_torch.ops import compact as cp
from flash_hash_join_tpu_torch.ops import hash_table as ht
from flash_hash_join_tpu_torch.ops import range_table as rt
from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bkp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
from flash_hash_join_tpu_torch.ops.cuda import hash_build as hb
from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
from flash_hash_join_tpu_torch.ops.cuda import range_build as rb
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
from flash_hash_join_tpu_torch.utils.config import JoinConfig
from flash_hash_join_tpu_torch.utils.u64 import (device_planes, sortable,
                                                 to_device, to_numpy_u64)

SENTINEL = 0xFFFFFFFF
M64 = 2**64 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# aligned; misaligned alike; each plane its own way (odd lengths)
PLANE_OFFSETS = ((0, 0), (1, 1), (1, 3), (2, 0))


def _domain_entry_cases(rng, sizes, lo, n_bits):
    """domain_sides for each (nb, npr) of sizes: the second keeps every
    build row at or above lo, so the scan band's lo (over every row) stays
    put and most rows are in the domain; the last adds a high-word build
    row under every other row's low word, where the scan band's lo and the
    large band's part.  Yields (bk, pk, hi_under)."""
    for i, (nb, npr) in enumerate(sizes):
        hi_under = i == len(sizes) - 1
        bk, pk = domain_sides(rng, nb, npr, lo, n_bits,
                              below_lo=i != 1 and not hi_under,
                              hi_under=hi_under)
        yield bk, pk, hi_under


@pytest.mark.parametrize("d_rows", [8, 16, 32, 64, 128, 256])
def test_scan_domain_count_matches_plain(dev, d_rows):
    rng = np.random.default_rng(d_rows + 2)
    n_bits = d_rows * 4096
    lo = int(rng.integers(n_bits, 2**31))
    for bk, pk, hi_under in _domain_entry_cases(
            rng, ((200_001, 3_000_005), (200_003, 3_000_001), (0, 1_000),
                  (1_000, 0), (5, 7), (-1_001, 2_003), (200_005, 600_007)),
            lo, n_bits):
        npr = pk.size
        for offs in PLANE_OFFSETS:
            kh, kl = offset_plane_views(bk, dev, *offs)
            ph, pl = offset_plane_views(pk, dev, *offs[::-1])
            for nbv, npv in {(bk.size, npr),
                             (max(bk.size - 5, 0), max(npr - 3, 0))}:
                args = (kh, kl, ph, pl, nbv, npv, d_rows)
                before = ft.launch_counts()["scan_domain_count"]
                got = bp.scan_domain_count(*args)
                want = bp.scan_domain_count_plain(*args)
                torch.cuda.synchronize()
                assert [int(x) for x in got] == [int(x) for x in want], (
                    d_rows, bk.size, npr, offs, nbv, npv)
                assert ft.launch_counts()["scan_domain_count"] == before + (nbv > 0)
                if hi_under:                    # lo over EVERY valid row
                    assert [int(x) for x in got] != [
                        int(x) for x in dbm.fused_domain_bitmap_join_plain(
                            *args)]
                assert all(x.dim() == 0 and x.dtype == torch.int64
                           and x.device.type == "cuda" for x in got)


@pytest.mark.parametrize("d_rows", [512, 16384, 28672])
def test_fused_domain_bitmap_join_matches_plain(dev, d_rows):
    rng = np.random.default_rng(d_rows + 1)
    n_bits = d_rows * 4096
    lo = int(rng.integers(n_bits, 2**31))
    for bk, pk, hi_under in _domain_entry_cases(
            rng, ((2_000_001, 3_000_005), (2_000_003, 3_000_001), (0, 1_000),
                  (1_000, 0), (5, 7), (-1_001, 2_003), (500_005, 600_007)),
            lo, n_bits):
        npr = pk.size
        for offs in PLANE_OFFSETS:
            kh, kl = offset_plane_views(bk, dev, *offs)
            ph, pl = offset_plane_views(pk, dev, *offs[::-1])
            for nbv, npv in {(bk.size, npr),
                             (max(bk.size - 5, 0), max(npr - 3, 0))}:
                args = (kh, kl, ph, pl, nbv, npv, d_rows)
                before = ft.launch_counts()["dense_bitmap"]
                got = dbm.fused_domain_bitmap_join(*args)
                want = dbm.fused_domain_bitmap_join_plain(*args)
                torch.cuda.synchronize()
                assert [int(x) for x in got] == [int(x) for x in want], (
                    d_rows, bk.size, npr, offs, nbv, npv)
                assert ft.launch_counts()["dense_bitmap"] == before + (
                    nbv > 0)
                if hi_under:           # lo over the zero-high-word rows
                    assert [int(x) for x in got] != [
                        int(x) for x in bp.scan_domain_count_plain(*args)]
                assert all(x.dim() == 0 and x.dtype == torch.int64
                           and x.device.type == "cuda" for x in got)


def test_wrappers_refuse_bad_inputs(dev):
    kh, kl = device_planes(np.arange(16, dtype=np.uint64), dev)
    with pytest.raises(ValueError):                    # int64 planes
        dbm.fused_domain_bitmap_join(kh.long(), kl.long(), kh, kl, 16, 16,
                                     512)
    with pytest.raises(ValueError):                    # a side on the CPU
        bp.scan_domain_count(kh, kl, kh.cpu(), kl.cpu(), 16, 16, 8)
    presence = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    plane = torch.zeros((256, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                    # lo on the CPU
        dv.probe_gather_staged(presence, [plane], kh, kl, 16,
                               torch.tensor(0, dtype=torch.int64), 256)
    with pytest.raises(ValueError):                    # lo on the CPU
        bp.probe_gather_bitmap(presence, [plane[:128]], kh, kl, 16,
                               torch.tensor(0, dtype=torch.int64), 128)
    tk = torch.full((24, 128), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                    # K11 off its rungs
        bkp.probe_materialize_vmem(tk, tk, tk, tk, kh, kl, 16)
    with pytest.raises(ValueError):                    # K10 off its rungs
        bkp.probe_count_vmem(tk, tk, kh, kl, 16)


@pytest.mark.parametrize("span,expect", [(44_000, "scan_domain_count"),
                                         (3_000_000, "dense_bitmap")])
def test_adaptive_join_count_on_card(dev, span, expect):
    rng = np.random.default_rng(span)
    bk = rng.integers(10, 10 + span, 1_000_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, bk.size, dtype=np.uint64)
    pk = rng.integers(0, span + 20, 2_000_000, dtype=np.uint64)
    want = int(np.isin(pk, np.unique(bk)).sum())
    # adaptive runs what the measured gates decide for this cell ...
    count, secs, info = ft.adaptive_join_count(bk, bv, pk, return_info=True)
    assert count == want and not info["retried"] and secs > 0.0
    assert info["strategy"] == ft.adaptive_strategy(bk, bv, pk.size)
    # ... and the direct count launches its band's kernel once
    count, secs, info = ft.join_count(bk, bv, pk, strategy="direct",
                                      return_info=True)
    assert count == want and info["strategy"] == "direct"
    assert not info["retried"]
    assert info["launches"][expect] == 1 and secs > 0.0


def test_gate_sentinels_route_as_the_gate_says_on_card(dev):
    # each sentinel of harness/gate_drift.py, one on each side of each
    # measured gate: adaptive runs the route the gate decides, exactly
    from flash_hash_join_tpu_torch.harness import gate_drift
    from flash_hash_join_tpu_torch.harness.crossover import make_data
    from flash_hash_join_tpu_torch.utils.native import host_join_count
    for s in gate_drift.sentinels():
        bk, bv, pk = make_data(s.point, 0, {})
        fn = (ft.adaptive_join_count if s.point.mode == "count"
              else ft.adaptive_join)
        count, _, info = fn(bk, bv, pk, return_info=True)
        gate = ft.adaptive_strategy(bk, bv, pk.size, mode=s.point.mode)
        assert info["strategy"] == gate, (s.label, info)
        assert count == host_join_count(bk, pk), s.label


def test_merge_fallback_on_card(dev):
    rng = np.random.default_rng(1)
    bk = rng.integers(0, 2**64, 200_000, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 100_000),
                         rng.integers(0, 2**64, 300_000, dtype=np.uint64)])
    bk[:3] = 2**64 - 1
    pk[:5] = 2**64 - 1
    want = int(np.isin(pk, np.unique(bk)).sum())
    count, _, info = ft.join_count(bk, bk, pk, strategy="merge",
                                   return_info=True)
    assert info["strategy"] == "merge" and count == want
    count, _, keys, vals = ft.join_materialize(bk, bk, pk, strategy="merge",
                                               return_arrays=True)
    assert count == want
    np.testing.assert_array_equal(np.sort(keys), np.sort(pk[np.isin(pk, bk)]))
    np.testing.assert_array_equal(keys, vals)          # value == key here


# ---- partitioned tier: K3, K4, K5 -------------------------------------------

def _keys(rng, n, universe):
    keys = rng.integers(0, universe, n, dtype=np.uint64)
    keys[: min(n, 2)] = M64                            # u64-max key
    return keys


def _build_keys(rng, build):
    """Build keys: `build` random rows (the u64-max key among them), or one
    of the shapes that stress the bucket directory."""
    if isinstance(build, int):
        return _keys(rng, build, 3 * max(build, 1))
    if build == "two_ends":            # span 2^64-1 in a table searched whole
        return np.array([M64, 0], np.uint64)
    n = 200_003
    bk = rng.integers(0, 2**64, n, dtype=np.uint64)
    if build == "all_equal":                           # span 0
        bk[:] = bk[0]
    elif build == "full_span":                         # shift 64 - p
        bk[[5, 9]] = [0, M64]
    elif build == "crowded":       # 99 % in one bucket, far outliers
        bk[n // 100:] = rng.integers(5, 5 + n, n - n // 100, dtype=np.uint64)
        bk[:2] = [0, M64]
    elif build == "dup_run":                           # a 1e5-row run
        bk[50_000:150_000] = bk[3]
    return bk


def _table(rng, build, dev, layout):
    """The range table of a build: as build_range_table makes it, or with
    its directory forced to `layout`: None (no directory, searched whole),
    p bits, or "wide" (its own size, 64-bit offsets)."""
    bk = _build_keys(rng, build)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    kh, kl = device_planes(bk, dev)
    vh, vl = device_planes(bv, dev)
    table = rt.build_range_table(kh, kl, vh, vl, bk.size, with_values=True)
    if layout == "built" or bk.size == 0:
        return bk, table
    if layout is None:
        return bk, table._replace(dir=None, shift=None)
    p = rp.directory_bits(bk.size) or 6 if layout == "wide" else layout
    dir_, shift = rp.range_directory(
        table.keys, p, torch.int64 if layout == "wide" else None)
    return bk, table._replace(dir=dir_, shift=shift)


DIRECTORY_BUILDS = ["two_ends", "all_equal", "full_span", "crowded",
                    "dup_run"]


@pytest.mark.parametrize("build", [1, 5, 200_003, *DIRECTORY_BUILDS])
def test_range_directory_kernel_matches_plain(dev, build):
    keys = torch.sort(sortable(*device_planes(
        _build_keys(np.random.default_rng(7), build), dev)))[0]
    for p, dtype in itertools.product((1, 12, rp.MAX_DIR_BITS),
                                      (torch.int32, torch.int64)):
        before = ft.launch_counts()["range_directory"]
        got = rp.range_directory(keys, p, dtype)
        want = rp.range_directory_plain(keys, p, dtype)
        torch.cuda.synchronize()
        assert ft.launch_counts()["range_directory"] == before + 1
        assert got[0].dtype == dtype
        for g, w in zip(got, want):
            assert torch.equal(g, w), (build, p, dtype)


@pytest.mark.parametrize("layout", ["built", None, 6, "wide"])
@pytest.mark.parametrize("nb", [0, 1, 5, 200_003, *DIRECTORY_BUILDS])
def test_range_probe_kernels_match_plain(dev, nb, layout):
    rng = np.random.default_rng(nb if isinstance(nb, int) else len(nb))
    bk, table = _table(rng, nb, dev, layout)
    nb = bk.size
    for npr in (0, 7, 1_000_003):
        pk = _keys(rng, npr, 3 * max(nb, 1))
        if nb and npr:
            pk[2::3] = rng.choice(bk, len(pk[2::3]))
            pk[1::3] = pk[2::3][:len(pk[1::3])] + np.uint64(1)
        ph, pl = device_planes(pk, dev)
        for view, np_valid in (((ph, pl), npr), ((ph[1:], pl[1:]),
                                                 max(npr - 5, 0))):
            args = (*view, min(np_valid, view[0].numel()))
            before = ft.launch_counts()["range_probe_count"]
            got = int(rp.range_probe_count(table, *args))
            assert got == int(rp.range_probe_count_plain(table, *args))
            assert ft.launch_counts()["range_probe_count"] == before + (
                nb > 0 and args[-1] > 0)
            got = rp.range_probe_materialize(table, *args)
            want = rp.range_probe_materialize_plain(table, *args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (nb, npr, args[-1])


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
def test_range_join_count_chunked_on_card(dev, n_chunks):
    """The resident chunked count: equal to its plain version on CPU
    copies and to the single shot; the directory built once, K3 launched
    once for each chunk that holds a valid row (np_valid cuts the last)."""
    rng = np.random.default_rng(n_chunks)
    nb, npr = 1_000_000, 3_000_000
    bk = _keys(rng, nb, 3 * nb)
    pk = _keys(rng, npr, 3 * nb)
    pk[::4] = rng.choice(bk, len(pk[::4]))
    per = -(-npr // n_chunks)
    np_valid = npr - per // 2 if n_chunks > 1 else npr - 11
    planes = [*device_planes(bk, dev), *device_planes(bk, dev),
              *device_planes(pk, dev)]
    k3, dirs = ft.launch_counts()["range_probe_count"], ft.launch_counts()["range_directory"]
    count, special = rt.range_join_count_chunked(*planes, nb, np_valid,
                                                 n_chunks=n_chunks)
    torch.cuda.synchronize()
    assert ft.launch_counts()["range_probe_count"] - k3 == -(-np_valid // per)
    assert ft.launch_counts()["range_directory"] - dirs == 1
    assert special.tolist() == [0, 0, 0, 0] and count.dtype == torch.int64
    plain, _ = rt.range_join_count_chunked(*(p.cpu() for p in planes), nb,
                                           np_valid, n_chunks=n_chunks)
    single, _ = rt.range_join_count(*planes, nb, np_valid)
    assert int(count) == int(plain) == int(single) == int(
        np.isin(pk[:np_valid], bk).sum())


# ---- the partitioned tier's table build kernel ---------------------------------

def _varying(keys: np.ndarray) -> int:
    return int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))


def _range_build_on_card(case, dev, offsets=(0, 0)):
    """The build kernels' keys and values of a case, with values and
    without, and the whole table around them, equal bit for bit to the
    plain build's on the same card planes (key and value planes at word
    offsets `offsets`); the plan the card took is rb.plan of the keys'
    varying bits."""
    planes = [*offset_plane_views(case.build_keys, dev, *offsets),
              *offset_plane_views(case.build_values, dev, *offsets)]
    nb = case.nb_valid
    for with_values in (True, False):
        before = ft.launch_counts()["range_build"]
        keys, values = rb.range_build(*planes, nb, with_values=with_values)
        assert ft.launch_counts()["range_build"] - before == int(nb > 0)
        want_keys, want_values = rb.range_build_plain(
            *planes, nb, with_values=with_values)
        torch.cuda.synchronize()
        assert keys.dtype == torch.int64 and torch.equal(keys, want_keys)
        if with_values:
            assert values.dtype == torch.int32 and values.is_contiguous()
            assert torch.equal(values, want_values)
        else:
            assert values is None
        table = rt.build_range_table(*planes, nb, with_values=with_values)
        p = rp.directory_bits(nb)
        want_dir = rp.range_directory_plain(want_keys, p) if p else (None,
                                                                     None)
        for got, want in zip(table, (want_keys, want_values, *want_dir)):
            assert (got is None and want is None) or torch.equal(got, want)
        if nb:
            varying = _varying(case.build_keys[:nb])
            assert rb.device_plan(*planes, nb, with_values=with_values) == (
                rb.plan(varying, with_values)), case.name


@pytest.mark.parametrize("case", range_build_cases(), ids=lambda c: c.name)
def test_range_build_kernel_matches_plain(dev, case):
    _range_build_on_card(case, dev)


@pytest.mark.parametrize("name", ["j1_1e8_range_u64_max", "duplicates",
                                  "valid_cut", "rows_4097"])
def test_range_build_kernel_on_misaligned_planes(dev, name):
    case = next(c for c in range_build_cases() if c.name == name)
    _range_build_on_card(case, dev, offsets=(1, 3))


@pytest.mark.parametrize("kind", ["j1_1e7", "j1_1e8_range_1e7",
                                  "j1_1e8_range_u64_max_1e7",
                                  "equal_1e6_in_1e7", "full_range_1e7"])
def test_range_build_kernel_at_scale(dev, kind):
    # many tiles a pass: J1's own draw at 1e7 (24 bits), 1e7 keys over J1
    # 1e8's 27 bits, with one u64-max key (all eight passes, wide records),
    # 1e6 equal keys among 1e7, keys over all 64 bits
    rng = np.random.default_rng(23)
    n = 10_000_000
    if kind == "j1_1e7":
        bk = rng.permutation(np.arange(1, 11_000_001, dtype=np.uint64))[:n]
    elif kind == "full_range_1e7":
        bk = rng.integers(0, 2**64, n, dtype=np.uint64)
    else:
        bk = rng.integers(1, 110_000_001, n, dtype=np.uint64)
        if kind == "equal_1e6_in_1e7":
            bk[rng.choice(n, 1_000_000, replace=False)] = 55_555_555
        elif kind.startswith("j1_1e8_range_u64_max"):
            bk[n // 3] = M64
    bv = rng.integers(0, 2**64, n, dtype=np.uint64)
    _range_build_on_card(RangeBuildCase(kind, bk, bv, n), dev)


class _AtenOps(TorchDispatchMode):
    """The names of the aten ops run inside it (no profiler needed)."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_range_build_kernel_does_not_sync_or_sort(dev, monkeypatch):
    # on CUDA planes the table build runs no torch.sort, sortable key,
    # stack or gather, and never syncs
    case = next(c for c in range_build_cases() if c.name == "j1_1e8_range")
    planes = [*device_planes(case.build_keys, dev),
              *device_planes(case.build_values, dev)]
    nb = case.nb_valid
    want = rb.range_build_plain(*planes, nb, with_values=True)
    rb.range_build(*planes, nb, with_values=True)      # builds the library
    torch.cuda.synchronize()

    def plain_ran(*args, **kw):
        raise AssertionError("the plain build ran on CUDA planes")

    for owner, name in ((rb, "range_build_plain"), (rb, "sortable"),
                        (torch, "sort"), (torch, "stack")):
        monkeypatch.setattr(owner, name, plain_ran)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _AtenOps() as ops:
            table = rt.build_range_table(*planes, nb, with_values=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not ops.names & {"sort", "stack", "index", "gather", "bitwise_xor",
                            "mul", "add", "_to_copy"}, ops.names
    assert torch.equal(table.keys, want[0])
    assert torch.equal(table.values, want[1])


def test_range_build_kernel_refuses_bad_inputs(dev):
    kh, kl, vh, vl = (torch.zeros(64, dtype=torch.int32, device=dev)
                      for _ in range(4))
    with pytest.raises(ValueError, match="int32"):
        rb.range_build(kh.long(), kl, vh, vl, 64, with_values=True)
    with pytest.raises(ValueError, match="one device"):
        rb.range_build(kh, kl, vh.cpu(), vl, 64, with_values=True)
    with pytest.raises(ValueError, match="nb_valid"):
        rb.range_build(kh, kl, vh, vl, 65, with_values=False)


@pytest.mark.parametrize("fn", ["hash_join_radix", "adaptive_join",
                                "hash_join_count_radix"])
def test_partitioned_joins_launch_the_build_once(dev, fn):
    rng = np.random.default_rng(9)
    bk = rng.integers(0, 2**40, 300_000, dtype=np.uint64)
    bk[10:40] = bk[5]
    bv = np.arange(bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 200_000),
                         rng.integers(0, 2**40, 200_000, dtype=np.uint64)])
    count, _, info = getattr(ft, fn)(bk, bv, pk, return_info=True)
    assert count == int(np.isin(pk, bk).sum())
    assert info["strategy"] == "partitioned" or fn == "adaptive_join"
    assert info["launches"]["range_build"] == int(
        info["strategy"] == "partitioned")


@pytest.mark.parametrize("n", [0, 1, 4_095, 4_096, 1_000_003])
@pytest.mark.parametrize("density", [0.0, 0.37, 1.0])
def test_compact_kernel_matches_plain(dev, n, density):
    rng = np.random.default_rng(n)
    mask = torch.from_numpy(rng.random(n + 1) < density).to(dev)[1:]
    for n_planes in (2, 3, 4):
        cols = [to_device(rng.integers(0, 2**32, n + 1, dtype=np.uint32),
                          dev)[1:] for _ in range(n_planes)]
        for n_out in (n, n // 3):
            count, outs = sc.compact_by_mask(mask.contiguous(), cols, n_out)
            wcount, wouts = sc.compact_by_mask_plain(mask.contiguous(), cols,
                                                     n_out)
            torch.cuda.synchronize()
            assert int(count) == int(wcount) == int(mask.sum())
            keep = min(int(count), n_out)
            for o, w in zip(outs, wouts):
                assert torch.equal(o[:keep], w[:keep])


@pytest.mark.parametrize("n", [sc.TILE_ROWS - 1, sc.TILE_ROWS,
                               sc.TILE_ROWS + 1, 5 * sc.TILE_ROWS + 1])
@pytest.mark.parametrize("offset", [0, 1, 15])
def test_compact_kernel_at_tile_boundaries(dev, n, offset):
    # K5 around its tile (one less, one, one more, a multiple and one row),
    # views 0, 1 and 15 bytes past a 16-byte boundary: the first half of
    # the rows missing (whole first tiles empty) and the last third hit
    # (whole last tiles full), n_out at and below the count; two calls back
    # to back on one stream give the same (the look-back's scratch starts
    # from zero each call); one launch a call, the count a 0-d int64 on the
    # card
    assert sc.TILE_ROWS == _build.lib().fhj_compact_tile_rows()
    rng = np.random.default_rng(n + offset)
    bits = rng.random(n + offset) < 0.5
    bits[offset:offset + n // 2] = False
    bits[offset + n - n // 3:] = True
    mask = torch.from_numpy(bits).to(dev)[offset:]
    cols = [to_device(rng.integers(0, 2**32, n + offset, dtype=np.uint32),
                      dev)[offset:] for _ in range(3)]
    hits = int(bits[offset:].sum())
    for n_out in (n, hits // 2):
        wcount, want = sc.compact_by_mask_plain(mask, cols, n_out)
        before = ft.launch_counts()["compact"]
        runs = [sc.compact_by_mask(mask, cols, n_out) for _ in range(2)]
        torch.cuda.synchronize()
        assert ft.launch_counts()["compact"] == before + 2
        keep = min(hits, n_out)
        for count, outs in runs:
            assert count.dim() == 0 and count.dtype == torch.int64
            assert count.device.type == "cuda"
            assert int(count) == int(wcount) == hits
            for o, w in zip(outs, want):
                assert torch.equal(o[:keep], w[:keep]), (n, offset, n_out)


@pytest.mark.parametrize("fn", ["hash_join_radix", "adaptive_join"])
def test_materialize_on_card_matches_oracle(dev, fn):
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 2**64, 300_000, dtype=np.uint64)
    bk[1_000:1_100] = bk[7]                            # duplicate run
    bk[:2] = M64
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 400_000),
                         rng.integers(0, 2**64, 600_000, dtype=np.uint64)])
    uniq, first = np.unique(bk, return_index=True)     # min build row wins
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    count, secs, keys, vals, info = ft.join_materialize(
        bk, bv, pk, strategy="adaptive" if fn == "adaptive_join"
        else "partitioned", return_arrays=True, return_info=True)
    assert count == getattr(ft, fn)(bk, bv, pk)[0] == int(hit.sum())
    assert info["strategy"] == "partitioned" and not info["retried"]
    assert info["launches"]["range_probe_materialize"] == 1
    assert info["launches"]["compact"] == 1 and secs > 0.0
    np.testing.assert_array_equal(keys, pk[hit])       # probe order
    np.testing.assert_array_equal(vals, bv[first[pos[hit]]])
    count, _, info = ft.hash_join_count_radix(bk, bv, pk, return_info=True)
    assert count == int(hit.sum())
    assert info["launches"]["range_probe_count"] == 1


# ---- dense-domain materialize: K7, K8, K9 -----------------------------------

def _planes(rng, v_rows, n_planes, dev):
    return tuple(to_device(rng.integers(0, 2**32, (v_rows, 128),
                                        dtype=np.uint32), dev)
                 for _ in range(n_planes))


def _assert_same(got, want):
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _spy_on_probe_mapping(monkeypatch) -> list:
    """Make every call of the int64 probe mapping (domain_map.
    probe_domain_idx, under each name the package imports it by) on card
    tensors append to the returned list."""
    from flash_hash_join_tpu_torch.ops import domain_map as dm
    calls, mapping = [], dm.probe_domain_idx

    def spy(ph, *args):
        if ph.device.type == "cuda":
            calls.append(ph.numel())
        return mapping(ph, *args)
    for module in (dm, bp, dv, dbm):
        monkeypatch.setattr(module, "probe_domain_idx", spy)
    return calls


# one domain base per rung: 0, inside u32, the top of u32, SENTINEL
K7_LOS = {8: 0, 16: 123_456_789, 64: 2**32 - 1 - 64 * 64, 128: SENTINEL}


@pytest.mark.parametrize("v_rows", [8, 16, 64, 128])
@pytest.mark.parametrize("n_planes", [1, 2])
def test_probe_gather_bitmap_matches_plain(dev, v_rows, n_planes,
                                           monkeypatch):
    # K7's entry on the probe key planes: the edge keys (lo, the last slot,
    # past it, below lo, high words, u32-max, u64-max), views aligned and
    # misaligned each plane its own way, validity tails; one launch a call
    # and no int64 probe mapping on the card
    rng = np.random.default_rng(v_rows + n_planes)
    v_slots, lo = v_rows * 128, K7_LOS[v_rows]
    occ = np.zeros(8 * 4096, bool)
    occ[:v_slots] = rng.random(v_slots) < 0.6
    occ[[0, v_slots - 1]] = True
    bitmap = _bitmap_of(occ, 8, dev)
    vplanes = _planes(rng, v_rows, n_planes, dev)
    lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
    calls = _spy_on_probe_mapping(monkeypatch)
    for npr in (0, 7, 1_000_003):
        pk = dense_domain_keys(rng, npr, lo, v_slots)
        pk[:min(npr, 7)] = np.array(
            [lo, lo + v_slots - 1, lo + v_slots, max(lo, 1) - 1, 2**32 + lo,
             2**32 - 1, M64], np.uint64)[:min(npr, 7)]
        for offs in PLANE_OFFSETS:
            ph, pl = offset_plane_views(pk, dev, *offs)
            for npv in {npr, max(npr - 5, 0)}:
                args = (bitmap, vplanes, ph, pl, npv, lo_t, v_rows)
                before = ft.launch_counts()["probe_gather_bitmap"]
                got = bp.probe_gather_bitmap(*args)
                assert ft.launch_counts()["probe_gather_bitmap"] == before + (npr > 0)
                assert not calls, "the kernel's entry mapped on the card"
                want = bp.probe_gather_bitmap_domain_plain(*args)
                calls.clear()
                _assert_same(got, want)


def _bitmap_of(occ: np.ndarray, rows: int, dev) -> torch.Tensor:
    """The (rows, 128)-word bitmap of a bool mask over the slots."""
    words = np.packbits(occ.reshape(-1, 32), axis=1, bitorder="little")
    return to_device(words.view(np.uint32).reshape(rows, 128), dev)


@pytest.mark.parametrize("v_rows", [256, 512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("n_planes", [1, 2])
def test_probe_gather_staged_matches_plain(dev, v_rows, n_planes):
    # K8's domain entry: probe key planes with the edge keys of the count
    # tests, views aligned and misaligned each plane its own way, validity
    # tails, and lo inside u32, 0, at the top of u32 and SENTINEL
    rng = np.random.default_rng(v_rows + n_planes)
    v_slots = v_rows * 128
    occ = rng.random(v_slots) < 0.6
    occ[[0, -1]] = True
    presence = _bitmap_of(occ, v_rows // 32, dev)
    vplanes = _planes(rng, v_rows, n_planes, dev)
    for lo in (123_456_789, 0, 2**32 - 1 - v_slots // 2, SENTINEL):
        lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
        for npr in (0, 7, 1_000_003):
            pk = dense_domain_keys(rng, npr, lo, v_slots)
            for offs in PLANE_OFFSETS:
                ph, pl = offset_plane_views(pk, dev, *offs)
                for npv in {npr, max(npr - 5, 0)}:
                    args = (presence, vplanes, ph, pl, npv, lo_t, v_rows)
                    before = ft.launch_counts()["probe_gather_staged"]
                    got = dv.probe_gather_staged(*args)
                    want = dv.probe_gather_staged_domain_plain(*args)
                    _assert_same(got, want)
                    assert ft.launch_counts()["probe_gather_staged"] == before + (
                        npr > 0)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 1_000_003])
def test_materialize_copy_matches_plain(dev, n):
    _check_copy(dev, n)


# around one block of K9 (4 words a 16-byte load, 4 loads a thread, 256
# threads: 4096 words), and around 1056 blocks
@pytest.mark.parametrize("n", [4_095, 4_096, 4_097, 8_191, 8_192, 8_193,
                               4_325_375, 4_325_377])
def test_materialize_copy_around_its_unroll(dev, n):
    _check_copy(dev, n)


def _check_copy(dev, n):
    rng = np.random.default_rng(n)
    x = to_device(rng.integers(0, 2**32, n + 3, dtype=np.uint32), dev)
    for view in (x[:n], x[1:n + 1], x[2:n + 2], x[3:]):
        got = dv.materialize_copy(view)
        assert got.data_ptr() != view.data_ptr() or n == 0
        _assert_same((got,), (dv.materialize_copy_plain(view),))


@pytest.mark.parametrize("span,wide,kernels", [
    (44, False, ("probe_gather_bitmap",)),             # J1 Q1 shape, v_rows 8
    (11_000, True, ("probe_gather_bitmap",)),          # v_rows 128, 2 planes
    (110_000, False, ("probe_gather_staged",)),
    (1_000_000, True, ("probe_gather_staged",))])
def test_direct_materialize_on_card_matches_oracle(dev, span, wide, kernels,
                                                   monkeypatch):
    # both bands map the probe key planes inside their kernel: no int64
    # probe mapping on the card
    calls = _spy_on_probe_mapping(monkeypatch)
    rng = np.random.default_rng(span)
    nb = min(span, 100_000)
    bk = rng.integers(7, 7 + span, nb, dtype=np.uint64)
    bv = rng.integers(1, 2**64 if wide else 101, nb, dtype=np.uint64)
    pk = rng.integers(0, span + 20, 2_000_000, dtype=np.uint64)
    pk[:5] = 2**40 + 9                                 # hi-word probes
    uniq, first = np.unique(bk, return_index=True)     # min build row wins
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    _, _, ainfo = ft.adaptive_join(bk, bv, pk, return_info=True)
    assert ainfo["strategy"] == ft.adaptive_strategy(bk, bv, pk.size,
                                                     mode="materialize")
    count, secs, keys, vals, info = ft.join_materialize(
        bk, bv, pk, strategy="direct", return_arrays=True, return_info=True)
    assert info["strategy"] == "direct" and not info["retried"]
    for k in kernels + ("compact",):
        assert info["launches"][k] == 1, info
    assert info["launches"]["materialize_copy"] == 0, info   # on no path
    assert not calls, "the probe side was mapped in plain torch"
    assert count == int(hit.sum()) and secs > 0.0
    np.testing.assert_array_equal(keys, pk[hit])       # probe order
    np.testing.assert_array_equal(vals, bv[first[pos[hit]]])


# ---- vmem tier and stream compaction: K10, K11, K6 ---------------------------

def _bucket_table(rng, r_slots, dev, fill_bucket=False):
    """A bucket table of about 40 % load from random keys (the u64-max key
    among them); with fill_bucket, bucket 0's column is full to its last
    slot.  Returns (numpy build keys, table)."""
    bk = rng.integers(0, 2**64, int(0.4 * 128 * r_slots), dtype=np.uint64)
    if fill_bucket:
        cand = rng.integers(0, 2**64, 400 * r_slots, dtype=np.uint64)
        bk = np.concatenate([bk[_bucket_of(bk) != 0],
                             cand[_bucket_of(cand) == 0][:r_slots]])
    bk[:2] = M64
    kh, kl = device_planes(bk, dev)
    vh, vl = device_planes(rng.integers(0, 2**64, bk.size, dtype=np.uint64),
                           dev)
    return bk, bt.build_bucket_table(kh, kl, vh, vl, bk.size, r_slots=r_slots,
                                     with_values=True)


def _bucket_of(keys):
    return bkp.probe_buckets(*device_planes(keys, "cpu")).numpy()


@pytest.mark.parametrize("r_slots", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("fill", [False, True])
def test_bucket_probe_kernels_match_plain(dev, r_slots, fill):
    # K10 and K11 at every vmem rung (each above R 32 on its own layout,
    # whose launch is checked alone too: K11's keys and values, K10's keys
    # alone), the u64-max key on both sides, misaligned views and validity
    # tails
    rng = np.random.default_rng(r_slots + fill)
    bk, table = _bucket_table(rng, r_slots, dev, fill_bucket=fill)
    if fill:
        col = table.tk_hi[:, 0].cpu()
        assert bool((col != -1).all()), "bucket 0 is not full"
    planes = (table.tk_hi, table.tk_lo, table.tv_hi, table.tv_lo)
    _assert_same(bkp.bucket_major(*planes),
                 bkp.bucket_major_plain(*planes))
    _assert_same((bkp.bucket_major_keys(*planes[:2]),),
                 (bkp.bucket_major_keys_plain(*planes[:2]),))
    for npr in (0, 7, 3_000_005):
        pk = rng.integers(0, 2**64, npr + 1, dtype=np.uint64)
        pk[1::2] = rng.choice(bk, pk[1::2].size)
        pk[:4] = M64
        ph, pl = device_planes(pk, dev)
        for view in (slice(0, npr), slice(1, None)):    # aligned, misaligned
            p = (ph[view], pl[view])
            for np_valid in {npr, max(npr - 5, 0)}:
                before = ft.launch_counts()["probe_count_vmem"]
                got = bkp.probe_count_vmem(table.tk_hi, table.tk_lo, *p,
                                           np_valid)
                want = bkp.probe_count_vmem_plain(table.tk_hi, table.tk_lo,
                                                  *p, np_valid)
                torch.cuda.synchronize()
                assert int(got) == int(want), (r_slots, npr, np_valid)
                assert ft.launch_counts()["probe_count_vmem"] == before + (
                    np_valid > 0)
                args = (*planes, *p, np_valid)
                before = ft.launch_counts()["probe_materialize_vmem"]
                got = bkp.probe_materialize_vmem(*args)
                assert ft.launch_counts()["probe_materialize_vmem"] == before + (
                    npr > 0)
                _assert_same(got, bkp.probe_materialize_vmem_plain(*args))


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", RAGGED_KINDS)
def test_concat_ragged_blocks_matches_plain(dev, n_planes, kind):
    # one block and more than 32 x 132 (look-backs over many windows of 32
    # blocks); a block length that is no multiple of 4, so each block's
    # source lies at another 16-byte offset; plane p a view at word offset
    # (off + p) mod 4; int32 and int64 counts (out of range: int32 clipped)
    rng = np.random.default_rng(n_planes)
    gen = torch.Generator(device=dev).manual_seed(n_planes)
    for nblocks, block in ((1, 4_096), (600, 4_096), (5_000, 1_001)):
        counts64 = ragged_counts(rng, kind, nblocks, block)
        total = int(counts64.clip(0, block).sum())
        for off in range(4):
            planes = []
            for p in range(n_planes):
                o = (off + p) % 4
                flat = torch.randint(-2**31, 2**31, (nblocks * block + o,),
                                     device=dev, dtype=torch.int32,
                                     generator=gen)
                planes.append(flat[o:].view(nblocks, block))
            for dtype in (torch.int32, torch.int64):
                c = (counts64 if dtype == torch.int64
                     else counts64.clip(-2**31, 2**31 - 1))
                counts = torch.from_numpy(c).to(dtype).to(dev)
                before = ft.launch_counts()["concat_ragged_blocks"]
                got_total, got = sc.concat_ragged_blocks(planes, counts,
                                                         with_total=True)
                want = sc.concat_ragged_blocks_plain(planes, counts)
                torch.cuda.synchronize()
                assert ft.launch_counts()["concat_ragged_blocks"] == before + 1
                assert int(got_total) == total, (nblocks, off, dtype)
                for g, w in zip(got, want):
                    assert g.numel() == nblocks * block
                    assert torch.equal(g[:total], w[:total]), (
                        nblocks, block, off, dtype)


def test_concat_ragged_blocks_is_one_memset_and_one_kernel(dev):
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(0)
    planes = [torch.randint(-2**31, 2**31, (300, 65_536), device=dev,
                            dtype=torch.int32, generator=gen)
              for _ in range(4)]
    counts = torch.randint(0, 65_537, (300,), device=dev, dtype=torch.int32,
                           generator=gen)
    sc.concat_ragged_blocks(planes, counts)               # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sc.concat_ragged_blocks(planes, counts)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if not str(e.device_type).endswith("CPU")}
    assert sum(device.values()) == 2, device
    assert any("concat_ragged_kernel" in k for k in device), device
    assert any(k.startswith("Memset") for k in device), device


@pytest.mark.parametrize("strategy,use_bloom", [("vmem", False),
                                                ("global", False),
                                                ("global", True)])
def test_explicit_tiers_on_card_match_oracle(dev, strategy, use_bloom):
    rng = np.random.default_rng(5)
    nb = 20_000 if strategy == "vmem" else 500_000
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bk[100:200] = bk[7]                                # duplicate run
    bk[:2] = M64
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 1_000_000),
                         rng.integers(0, 2**64, 1_000_000, dtype=np.uint64)])
    uniq, first = np.unique(bk, return_index=True)     # min build row wins
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    kw = dict(strategy=strategy, use_bloom=use_bloom, return_info=True)
    count, secs, info = ft.join_count(bk, bv, pk, **kw)
    assert count == int(hit.sum()) and secs > 0.0
    assert info["strategy"] == strategy and not info["retried"]
    count, _, keys, vals, info = ft.join_materialize(bk, bv, pk,
                                                     return_arrays=True, **kw)
    assert count == int(hit.sum()) and not info["retried"]
    if strategy == "vmem":
        assert info["launches"]["probe_materialize_vmem"] == 1
    else:
        assert info["launches"]["global_walk_materialize"] == 1
    assert info["launches"]["compact"] == 1
    np.testing.assert_array_equal(keys, pk[hit])       # probe order
    np.testing.assert_array_equal(vals, bv[first[pos[hit]]])


def _walk_table(case, dev):
    """The global tier's table of a global_walk_cases case on dev, and
    the walk's static arguments."""
    cfg = case.cfg
    planes = [*device_planes(case.build_keys, dev),
              *device_planes(case.build_values, dev)]
    table = ht.build_table(
        *planes, len(case.build_keys), gbits=case.gbits,
        group_size=cfg.group_size, overflow_groups=cfg.overflow_groups,
        with_bloom=case.use_bloom, bloom_k=cfg.bloom_k,
        pre_shift=case.pre_shift, max_probe_iters=cfg.max_probe_iters)
    static = dict(gbits=case.gbits, group_size=cfg.group_size,
                  total_groups=(1 << case.gbits) + cfg.overflow_groups,
                  use_bloom=case.use_bloom, bloom_k=cfg.bloom_k,
                  max_iters=cfg.max_probe_iters, pre_shift=case.pre_shift)
    return table, static


@pytest.mark.parametrize("offsets", [(0, 0), (1, 3)])
@pytest.mark.parametrize("case", global_walk_cases(), ids=lambda c: c.name)
def test_global_walk_kernels_match_plain(dev, case, offsets):
    # the walk kernel, count and materialize, against the plain walk on the
    # same card tensors: counts, hit masks, value planes and walk statistics
    _check_walk_kernels(dev, case, offsets)


# both routes of ops/cuda/hash_walk.plan on the small cases: 0 levels, 1
# level of 3 digit bits, and 2 digit bits in passes of 1000 rows
WALK_ROUTES = {"levels0": dict(pbits=0), "levels1": dict(pbits=3),
               "passes_of_1000": dict(pbits=2, pass_rows=1000)}


@pytest.mark.parametrize("route", WALK_ROUTES)
@pytest.mark.parametrize("case", global_walk_cases(), ids=lambda c: c.name)
def test_global_walk_routes_match_plain(dev, case, route):
    with hw.forced(**WALK_ROUTES[route]):
        _check_walk_kernels(dev, case, (1, 3))


def _count_passes(dev, n_valid: int, static: dict) -> tuple[int, int]:
    """(walk launches, prune launches) of a count under the plan the
    wrapper takes (hw.forced included): a pass each where the plan prunes,
    else one walk."""
    props = torch.cuda.get_device_properties(dev)
    p = hw.plan(n_valid, static["gbits"], static["total_groups"],
                static["group_size"], static["use_bloom"], False,
                l2_bytes=props.L2_cache_size,
                sms=props.multi_processor_count, **hw._forced)
    if n_valid == 0:
        return 0, 0
    if p.prune:
        passes = -(-n_valid // p.pass_rows)
        return passes, passes
    return 1, 0


LAUNCHES = ("global_walk_count", "global_walk_materialize", "global_prune")


def _check_walk_kernels(dev, case, offsets):
    table, static = _walk_table(case, dev)
    ph, pl = offset_plane_views(case.probe_keys, dev, *offsets)
    n = ph.numel()
    n_valid = n if case.n_valid is None else case.n_valid
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    before = [ft.launch_counts()[k] for k in LAUNCHES]
    count = hw.global_walk_count(table, ph, pl, n_valid, stats=stats,
                                 **static)
    hit, vh, vl = hw.global_walk_materialize(table, ph, pl, n_valid, **static)
    torch.cuda.synchronize()
    walks, prunes = _count_passes(dev, n_valid, static)
    assert [ft.launch_counts()[k] - b for k, b in zip(LAUNCHES, before)] \
        == [walks, int(n > 0), prunes]
    ht.walk_stats.reset()
    want = ht.probe_count_plain(table, ph, pl, n_valid, probe_chunk=256,
                                **static)
    plain = ht.walk_stats.read()
    whit, wvh, wvl = ht.probe_rows_plain(table, ph, pl, n_valid,
                                         probe_chunk=256, **static)
    assert int(count) == int(want) == int(whit.sum())
    assert torch.equal(hit, whit)
    assert torch.equal(vh, wvh) and torch.equal(vl, wvl)
    assert stats.tolist() == [plain["groups"], plain["longest"],
                              plain["bloom_passed"]]


def _check_prune(dev, case, offsets):
    """prune_kernel against prune_plain on the same card tensors: the
    survivors as a set of rows (the kernel's order is its atomics'), the
    u64-max hits and stats[2]."""
    case = dataclasses.replace(case, use_bloom=True)
    table, static = _walk_table(case, dev)
    ph, pl = offset_plane_views(case.probe_keys, dev, *offsets)
    n_valid = ph.numel() if case.n_valid is None else case.n_valid
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    before = ft.launch_counts()["global_prune"]
    sh, sl, rows, count = hw.global_prune(table, ph, pl, n_valid,
                                          stats=stats, **static)
    torch.cuda.synchronize()
    assert ft.launch_counts()["global_prune"] - before == 1
    wh, wl, want = ht.prune_plain(table, ph, pl, n_valid, **static)
    m = int(rows[1])
    assert int(rows[0]) == 0 and m == wh.numel()
    got = sortable(sh[:m], sl[:m]).sort().values
    assert torch.equal(got, sortable(wh, wl).sort().values)
    assert int(count) == int(want)
    assert stats.tolist() == [0, 0, m]


@pytest.mark.parametrize("offsets", PLANE_OFFSETS)
@pytest.mark.parametrize("case", global_walk_cases(), ids=lambda c: c.name)
def test_global_prune_kernel_matches_plain(dev, case, offsets):
    _check_prune(dev, case, offsets)


# the count with bloom's routes: the walk's, and 1 level with the prune
# forced off (the route of words that outgrow half of L2)
PRUNE_ROUTES = dict(WALK_ROUTES, passes_of_1000_unpruned=dict(
    pbits=2, pass_rows=1000, prune=False))


@pytest.mark.parametrize("route", PRUNE_ROUTES)
@pytest.mark.parametrize("case", [c for c in global_walk_cases()
                                  if c.use_bloom], ids=lambda c: c.name)
def test_pruned_count_passes_on_both_routes(dev, case, route):
    # the count with bloom at each route, passes of 1000 rows included:
    # pruned at 1 level (a prune and a walk a pass), walked whole at 0 and
    # where the prune is off
    with hw.forced(**PRUNE_ROUTES[route]):
        _check_walk_kernels(dev, case, (0, 0))


def test_pruned_count_does_not_sync(dev):
    # the whole join of a count with bloom, pruned in passes of 1000 rows:
    # the survivors' number stays on the card
    case = next(c for c in global_walk_cases()
                if c.name == "n_valid_pass_cut_bloom")
    from flash_hash_join_tpu_torch import engine
    fn = engine.count_graph("global", n_build=len(case.build_keys),
                            use_bloom=True)
    args = [*device_planes(case.build_keys, dev),
            *device_planes(case.build_values, dev),
            *device_planes(case.probe_keys, dev), len(case.build_keys),
            case.n_valid]
    with hw.forced(pbits=2, pass_rows=1000):
        fn(*args)                          # builds the library, the stats
        torch.cuda.synchronize()
        before = ft.launch_counts()["global_prune"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            count, special = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert ft.launch_counts()["global_prune"] - before == 4
    want = int(np.isin(case.probe_keys[:case.n_valid], case.build_keys).sum())
    assert int(count) == want and int(special[3]) == 0


@pytest.mark.parametrize("use_bloom", [False, True])
def test_global_walk_plan_partitions_a_large_side(dev, use_bloom):
    # 4e6 build keys (2^20 + 64 groups, 64 MB of key rows, past half of L2)
    # and 1.6e7 probes: the plan's own route is 1 level for both kernels,
    # held to a numpy oracle, u64-max keys on both sides
    rng = np.random.default_rng(8)
    bk = rng.integers(0, 2**64, 4_000_000, dtype=np.uint64)
    bk[3] = M64
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 8_000_000),
                         rng.integers(0, 2**64, 8_000_000, dtype=np.uint64)])
    pk[::1000] = M64
    cfg = JoinConfig()
    case = WalkCase("large", bk, bv, pk, cfg, cfg.group_bits(bk.size),
                    use_bloom)
    table, static = _walk_table(case, dev)
    ph, pl = device_planes(pk, dev)
    props = torch.cuda.get_device_properties(dev)
    for mat in (False, True):
        p = hw.plan(pk.size, static["gbits"], static["total_groups"],
                    static["group_size"], use_bloom, mat,
                    l2_bytes=props.L2_cache_size,
                    sms=props.multi_processor_count)
        assert p.pbits > 0, p
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    want = uniq[pos] == pk
    count = hw.global_walk_count(table, ph, pl, pk.size, **static)
    hit, vh, vl = hw.global_walk_materialize(table, ph, pl, pk.size,
                                             **static)
    assert int(count) == int(want.sum())
    assert np.array_equal(hit.cpu().numpy(), want)
    vals = bv[first[pos[want]]]
    got = to_numpy_u64(vh[hit], vl[hit], int(want.sum()))
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("fn", ["hash_join_count", "hash_join_count_bloom",
                                "hash_join", "hash_join_bloom"])
def test_hash_join_launches_the_walk_on_card(dev, fn):
    rng = np.random.default_rng(6)
    bk = rng.integers(0, 2**64, 300_000, dtype=np.uint64)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 600_000),
                         rng.integers(0, 2**64, 600_000, dtype=np.uint64)])
    ht.walk_stats.reset()
    count, _, info = getattr(ft, fn)(bk, bv, pk, return_info=True)
    assert count == int(np.isin(pk, bk).sum())
    assert info["strategy"] == "global" and not info["retried"]
    kernel = "global_walk_count" if "count" in fn \
        else "global_walk_materialize"
    assert info["launches"][kernel] == 1
    # 3e5 build keys: the walked planes fit in half of L2, 0 levels, so the
    # bloom is tested in the walk and nothing is pruned
    assert info["launches"]["global_prune"] == 0
    stats = ht.walk_stats.read()
    assert stats["chunks"] == 1 and stats["probes"] == pk.size
    assert 1 <= stats["longest"] <= 256 and stats["groups"] > 0
    misses = int((~np.isin(pk, bk)).sum())
    if "bloom" in fn:     # every hit passes; ~1 % of the misses do
        assert count <= stats["bloom_passed"] < count + misses // 10
    else:
        assert stats["bloom_passed"] == 0


# ---- the global tier's build kernel -------------------------------------------

def _build_on_card(bk, bv, n_valid, kw, dev, offsets=(0, 0)):
    """The build kernel's table and the plain build's on the same card
    planes (the key and value planes at word offsets `offsets`), checked
    equal plane by plane; returns the kernel's table."""
    planes = [*offset_plane_views(bk, dev, *offsets),
              *offset_plane_views(bv, dev, *offsets)]
    before = ft.launch_counts()["global_build"]
    got = ht.build_table(*planes, n_valid, **kw)
    assert ft.launch_counts()["global_build"] - before == int(
        min(n_valid, bk.size) > 0)
    want = ht.build_table_plain(*planes, n_valid, **kw)
    torch.cuda.synchronize()
    for f in ("keys", "vals", "bloom", "special"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.device == w.device == planes[0].device, f
        assert g.dtype == w.dtype and torch.equal(g, w), f
    return got


@pytest.mark.parametrize("case", global_build_cases(), ids=lambda c: c.name)
def test_global_build_kernel_matches_plain(dev, case):
    # keys, vals, bloom and special equal the plain build's (the JAX
    # package's table) on every edge case of the build
    _build_on_card(case.build_keys, case.build_values, case.valid_rows(),
                   case.build_kwargs(), dev)


@pytest.mark.parametrize("name", ["random", "one_large_group_bloom",
                                  "n_valid_cut_bloom"])
def test_global_build_kernel_on_misaligned_planes(dev, name):
    case = next(c for c in global_build_cases() if c.name == name)
    _build_on_card(case.build_keys, case.build_values, case.valid_rows(),
                   case.build_kwargs(), dev, offsets=(1, 3))


@pytest.mark.parametrize("kind", ["all_equal_1e6", "homed_1e5"])
def test_global_build_kernel_on_one_huge_group(dev, kind):
    # a group far past the kernel's shared-memory chunk: 1e6 equal keys
    # (one kept row, the minimum), or 1e5 distinct keys homed to one of 16
    # groups of 32 slots with ~4000 overflow groups, whose chain runs past
    # max_probe_iters (256 groups) and is counted as dropped
    rng = np.random.default_rng(17)
    if kind == "all_equal_1e6":
        bk = np.full(1_000_000, 987654321, np.uint64)
        kw = dict(gbits=17, group_size=8, overflow_groups=64,
                  with_bloom=True, max_probe_iters=256)
    else:
        bk = rng.permutation(homed_keys(rng, 100_000, 4, 0, {9}))
        kw = dict(gbits=4, group_size=32, overflow_groups=4_000,
                  with_bloom=True, max_probe_iters=256)
    bv = np.arange(bk.size, dtype=np.uint64)
    table = _build_on_card(bk, bv, bk.size, kw, dev)
    drops = int(table.special[3])
    if kind == "homed_1e5":
        # slots 9 * 32 + j: rows j >= 256 * 32 lie 256 groups past home
        assert drops == 100_000 - 256 * 32
    else:
        assert drops == 0
        assert int((table.keys != -1).any(1).sum()) == 1


def test_global_build_kernel_does_not_sync(dev):
    case = next(c for c in global_build_cases() if c.name == "duplicates_bloom")
    planes = [*device_planes(case.build_keys, dev),
              *device_planes(case.build_values, dev)]
    kw = case.build_kwargs()
    ht.build_table(*planes, case.valid_rows(), **kw)     # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        table = ht.build_table(*planes, case.valid_rows(), **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ht.build_table_plain(*planes, case.valid_rows(), **kw)
    assert all(torch.equal(getattr(table, f), getattr(want, f))
               for f in ("keys", "vals", "bloom", "special"))


def test_global_build_kernel_refuses_bad_inputs(dev):
    kh, kl, vh, vl = (torch.zeros(64, dtype=torch.int32, device=dev)
                      for _ in range(4))
    kw = dict(gbits=4, group_size=8, overflow_groups=64, with_bloom=False)
    with pytest.raises(ValueError, match="group_size"):
        hb.global_build_table(kh, kl, vh, vl, 64, **dict(kw, group_size=3))
    with pytest.raises(ValueError, match="int32"):
        hb.global_build_table(kh.long(), kl, vh, vl, 64, **kw)
    with pytest.raises(ValueError, match="gbits"):
        hb.global_build_table(kh, kl, vh, vl, 64, **dict(kw, gbits=31))
    with pytest.raises(ValueError, match="contiguous"):
        hb.global_build_table(kh[::2], kl[::2], vh[::2], vl[::2], 32, **kw)


@pytest.mark.parametrize("fn", ["hash_join_count", "hash_join_count_bloom",
                                "hash_join", "hash_join_bloom"])
def test_hash_join_launches_the_build_on_every_call(dev, fn):
    rng = np.random.default_rng(8)
    bk = rng.integers(0, 2**64, 200_000, dtype=np.uint64)
    bk[50:80] = bk[3]
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 300_000),
                         rng.integers(0, 2**64, 300_000, dtype=np.uint64)])
    for _ in range(2):
        count, _, info = getattr(ft, fn)(bk, bv, pk, return_info=True)
        assert count == int(np.isin(pk, bk).sum())
        assert info["strategy"] == "global" and not info["retried"]
        assert info["launches"]["global_build"] == 1


@pytest.mark.parametrize("use_bloom", [False, True])
def test_local_join_builds_equal_the_plain_build(dev, use_bloom):
    # a distributed rank's table (pre_shift 2: rank 1's keys share the top
    # two hash bits) through _LocalJoin, against the plain build
    from flash_hash_join_tpu_torch.parallel.distributed_join import _LocalJoin
    from flash_hash_join_tpu_torch.utils.config import JoinConfig
    rng = np.random.default_rng(9)
    bk = homed_keys(rng, 50_000, 2, 0, {1})
    bk = rng.permutation(np.concatenate([bk, bk[:5_000]]))
    bv = np.arange(bk.size, dtype=np.uint64)
    cols = (*device_planes(bk, dev), *device_planes(bv, dev))
    cfg = JoinConfig()
    before = ft.launch_counts()["global_build"]
    rank = _LocalJoin(cols, cfg, use_bloom, 2, False)
    assert ft.launch_counts()["global_build"] - before == 1
    want = ht.build_table_plain(
        *cols, bk.size, gbits=cfg.group_bits(bk.size),
        group_size=cfg.group_size, overflow_groups=cfg.overflow_groups,
        with_bloom=use_bloom, bloom_k=cfg.bloom_k, pre_shift=2,
        max_probe_iters=cfg.max_probe_iters)
    assert all(torch.equal(getattr(rank.table, f), getattr(want, f))
               for f in ("keys", "vals", "bloom", "special"))
    rank.read_drops()
    assert rank.drops == 0


def test_stream_compaction_on_card(dev, monkeypatch):
    rng = np.random.default_rng(2)
    n = 3_000_001
    mask = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    cols = [to_device(rng.integers(0, 2**32, n, dtype=np.uint32), dev)
            for _ in range(4)]
    pack = cp.compact_by_mask(mask, cols)
    monkeypatch.setenv("FHJ_COMPACT", "stream")
    before = ft.launch_counts()["concat_ragged_blocks"]
    stream = cp.compact_by_mask(mask, cols)
    torch.cuda.synchronize()
    assert ft.launch_counts()["concat_ragged_blocks"] == before + 1
    count = int(pack[0])
    # the count is K6's total, left on the card
    assert stream[0].device.type == "cuda"
    assert int(stream[0]) == count == int(mask.sum())
    for s, p in zip(stream[1], pack[1]):
        assert torch.equal(s[:count], p[:count])


@pytest.fixture
def planned(monkeypatch):
    """force(k): the planner plans k probe chunks for every shape."""
    from flash_hash_join_tpu_torch import api
    from flash_hash_join_tpu_torch.models.cost import JoinPlan

    def force(k):
        monkeypatch.setattr(api, "choose_plan", lambda nb, npr, cfg, mode,
                            budget: JoinPlan("partitioned",
                                             cfg.group_bits(nb), k))
    return force


@pytest.mark.parametrize("chunks", [2, 7])
@pytest.mark.parametrize("overlap", ["1", "0"])
def test_chunk_stream_on_card_equals_single_shot(dev, planned, monkeypatch,
                                                 chunks, overlap):
    # the pinned staging buffers, the copy stream and the depth-2 pipeline
    # (overlap "1"), or one chunk after another ("0")
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    c = uniform_case(200_003, 3_000_007, 0.3, seed=chunks)
    args = (c.build_keys, c.build_values, c.probe_keys)
    want = ft.join_count(*args)[0]
    _, _, want_keys, want_vals = ft.join_materialize(*args,
                                                     return_arrays=True)
    assert want == int((c.probe_keys < 2**62).sum())
    monkeypatch.setenv("FHJ_CHUNK_OVERLAP", overlap)
    planned(chunks)
    count, core, info = ft.join_count(*args, return_info=True)
    assert count == want and core > 0
    assert info["probe_chunks"] == chunks and not info["retried"]
    assert info["launches"]["range_probe_count"] == chunks
    count, _, keys, vals, info = ft.join_materialize(
        *args, return_arrays=True, return_info=True)
    assert count == want and info["probe_chunks"] == chunks
    assert info["strategy"] == "partitioned" and not info["retried"]
    np.testing.assert_array_equal(keys, want_keys)    # chunk order = probe
    np.testing.assert_array_equal(vals, want_vals)


@pytest.mark.parametrize("planned_chunks", [1, 2])
def test_chunk_stream_doubles_on_a_real_out_of_memory(dev, planned,
                                                      monkeypatch,
                                                      planned_chunks):
    # a chunk past 500_000 rows asks the allocator for 4 TB, which raises
    # a real torch.cuda.OutOfMemoryError: the single shot falls back to 2
    # chunks, the stream doubles to 4
    from flash_hash_join_tpu_torch import api
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    real = api._graph

    def greedy(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            if args[4].numel() > 500_000:
                torch.empty(1 << 42, dtype=torch.uint8, device=args[4].device)
            return fn(*args)
        return run

    monkeypatch.setattr(api, "_graph", greedy)
    planned(planned_chunks)
    c = uniform_case(100_003, 1_500_001, 0.3, seed=5)
    args = (c.build_keys, c.build_values, c.probe_keys)
    want = int((c.probe_keys < 2**62).sum())
    count, _, info = ft.join_count(*args, return_info=True)
    assert count == want and info["probe_chunks"] == 4
    count, _, keys, _, info = ft.join_materialize(*args, return_arrays=True,
                                                  return_info=True)
    assert count == want and info["probe_chunks"] == 4
    np.testing.assert_array_equal(keys, c.probe_keys[c.probe_keys < 2**62])


def test_chunk_stream_reuses_its_device_blocks_across_calls(dev, planned):
    # one copy stream a card: the caching allocator keeps a pool a stream,
    # so a stream a call would strand each call's chunk planes
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    c = uniform_case(100_003, 4_000_001, 0.3, seed=9)
    args = (c.build_keys, c.build_values, c.probe_keys)
    planned(4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    want = ft.join_count(*args)[0]
    reserved = torch.cuda.memory_reserved()
    for _ in range(3):
        assert ft.join_count(*args)[0] == want
    assert torch.cuda.memory_reserved() <= reserved


# ---- the distributed tier ----------------------------------------------------

def _ranks_on(kind: str):
    """The ranks' devices: 2 or 4 ranks on cuda:0, or one rank on each of
    two cards (skipped on a one-card machine)."""
    if kind == "two-cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two cards")
        return ["cuda:0", "cuda:1"]
    return ["cuda:0"] * int(kind[0])


@pytest.mark.parametrize("ranks", ["2-on-one", "4-on-one", "two-cards"])
@pytest.mark.parametrize("materialize", [False, True])
def test_distributed_join_on_cards_equals_cpu(dev, ranks, materialize):
    # Zipf probes over duplicate build keys, with misses: the hot-key tier,
    # both exchanges, the local tables and K5 on the card; the same ranks
    # on the CPU give the same count and the same rows in the same order
    from flash_hash_join_tpu_torch.models.workload import zipf_probe_case
    devices = _ranks_on(ranks)
    c = zipf_probe_case(200_000, 1_500_000, a=1.2, seed=3)
    bk = np.concatenate([c.build_keys, c.build_keys[::5]])
    bv = np.random.default_rng(4).integers(0, 2**64, bk.size,
                                           dtype=np.uint64)
    pk = c.probe_keys.copy()
    pk[::3] ^= np.uint64(2**63)                         # misses
    fn = (functools.partial(ft.distributed_join_materialize,
                            return_arrays=True) if materialize
          else ft.distributed_join_count)
    want = fn(bk, bv, pk, devices=["cpu"] * len(devices), return_info=True)
    got = fn(bk, bv, pk, devices=devices, return_info=True)
    assert got[0] == want[0] == int(np.isin(pk, bk).sum())
    info = got[-1]
    assert info["devices"] == [str(torch.device(d)) for d in devices]
    assert info["hot_keys"] > 0 and info["drops"] == info["reruns"] == 0
    assert info["rank_counts"] == want[-1]["rank_counts"]
    if materialize:
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        assert info["launches"]["compact"] > 0
    walk = "global_walk_materialize" if materialize else "global_walk_count"
    assert info["launches"][walk] >= len(devices)     # a rank a walk, or more
    assert want[-1]["launches"][walk] == 0            # the CPU: the plain walk


def test_distributed_build_drop_reruns_on_card(dev):
    from flash_hash_join_tpu_torch.parallel.distributed_join import (
        distributed_join_exact)
    from flash_hash_join_tpu_torch.parallel.mesh import data_mesh
    from flash_hash_join_tpu_torch.utils.config import JoinConfig
    rng = np.random.default_rng(30)
    bk = rng.integers(0, 2**64, 200_000, dtype=np.uint64)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 300_000),
                         rng.integers(0, 2**64, 100_000, dtype=np.uint64)])
    cfg = JoinConfig(max_probe_iters=1, group_size=2)
    for devices in (["cpu"] * 4, ["cuda:0"] * 4):
        res = distributed_join_exact(data_mesh(devices=devices), bk, bv, pk,
                                     cfg=cfg, materialize=True)
        assert res.count == int(np.isin(pk, bk).sum())
        assert res.info["reruns"] > 0
        if devices[0] == "cpu":
            want = res
    np.testing.assert_array_equal(res.keys, want.keys)
    np.testing.assert_array_equal(res.values, want.values)


def test_distributed_mesh_of_cards(dev):
    from flash_hash_join_tpu_torch.parallel.mesh import data_mesh
    n = torch.cuda.device_count()
    mesh = data_mesh()
    assert mesh.size == 1 << (n.bit_length() - 1)
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(mesh.size))
    with pytest.raises(ValueError, match="distinct cards"):
        data_mesh(2 * mesh.size)


def test_distributed_process_group_over_nccl(dev):
    # one rank a card: world = the largest power of two <= min(4, cards)
    from flash_hash_join_tpu_torch.parallel.dryrun import dryrun_multichip
    n = min(4, torch.cuda.device_count())
    world = 1 << (n.bit_length() - 1)
    assert dryrun_multichip(world, n_processes=world,
                            device="cuda") == world * 1024


# ---- the harness twins on the card -----------------------------------------

def test_benchmark_twin_on_card(dev, capsys):
    from flash_hash_join_tpu_torch.harness import benchmark as hb
    with pytest.raises(SystemExit) as exit_:
        hb.main(["--gen", "1e5", "--device", "cuda", "--no-charts",
                 "--device-time"])
    out = capsys.readouterr().out
    assert exit_.value.code == 0, out
    assert "PARITY FAILURE" not in out and "MISMATCH" not in out
    assert out.count("oracle=native") == 4 and "oracle=numpy" not in out
    assert out.count("RESULT,Library=") == 4 * 6 * 2
    assert out.count(",Device=") == 4 * 6 * 2


def test_fuzzer_twin_on_card(dev):
    from flash_hash_join_tpu_torch.harness import fuzz_join as hf
    res = hf.run_fuzz(20, 0, fixed_shapes=True, device="cuda")
    assert res["fails"] == 0, res
    res = hf.run_fuzz(6, 20, fixed_shapes=True, chunked=True, device="cuda")
    assert res["fails"] == 0 and res["streamed"] > 0, res
