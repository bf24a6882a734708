"""The `global` tier's bloom prune on the CPU: its plain version
(ops/hash_table.prune_plain, the twin of csrc/hash_walk.cu's prune_kernel)
and the count with bloom that prunes before it walks
(hash_join_count_bloom, ops/hash_table.probe_count), against the numpy
oracle's count and a per-probe numpy bloom test written out here.

Shapes: a selective join at 5 % match (2^14 build and 2^20 probe rows,
misses below 2^62 that the build side lacks), 0 % and 100 % match, u64-max
keys on both sides among the pruned rows, rows at or past np_valid, a
rank's table (pre_shift 2).  Exact: counts, survivors and stats[2].
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch.ops import hash_table as ht
from flash_hash_join_tpu_torch.utils.config import JoinConfig
from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
from tests.oracle import oracle_count

M32 = np.uint64(0xFFFFFFFF)
M64 = np.uint64(2**64 - 1)
NB, NP = 1 << 14, 1 << 20


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & M32
    return h ^ (h >> np.uint64(16))


def np_bloom_passes(table, keys: np.ndarray, *, gbits: int, bloom_k: int,
                    pre_shift: int = 0) -> np.ndarray:
    """Per probe key: not the u64-max key, and its tag (bloom_word of its
    hash) inside its home group's bloom word."""
    hi, lo = keys >> np.uint64(32), keys & M32
    h = _fmix32(_fmix32(lo) ^ ((hi * np.uint64(0x9E3779B9)) & M32))
    g = (h * np.uint64(0x9E3779B9) + np.uint64(1)) & M32
    tag = np.zeros_like(h)
    for i in range(bloom_k):
        s = 5 * i
        tag |= np.uint64(1) << (((g >> np.uint64(s)) & np.uint64(31))
                                if s < 32 else np.uint64(0))
    home = ((h << np.uint64(pre_shift)) & M32) >> np.uint64(32 - gbits)
    words = table.bloom.numpy().astype(np.uint64)[home.astype(np.int64)]
    return (keys != M64) & ((words & tag) == tag)


def selective(match: float, seed: int = 0, nb: int = NB, npr: int = NP):
    """Build keys uniform below 2^62; a `match` share of the probe rows
    drawn from them, the rest below 2^62 and absent from the build side."""
    rng = np.random.default_rng(seed)
    bk = np.unique(rng.integers(0, 2**62, nb, dtype=np.uint64))
    bv = rng.integers(0, 2**63, bk.size, dtype=np.uint64)
    hits = round(npr * match)
    pk = rng.integers(0, 2**62, npr, dtype=np.uint64)
    absent = np.isin(pk, bk)
    while absent.any():
        pk[absent] = rng.integers(0, 2**62, int(absent.sum()),
                                  dtype=np.uint64)
        absent = np.isin(pk, bk)
    at = rng.permutation(npr)[:hits]
    pk[at] = rng.choice(bk, hits)
    return bk, bv, pk


def _table(bk, bv, *, pre_shift: int = 0, cfg: JoinConfig = JoinConfig()):
    gbits = cfg.group_bits(bk.size)
    table = ht.build_table(*device_planes(bk, "cpu"), *device_planes(bv, "cpu"),
                           bk.size, gbits=gbits, group_size=cfg.group_size,
                           overflow_groups=cfg.overflow_groups,
                           with_bloom=True, bloom_k=cfg.bloom_k,
                           pre_shift=pre_shift,
                           max_probe_iters=cfg.max_probe_iters)
    static = dict(gbits=gbits, group_size=cfg.group_size,
                  total_groups=(1 << gbits) + cfg.overflow_groups,
                  use_bloom=True, bloom_k=cfg.bloom_k,
                  max_iters=cfg.max_probe_iters, pre_shift=pre_shift)
    return table, static


@pytest.mark.parametrize("match", [0.05, 0.0, 1.0])
def test_count_bloom_matches_oracle_and_numpy_bloom(match):
    bk, bv, pk = selective(match)
    ht.walk_stats.reset()
    count, _, info = ft.hash_join_count_bloom(bk, bv, pk, device="cpu",
                                              return_info=True)
    stats = ht.walk_stats.read()
    assert count == oracle_count(bk, pk) == round(NP * match)
    assert info["strategy"] == "global" and info["use_bloom"]
    assert not any(info["launches"].values())        # the CPU: plain twins
    table, static = _table(bk, bv)
    passes = np_bloom_passes(table, pk, gbits=static["gbits"],
                             bloom_k=static["bloom_k"])
    assert stats["bloom_passed"] == int(passes.sum())
    # every hit passes; at ~2 keys a group about 1 % of the misses do
    assert count <= stats["bloom_passed"] <= count + (NP - count) // 20
    assert stats["probes"] == NP and stats["chunks"] == 1


@pytest.mark.parametrize("match", [0.05, 0.0, 1.0])
def test_prune_plain_keeps_exactly_the_bloom_passes(match):
    bk, bv, pk = selective(match, seed=1, npr=1 << 16)
    table, static = _table(bk, bv)
    ph, pl = device_planes(pk, "cpu")
    sh, sl, max_hits = ht.prune_plain(table, ph, pl, pk.size, **static)
    want = np_bloom_passes(table, pk, gbits=static["gbits"],
                           bloom_k=static["bloom_k"])
    assert torch.equal(sortable(sh, sl), sortable(*device_planes(pk[want],
                                                                 "cpu")))
    assert int(max_hits) == 0
    # no key in the build side is pruned
    assert np.isin(pk[np.isin(pk, bk)], pk[want]).all()


@pytest.mark.parametrize("in_build", [True, False])
def test_u64_max_probes_among_the_pruned_rows(in_build):
    bk, bv, pk = selective(0.05, seed=2, npr=1 << 16)
    if in_build:
        bk, bv = np.append(bk, M64), np.append(bv, np.uint64(7))
    pk[::97] = M64
    table, static = _table(bk, bv)
    ph, pl = device_planes(pk, "cpu")
    sh, sl, max_hits = ht.prune_plain(table, ph, pl, pk.size, **static)
    n_max = int((pk == M64).sum())
    # a u64-max row never survives: it is answered from special
    assert int(max_hits) == (n_max if in_build else 0)
    assert not ((sh == -1) & (sl == -1)).any()
    ht.walk_stats.reset()
    count = ht.probe_count(table, ph, pl, pk.size, probe_chunk=1 << 14,
                           **static)
    assert int(count) == oracle_count(bk, pk)
    passes = np_bloom_passes(table, pk, gbits=static["gbits"],
                             bloom_k=static["bloom_k"])
    assert ht.walk_stats.read()["bloom_passed"] == int(passes.sum())
    c, _, info = ft.hash_join_count_bloom(bk, bv, pk, device="cpu",
                                          return_info=True)
    assert c == oracle_count(bk, pk) and not info["retried"]


@pytest.mark.parametrize("n_valid", [0, 1, 40_000, 65_535])
def test_rows_at_or_past_n_valid_are_never_counted(n_valid):
    bk, bv, pk = selective(0.5, seed=3, npr=1 << 16)
    pk[n_valid::5] = bk[0]          # hits past n_valid: must not count
    table, static = _table(bk, bv)
    ph, pl = device_planes(pk, "cpu")
    sh, _, _ = ht.prune_plain(table, ph, pl, n_valid, **static)
    assert sh.numel() == int(np_bloom_passes(
        table, pk[:n_valid], gbits=static["gbits"],
        bloom_k=static["bloom_k"]).sum())
    ht.walk_stats.reset()
    count = ht.probe_count(table, ph, pl, n_valid, probe_chunk=1 << 13,
                           **static)
    assert int(count) == oracle_count(bk, pk[:n_valid])
    stats = ht.walk_stats.read()
    assert stats["bloom_passed"] == sh.numel() and stats["chunks"] == 8


def test_a_ranks_table_prunes_with_its_pre_shift():
    # pre_shift 2, as a distributed rank builds: the home group, and so the
    # bloom word a row is tested against, comes after the top 2 hash bits
    bk, bv, pk = selective(0.05, seed=4, npr=1 << 16)
    table, static = _table(bk, bv, pre_shift=2)
    ph, pl = device_planes(pk, "cpu")
    sh, _, _ = ht.prune_plain(table, ph, pl, pk.size, **static)
    want = np_bloom_passes(table, pk, gbits=static["gbits"],
                           bloom_k=static["bloom_k"], pre_shift=2)
    assert sh.numel() == int(want.sum())
    assert sh.numel() != int(np_bloom_passes(
        table, pk, gbits=static["gbits"], bloom_k=static["bloom_k"]).sum())
    count = ht.probe_count(table, ph, pl, pk.size, probe_chunk=1 << 14,
                           **static)
    assert int(count) == oracle_count(bk, pk)


def test_materialize_with_bloom_still_tests_in_the_walk():
    # the prune is the count's: a materialize with bloom keeps the bloom
    # test inside the walk, and counts its passes alike
    bk, bv, pk = selective(0.05, seed=5, npr=1 << 16)
    table, static = _table(bk, bv)
    ph, pl = device_planes(pk, "cpu")
    ht.walk_stats.reset()
    hit, _, _ = ht.probe_rows(table, ph, pl, pk.size, probe_chunk=1 << 14,
                              **static)
    assert int(hit.sum()) == oracle_count(bk, pk)
    passes = np_bloom_passes(table, pk, gbits=static["gbits"],
                             bloom_k=static["bloom_k"])
    assert ht.walk_stats.read()["bloom_passed"] == int(passes.sum())


def test_prune_wrapper_refuses_cpu_tensors():
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    bk, bv, pk = selective(0.05, seed=6, nb=64, npr=128)
    table, static = _table(bk, bv)
    ph, pl = device_planes(pk, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        hw.global_prune(table, ph, pl, pk.size, **static)
