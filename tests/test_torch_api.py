"""The port end to end: flash_hash_join_tpu_torch's public API, count and
materialize, against the JAX package's and the numpy oracle, on the CPU.

Inputs come from the same numpy generators with a fixed seed; the port
runs with device="cpu", which takes the kernels' plain PyTorch versions.
Tolerance: exact equality.  Counts and the sorted (key, value) rows are
compared with the JAX package where build keys are unique; with duplicate
build keys the port's rows are compared with the numpy oracle's
minimum-build-row winner, and the JAX package's values only for
membership in the key's run (its partitioned winner differs by design).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu import api as japi
from flash_hash_join_tpu.models import cost as jcost
from flash_hash_join_tpu.models import workload as jwl
from flash_hash_join_tpu.utils import config as jcfg
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch import api as tapi
from flash_hash_join_tpu_torch import engine as teng
from flash_hash_join_tpu_torch.models import cost as tcost
from flash_hash_join_tpu_torch.models import workload as twl
from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb
from flash_hash_join_tpu_torch.utils import config as tcfg
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.oracle import oracle_count
from tests.torch_gates import open_gates

REPO = Path(__file__).resolve().parents[1]


def _port(bk, bv, pk, **kw):
    return ft.adaptive_join_count(bk, bv, pk, device="cpu", return_info=True,
                                  **kw)


@pytest.mark.parametrize("q", ["Q1", "Q2", "Q5"])
def test_j1_suite_matches_jax_and_oracle(q, monkeypatch):
    open_gates(monkeypatch)
    case = {c.name[-2:]: c for c in twl.j1_suite(100_000, seed=3)}[q]
    want = oracle_count(case.build_keys, case.probe_keys)
    count, secs, info = _port(case.build_keys, case.build_values,
                              case.probe_keys)
    jcount, _ = fj.adaptive_join_count(case.build_keys, case.build_values,
                                       case.probe_keys)
    assert count == jcount == want
    assert secs > 0.0
    assert info["strategy"] == "direct" and not info["retried"]
    assert info["d_rows"] == tdb.d_rows_for(
        int(case.build_keys.max() - case.build_keys.min()) + 1)


def test_sparse_64bit_routes_merge_in_port_partitioned_in_jax():
    # both packages now route sparse 64-bit keys to the partitioned tier
    case = twl.uniform_case(3_000, 9_000, 0.3, seed=5)
    want = oracle_count(case.build_keys, case.probe_keys)
    count, _, info = _port(case.build_keys, case.build_values,
                           case.probe_keys)
    jcount, _, jinfo = japi._run_join(
        case.build_keys, case.build_values, case.probe_keys, mode="count",
        strategy="adaptive", use_bloom=False, return_info=True)
    assert count == jcount == want
    assert info["strategy"] == jinfo["strategy"] == "partitioned"
    assert not info["retried"]


def test_dense_span_above_2_20_runs_the_large_band(monkeypatch):
    open_gates(monkeypatch)
    rng = np.random.default_rng(8)
    bk = rng.integers(1_000, 1_000 + 3_000_000, 40_000, dtype=np.uint64)
    pk = rng.integers(0, 3_500_000, 60_000, dtype=np.uint64)
    count, _, info = _port(bk, bk, pk)
    assert count == oracle_count(bk, pk)
    assert info["strategy"] == "direct" and info["d_rows"] > 256
    assert not info["retried"]
    # CPU tensors take the plain versions: no kernel launches here
    assert set(info["launches"]) == {
        "dense_bitmap", "scan_domain_count", "range_probe_count",
        "range_probe_materialize", "range_directory", "compact",
        "probe_gather_bitmap",
        "probe_gather_staged", "materialize_copy", "probe_count_vmem",
        "probe_materialize_vmem", "concat_ragged_blocks", "global_walk_count",
        "global_walk_materialize", "global_build", "range_build",
        "global_prune"}
    assert set(info["launches"].values()) == {0}


def test_workload_generators_match_jax():
    for tc, jc in zip(twl.j1_suite(20_000, seed=4), jwl.j1_suite(20_000,
                                                                  seed=4)):
        assert tc.name == jc.name
        for f in ("build_keys", "build_values", "probe_keys"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    for tc, jc in ((twl.uniform_case(500, 900, 0.05, seed=2),
                    jwl.uniform_case(500, 900, 0.05, seed=2)),
                   (twl.zipf_probe_case(500, 900, seed=2),
                    jwl.zipf_probe_case(500, 900, seed=2))):
        for f in ("build_keys", "build_values", "probe_keys"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))


def test_split_u64_planes_match_jax():
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1], np.uint64),
        rng.integers(0, 2**64, 5_000, dtype=np.uint64)])
    for t, j in zip(tu64.split_u64(keys), ju64.split_u64(keys)):
        assert t.dtype == j.dtype == np.uint32
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        tu64.join_u64(*tu64.split_u64(keys)), ju64.join_u64(
            *ju64.split_u64(keys)))
    hi, lo = tu64.device_planes(keys, "cpu")
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(
        tu64.join_u64(tu64.to_numpy_u32(hi), tu64.to_numpy_u32(lo)), keys)


def test_config_and_cost_model_match_jax(monkeypatch):
    assert tcfg.JoinConfig() == tcfg.DEFAULT_CONFIG
    for f in ("group_size", "growth", "overflow_groups", "probe_chunk",
              "max_probe_iters", "bloom_k", "min_groups"):
        assert getattr(tcfg.DEFAULT_CONFIG, f) == getattr(
            jcfg.DEFAULT_CONFIG, f), f
    # the port's planner has the H100's constants; with the JAX package's
    # (v5e) ones it plans what the JAX package plans, but for the
    # materialize stream, whose depth-2 pipeline also holds the previous
    # chunk's output planes: 8 + 16 B a row where the JAX package budgets 8
    for name, value in (("BUILD_BYTES_COUNT", 32),
                        ("BUILD_BYTES_MATERIALIZE", 40),
                        ("TRANSIENT_BYTES_COUNT",
                         jcost.TRANSIENT_BYTES_COUNT),
                        ("TRANSIENT_BYTES_MATERIALIZE",
                         jcost.TRANSIENT_BYTES_MATERIALIZE)):
        monkeypatch.setattr(tcost, name, value)
    budget = 12 * 1024**3
    for nb, npr in ((1_000, 10_000), (40_000_000, 40_000_000),
                    (10_000_000, 1_000_000_000)):
        assert tcost.plan_probe_chunks(nb, npr, "count", budget) == \
            jcost.plan_probe_chunks(nb, npr, "count", budget)
        per_row = 8 + 16 + jcost.TRANSIENT_BYTES_MATERIALIZE
        avail = budget - 40 * nb          # JAX cost.py: 16 + 16 + 8 B a row

        def plan(pipelined):
            return (1 if avail // per_row >= npr
                    else -(-npr // max(avail // (per_row + pipelined), 1)))
        assert jcost.plan_probe_chunks(nb, npr, "materialize",
                                       budget) == plan(8)
        assert tcost.plan_probe_chunks(nb, npr, "materialize",
                                       budget) == plan(8 + 16)
        assert tcfg.DEFAULT_CONFIG.group_bits(nb) == \
            jcfg.DEFAULT_CONFIG.group_bits(nb)
    with pytest.raises(MemoryError):
        tcost.plan_probe_chunks(10**9, 10, "count", budget)
    assert tcost.hbm_budget_bytes("cpu") > 0


def test_chunked_plan_streams(monkeypatch):
    # a plan of more than one chunk streams; a dense count streams on the
    # direct strategy
    open_gates(monkeypatch)
    monkeypatch.setattr(tapi, "hbm_budget_bytes", lambda dev: 300_000)
    bk = np.arange(1_000, dtype=np.uint64)
    pk = np.arange(100_000, dtype=np.uint64)
    count, _, info = ft.adaptive_join_count(bk, bk, pk, device="cpu",
                                            return_info=True)
    assert count == 1_000 and info["probe_chunks"] > 1
    assert info["strategy"] == "direct" and not info["retried"]


def test_special_channel_reruns_on_merge(monkeypatch):
    # a direct run that reports dropped build rows must rerun on merge
    real = teng.count_graph

    def lossy(strategy, d_rows=0):
        fn = real(strategy, d_rows)
        if strategy != "direct":
            return fn

        def run(*args):
            count, special = fn(*args)
            return count - 1, special + torch.tensor([0, 0, 0, 1])
        return run

    monkeypatch.setattr(teng, "count_graph", lossy)
    rng = np.random.default_rng(2)
    bk = rng.integers(0, 5_000, 3_000, dtype=np.uint64)
    pk = rng.integers(0, 6_000, 8_000, dtype=np.uint64)
    count, _, info = _port(bk, bk, pk)
    assert count == oracle_count(bk, pk)
    assert info["retried"] and info["strategy"] == "merge"


@pytest.mark.parametrize("strategy", ["adaptive", "direct", "partitioned",
                                      "merge", "global", "vmem"])
def test_join_count_strategies(strategy):
    rng = np.random.default_rng(6)
    bk = rng.integers(7, 30_000, 9_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 9_000, dtype=np.uint64)
    pk = rng.integers(0, 33_000, 20_000, dtype=np.uint64)
    count, _, info = ft.join_count(bk, bv, pk, strategy=strategy,
                                   device="cpu", return_info=True)
    assert count == oracle_count(bk, pk)
    assert info["strategy"] == ("direct" if strategy == "adaptive"
                                else strategy)
    assert not info["retried"]


def test_join_count_rejects_what_it_cannot_run():
    rng = np.random.default_rng(1)
    bv = np.ones(100, np.uint64)
    pk = rng.integers(0, 100, 1_000).astype(np.uint64)
    wide = rng.integers(2**32, 2**40, 100).astype(np.uint64)
    with pytest.raises(ValueError):
        ft.join_count(wide, bv, pk, strategy="direct", device="cpu")
    sparse = rng.integers(0, 2**31, 100).astype(np.uint64)  # span > XL cap
    with pytest.raises(ValueError):
        ft.join_count(sparse, bv, pk, strategy="direct", device="cpu")
    for tier in ("global", "vmem"):                   # ported: they run
        want = oracle_count(pk[:100], pk)
        assert ft.join_count(pk[:100], bv, pk, strategy=tier,
                             device="cpu")[0] == want
        assert ft.join_materialize(pk[:100], bv, pk, strategy=tier,
                                   device="cpu")[0] == want
    with pytest.raises(ValueError):
        ft.join_materialize(wide, bv, pk, strategy="direct", device="cpu")
    with pytest.raises(ValueError):
        ft.join_count(pk[:100], bv, pk, strategy="nope", device="cpu")


def test_verify_edge_cases():
    rng = np.random.default_rng(0)
    bk = rng.integers(0, 1_000_000, 20_000, dtype=np.uint64)
    pk = rng.integers(0, 1_000_000, 50_000, dtype=np.uint64)
    with pytest.raises(ValueError):                      # mismatched lengths
        ft.adaptive_join_count(bk, bk[:-1], pk, device="cpu")
    empty = np.zeros(0, np.uint64)
    assert ft.adaptive_join_count(empty, empty, pk, device="cpu") == (0, 0.0)
    assert ft.adaptive_join_count(bk, bk, empty, device="cpu") == (0, 0.0)
    m = np.uint64(2**64 - 1)                             # EMPTY-sentinel key
    bkm = np.array([m, 5, m], np.uint64)
    pkm = np.array([m, 4, 5, m, 0], np.uint64)
    assert ft.adaptive_join_count(bkm, bkm, pkm, device="cpu")[0] == 3
    same = np.full(1_000, 42, np.uint64)                 # all-equal build keys
    assert ft.adaptive_join_count(same, same, pk[:999].tolist() + [42],
                                  device="cpu")[0] == oracle_count(
                                      same, np.append(pk[:999], 42))
    as_list = ft.adaptive_join_count(bk[:50].tolist(), list(range(50)),
                                     pk.astype(np.int32), device="cpu")[0]
    assert as_list == oracle_count(bk[:50], pk)
    count, secs = ft.adaptive_join_count_bloom(bk, bk, pk, device="cpu")
    assert count == oracle_count(bk, pk) and secs > 0.0


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' runs the kernels")
    bk = np.arange(10, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="cuda"):
        ft.adaptive_join_count(bk, bk, bk)
    with pytest.raises(RuntimeError, match="cuda"):
        ft.initialize()
    with pytest.raises(RuntimeError, match="cuda"):
        ft.adaptive_join(bk, bk, bk)
    assert ft.initialize(device="cpu") is True
    assert ft.plan_strategy(1_000, 10_000, device="cpu") == "partitioned"


def test_import_leaves_jax_out():
    """Every module of the port (walked with pkgutil: parallel/, harness/,
    utils/native included) and chip_smoke.py import neither jax nor the
    JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import flash_hash_join_tpu_torch as ft\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    ft.__path__, 'flash_hash_join_tpu_torch.')]\n"
            "for name in names + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'flash_hash_join_tpu' or\n"
            "               m.startswith('flash_hash_join_tpu.')\n"
            "               for m in sys.modules), 'JAX package imported'\n"
            "print(' '.join(sorted(names)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert {"flash_hash_join_tpu_torch.parallel.worker",
            "flash_hash_join_tpu_torch.harness.benchmark",
            "flash_hash_join_tpu_torch.harness.fuzz_join",
            "flash_hash_join_tpu_torch.harness.crossover",
            "flash_hash_join_tpu_torch.harness.gate_drift",
            "flash_hash_join_tpu_torch.utils.native",
            "flash_hash_join_tpu_torch.ops.cuda._build"} <= names


# ---- partitioned tier and materialize ---------------------------------------

def _unique_case():
    """64-bit keys, unique build keys (values then compare exactly), the
    u64-max key on both sides."""
    case = twl.uniform_case(3_000, 9_000, 0.4, seed=11)
    bk = np.unique(case.build_keys)
    bk[-1] = np.uint64(2**64 - 1)
    pk = case.probe_keys.copy()
    pk[:3] = np.uint64(2**64 - 1)
    return bk, case.build_values[:bk.size], pk


def _min_row_rows(bk, bv, pk):
    """numpy oracle rows in probe order, minimum-build-row winner."""
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    return pk[hit], bv[first[pos[hit]]]


def _sorted(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


@pytest.mark.parametrize("name", [
    "hash_join_count_radix", "hash_join_count_radix_bloom",
    "hash_join_radix", "hash_join_radix_bloom", "adaptive_join",
    "adaptive_join_bloom", "adaptive_join_count", "adaptive_join_count_bloom",
    "hash_join", "hash_join_bloom", "hash_join_count", "hash_join_count_bloom",
])
def test_reference_functions_match_jax(name):
    # the 12 join functions of the reference module (the 13th is
    # initialize); hash_join* run the global tier, bloom on for _bloom
    bk, bv, pk = _unique_case()
    count, secs, info = getattr(ft, name)(bk, bv, pk, device="cpu",
                                          return_info=True)
    jcount, _ = getattr(fj, name)(bk, bv, pk)
    assert count == jcount == oracle_count(bk, pk)
    tier = name.startswith("hash_join") and "radix" not in name
    assert info["strategy"] == ("global" if tier else "partitioned")
    assert info["use_bloom"] == (tier and name.endswith("_bloom"))
    assert not info["retried"] and secs > 0.0


def test_reference_function_names_match_jax():
    names = [n for n in dir(fj) if n.startswith(("adaptive_join", "hash_join"))]
    assert len(names) == 12 and all(callable(getattr(ft, n)) for n in names)
    assert ft.initialize(device="cpu") is True


@pytest.mark.parametrize("strategy,use_bloom", [
    ("global", False), ("global", True), ("vmem", False), ("vmem", True)])
def test_explicit_tiers_match_jax(strategy, use_bloom):
    # unique build keys and the u64-max key on both sides: both packages
    # emit probe order, so the rows equal the JAX package's as they are
    bk, bv, pk = _unique_case()
    kw = dict(strategy=strategy, use_bloom=use_bloom)
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   return_info=True, **kw)
    jcount, _ = fj.join_count(bk, bv, pk, **kw)
    assert count == jcount == oracle_count(bk, pk)
    assert info["strategy"] == strategy and not info["retried"]
    mcount, _, keys, vals, minfo = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True, **kw)
    jmcount, _, jkeys, jvals = fj.join_materialize(bk, bv, pk,
                                                   return_arrays=True, **kw)
    assert mcount == jmcount == count and minfo["strategy"] == strategy
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(vals, jvals)
    for g, w in zip((keys, vals), _min_row_rows(bk, bv, pk)):
        np.testing.assert_array_equal(g, w)


def test_explicit_tiers_duplicate_keys_take_the_minimum_row():
    rng = np.random.default_rng(21)
    bk = rng.integers(0, 2**64, 300, dtype=np.uint64)[rng.integers(0, 300,
                                                                   2_000)]
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 3_000),
                         rng.integers(0, 2**64, 1_000, dtype=np.uint64)])
    want = _min_row_rows(bk, bv, pk)
    for strategy in ("global", "vmem"):
        count, _, keys, vals = ft.join_materialize(
            bk, bv, pk, strategy=strategy, device="cpu", return_arrays=True)
        jcount, _, jkeys, jvals = fj.join_materialize(
            bk, bv, pk, strategy=strategy, return_arrays=True)
        assert count == jcount == want[0].size
        for g, j, w in zip((keys, vals), (jkeys, jvals), want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("strategy", ["adaptive", "global", "vmem",
                                      "partitioned", "merge"])
@pytest.mark.parametrize("mode", ["count", "materialize"])
def test_bloom_is_distinct_matches_jax(strategy, mode):
    for nb, npr in ((1_000, 10_000), (10**7, 10**8)):
        assert ft.bloom_is_distinct(nb, npr, mode, strategy, device="cpu") \
            == japi.bloom_is_distinct(nb, npr, mode, strategy)


@pytest.mark.parametrize("strategy", ["adaptive", "partitioned", "merge"])
def test_join_materialize_arrays_match_jax(strategy):
    bk, bv, pk = _unique_case()
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, strategy=strategy, device="cpu", return_arrays=True,
        return_info=True)
    jcount, _, jkeys, jvals = fj.join_materialize(
        bk, bv, pk, strategy="partitioned", return_arrays=True)
    assert keys.dtype == vals.dtype == np.uint64
    assert count == jcount == keys.size == vals.size
    assert info["strategy"] == ("merge" if strategy == "merge"
                                else "partitioned")
    for g, j in zip(_sorted(keys, vals), _sorted(jkeys, jvals)):
        np.testing.assert_array_equal(g, j)
    if strategy != "merge":                      # partitioned: probe order
        for g, w in zip((keys, vals), _min_row_rows(bk, bv, pk)):
            np.testing.assert_array_equal(g, w)


def test_join_materialize_duplicate_keys():
    rng = np.random.default_rng(13)
    bk = rng.integers(0, 2**64, 400, dtype=np.uint64)
    bk = bk[rng.integers(0, 400, 3_000)]             # every key ~7 times
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 5_000),
                         rng.integers(0, 2**64, 4_000, dtype=np.uint64)])
    want = _min_row_rows(bk, bv, pk)
    for strategy in ("partitioned", "merge"):
        count, _, keys, vals = ft.join_materialize(
            bk, bv, pk, strategy=strategy, device="cpu", return_arrays=True)
        assert count == want[0].size
        for g, w in zip(_sorted(keys, vals), _sorted(*want)):
            np.testing.assert_array_equal(g, w)
    jcount, _, jkeys, jvals = fj.join_materialize(
        bk, bv, pk, strategy="partitioned", return_arrays=True)
    assert jcount == count
    np.testing.assert_array_equal(np.sort(jkeys), np.sort(want[0]))
    runs = {}
    for k, v in zip(bk.tolist(), bv.tolist()):
        runs.setdefault(k, set()).add(v)
    assert all(v in runs[k] for k, v in zip(jkeys.tolist(), jvals.tolist()))


def test_adaptive_materialize_of_dense_keys_routes_direct(monkeypatch):
    # dense-domain materialize (K7/K8): with the gates open the count and
    # the materialize both go direct, and the rows equal the oracle's in
    # probe order, as an explicit strategy="direct" gives them
    open_gates(monkeypatch)
    case = twl.j1_suite(100_000, seed=3)[1]
    bk, bv, pk = case.build_keys, case.build_values, case.probe_keys
    count, _, cinfo = ft.adaptive_join_count(bk, bv, pk, device="cpu",
                                             return_info=True)
    mcount, _, keys, vals, minfo = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert count == mcount == oracle_count(bk, pk)
    assert cinfo["strategy"] == "direct"
    assert minfo["strategy"] == "direct" and not minfo["retried"]
    for g, w in zip((keys, vals), _min_row_rows(bk, bv, pk)):
        np.testing.assert_array_equal(g, w)
    dcount, _, dkeys, dvals = ft.join_materialize(
        bk, bv, pk, strategy="direct", device="cpu", return_arrays=True)
    assert dcount == mcount
    np.testing.assert_array_equal(dkeys, keys)
    np.testing.assert_array_equal(dvals, vals)


def test_adaptive_materialize_of_dense_keys_routes_partitioned(
        monkeypatch):
    # dense keys spanning more than the value planes' 2^20 slots: even with
    # the gates open the count still goes direct (bitmap up to
    # MAX_XL_DOMAIN_BITS), the materialize partitioned, with the oracle's
    # rows in probe order
    open_gates(monkeypatch)
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 3_000_000, 50_000, dtype=np.uint64)
    bv = rng.integers(1, 101, bk.size, dtype=np.uint64)
    pk = rng.integers(0, 3_300_000, 100_000, dtype=np.uint64)
    count, _, cinfo = ft.adaptive_join_count(bk, bv, pk, device="cpu",
                                             return_info=True)
    mcount, _, keys, vals, minfo = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert count == mcount == oracle_count(bk, pk)
    assert cinfo["strategy"] == "direct"
    assert minfo["strategy"] == "partitioned" and not minfo["retried"]
    for g, w in zip((keys, vals), _min_row_rows(bk, bv, pk)):
        np.testing.assert_array_equal(g, w)


def test_materialize_special_channel_reruns_on_merge(monkeypatch):
    real = teng.materialize_graph

    def lossy(strategy):
        fn = real(strategy)
        if strategy != "partitioned":
            return fn

        def run(*args):
            *out, special = fn(*args)
            return (*out, special + torch.tensor([0, 0, 0, 1]))
        return run

    monkeypatch.setattr(teng, "materialize_graph", lossy)
    bk, bv, pk = _unique_case()
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, strategy="partitioned", device="cpu", return_arrays=True,
        return_info=True)
    assert info["retried"] and info["strategy"] == "merge"
    assert count == oracle_count(bk, pk)
    for g, w in zip(_sorted(keys, vals), _sorted(*_min_row_rows(bk, bv, pk))):
        np.testing.assert_array_equal(g, w)


def test_materialize_edge_cases():
    empty = np.zeros(0, np.uint64)
    pk = np.arange(10, dtype=np.uint64)
    out = ft.join_materialize(empty, empty, pk, device="cpu",
                              return_arrays=True)
    assert out[:2] == (0, 0.0) and out[2].size == out[3].size == 0
    assert ft.adaptive_join(pk, pk, empty, device="cpu",
                            return_info=True) == (0, 0.0, None)
    m = np.uint64(2**64 - 1)                             # EMPTY-sentinel key
    bkm = np.array([m, 5, m], np.uint64)
    bvm = np.array([1, 2, 3], np.uint64)
    pkm = np.array([m, 4, 5, m, 0], np.uint64)
    count, _, keys, vals = ft.join_materialize(bkm, bvm, pkm, device="cpu",
                                               return_arrays=True)
    assert count == 3
    assert list(zip(keys.tolist(), vals.tolist())) == [
        (2**64 - 1, 1), (5, 2), (2**64 - 1, 1)]
    with pytest.raises(ValueError):
        ft.hash_join_radix(bkm, bvm[:2], pkm, device="cpu")


def test_partitioned_plan_chunks_stream(monkeypatch):
    # partitioned plans of more than one chunk stream, count and rows
    monkeypatch.setattr(tapi, "hbm_budget_bytes", lambda dev: 300_000)
    bk = np.arange(1_000, dtype=np.uint64) << np.uint64(40)
    pk = np.arange(100_000, dtype=np.uint64)
    pk[::7] = np.resize(bk, pk[::7].size)
    want = oracle_count(bk, pk)
    count, _, info = ft.hash_join_count_radix(bk, bk, pk, device="cpu",
                                              return_info=True)
    assert count == want and info["probe_chunks"] > 1
    count, _, info = ft.adaptive_join(bk, bk, pk, device="cpu",
                                      return_info=True)
    assert count == want and info["probe_chunks"] > 1
    assert info["strategy"] == "partitioned"
    # an explicit merge does not plan chunks
    count, _, info = ft.join_count(bk, bk, pk, strategy="merge",
                                   device="cpu", return_info=True)
    assert count == want and info["probe_chunks"] == 1


@pytest.mark.parametrize("name", ["4e7-Q5-shaped", "sparse", "chunked"])
def test_measure_device_seconds_matches_jax_count(monkeypatch, name):
    # held against the JAX package's join_count: its measure_device_seconds
    # compiles a chained scan and is a slow test
    rng = np.random.default_rng(12)
    if name == "sparse":
        case = twl.uniform_case(3_000, 20_000, 0.3, seed=12)
        bk, bv, pk = case.build_keys, case.build_values, case.probe_keys
    else:
        bk = rng.integers(0, 44_000, 40_000, dtype=np.uint64)
        bv = rng.integers(0, 2**63, 40_000, dtype=np.uint64)
        pk = rng.integers(0, 44_000, 40_000, dtype=np.uint64)
    if name == "chunked":
        monkeypatch.setattr(tapi, "choose_plan", lambda nb, npr, cfg, mode,
                            budget: tcost.JoinPlan("partitioned", 10, 2))
    count, dev_s, single, chained = ft.measure_device_seconds(
        bk, bv, pk, device="cpu", number=2, reps=7)
    assert count == fj.join_count(bk, bv, pk)[0] == oracle_count(bk, pk)
    assert chained is False and 0 < dev_s <= single
    if name == "chunked":                    # a stream is timed once
        assert dev_s == single
    mcount, *_ = ft.measure_device_seconds(bk, bv, pk, mode="materialize",
                                           strategy="partitioned",
                                           device="cpu", number=1)
    assert mcount == count
    empty = np.zeros(0, np.uint64)
    assert ft.measure_device_seconds(empty, empty, pk, device="cpu") == (
        0, 0.0, 0.0, False)
    with pytest.raises(ValueError):
        ft.measure_device_seconds(bk, bv, pk, strategy="nope", device="cpu")


@pytest.mark.parametrize("strategy,empty", [("global", False),
                                            ("merge", False),
                                            ("global", True)])
def test_return_info_keeps_the_rows_by_design(strategy, empty):
    # A designed difference: with return_arrays=True and return_info=True
    # the JAX package's _run_join (its public join_materialize takes no
    # return_info) returns (count, core_seconds, info) and drops the rows;
    # the port's join_materialize returns (count, core_seconds, keys,
    # values, info).  The counts agree.
    rng = np.random.default_rng(31)
    bk = rng.integers(0, 5_000, 0 if empty else 2_000, dtype=np.uint64)
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    pk = rng.integers(0, 6_000, 3_000, dtype=np.uint64)
    jout = japi._run_join(bk, bv, pk, mode="materialize", strategy=strategy,
                          use_bloom=False, return_arrays=True,
                          return_info=True)
    tout = ft.join_materialize(bk, bv, pk, strategy=strategy, device="cpu",
                               return_arrays=True, return_info=True)
    assert len(jout) == 3 and len(tout) == 5
    assert jout[0] == tout[0] == oracle_count(bk, pk)
    assert (jout[2] is None) == (tout[4] is None) == empty
    np.testing.assert_array_equal(np.sort(tout[2]), np.sort(pk[np.isin(pk,
                                                                      bk)]))
