"""The port's host-side probe-chunk streaming and feasibility planner
(flash_hash_join_tpu_torch/api.py _run_chunked, models/cost.py), on the
CPU, against the JAX package's joins and the numpy oracle: the cases of
tests/test_chunked.py's host stream.

Inputs come from numpy generators with a fixed seed; the port runs with
device="cpu" (the kernels' plain versions).  Tolerance: exact equality.
Counts equal the JAX package's join_count; materialized rows equal its
join_materialize's as a sorted multiset (build keys unique, so every
strategy's winner is the same row) and the single shot's in probe order.
"""

import numpy as np
import pytest
import torch

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch import api as tapi
from flash_hash_join_tpu_torch.models import cost as tcost
from flash_hash_join_tpu_torch.models.cost import JoinPlan
from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG
from tests.oracle import oracle_count
from tests.torch_gates import open_gates

M64 = 2**64 - 1


@pytest.fixture
def planned(monkeypatch):
    """force(k): the planner plans k probe chunks for every shape (the
    strategy stays the plan's)."""
    def force(k):
        monkeypatch.setattr(tapi, "choose_plan", lambda nb, npr, cfg, mode,
                            budget: JoinPlan("partitioned",
                                             cfg.group_bits(nb), k))
    return force


@pytest.fixture
def chunk_sizes(monkeypatch):
    """The probe rows of every chunk the joins run, in order."""
    sizes = []
    real = tapi._graph

    def spy(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            sizes.append(args[4].numel())
            return fn(*args)
        return run

    monkeypatch.setattr(tapi, "_graph", spy)
    return sizes


def _sparse(seed: int, nb: int = 3_001, npr: int = 20_011):
    """64-bit unique build keys (the u64-max key among them) and probes,
    a third of them hits, some of them the u64-max key."""
    rng = np.random.default_rng(seed)
    bk = np.unique(rng.integers(0, 2**64 - 1, nb, dtype=np.uint64))
    bk[-1] = M64
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    pk = rng.integers(0, 2**64 - 1, npr, dtype=np.uint64)
    pk[::3] = rng.choice(bk, pk[::3].size)
    pk[5:9] = M64
    return bk, bv, pk


def _sorted_rows(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


@pytest.mark.parametrize("chunks", [2, 3, 5])
def test_chunked_count_and_rows_match_single_shot_and_jax(planned, chunks,
                                                          chunk_sizes):
    bk, bv, pk = _sparse(chunks)
    single = ft.join_count(bk, bv, pk, device="cpu")[0]
    _, _, skeys, svals = ft.join_materialize(bk, bv, pk, device="cpu",
                                             return_arrays=True)
    jcount = fj.join_count(bk, bv, pk)[0]
    _, _, jkeys, jvals = fj.join_materialize(bk, bv, pk, return_arrays=True)
    planned(chunks)
    chunk_sizes.clear()
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   return_info=True)
    assert count == single == jcount == oracle_count(bk, pk)
    assert info["probe_chunks"] == chunks and not info["retried"]
    assert info["strategy"] == "partitioned"
    # each chunk at its true length: no pad rows, lengths not divisible
    assert sum(chunk_sizes) == pk.size and len(chunk_sizes) == chunks
    assert len(set(chunk_sizes)) == 2
    mcount, _, keys, vals, minfo = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert mcount == count and minfo["probe_chunks"] == chunks
    np.testing.assert_array_equal(keys, skeys)        # chunk order = probe
    np.testing.assert_array_equal(vals, svals)
    for g, w in zip(_sorted_rows(keys, vals), _sorted_rows(jkeys, jvals)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["count", "materialize"])
def test_serial_and_overlapped_streams_agree(planned, monkeypatch, mode):
    bk, bv, pk = _sparse(11)
    planned(3)
    fn = ft.join_count if mode == "count" else ft.join_materialize
    kw = {} if mode == "count" else dict(return_arrays=True)
    overlapped = fn(bk, bv, pk, device="cpu", **kw)
    monkeypatch.setenv("FHJ_CHUNK_OVERLAP", "0")
    serial = fn(bk, bv, pk, device="cpu", **kw)
    assert overlapped[0] == serial[0] == oracle_count(bk, pk)
    assert overlapped[1] > 0 and serial[1] > 0
    for a, b in zip(overlapped[2:], serial[2:]):
        np.testing.assert_array_equal(a, b)


def _out_of_memory_above(monkeypatch, rows: int, seen: list):
    """Every join of more than `rows` probe rows raises the card's
    out-of-memory error."""
    real = tapi._graph

    def greedy(*a, **kw):
        fn = real(*a, **kw)

        def run(*args):
            seen.append(args[4].numel())
            if args[4].numel() > rows:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory "
                                                  "(synthetic)")
            return fn(*args)
        return run

    monkeypatch.setattr(tapi, "_graph", greedy)


def test_chunked_out_of_memory_doubles_the_chunks(planned, monkeypatch):
    bk, bv, pk = _sparse(23, npr=9_000)
    seen = []
    _out_of_memory_above(monkeypatch, 3_000, seen)
    planned(2)
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   return_info=True)
    assert count == oracle_count(bk, pk)
    # 2 chunks of 4500 ran out of memory, 4 of 2250 ran
    assert info["probe_chunks"] == 4 and seen[0] == 4_500
    count, _, keys, _, info = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert count == oracle_count(bk, pk) and info["probe_chunks"] == 4
    np.testing.assert_array_equal(keys, pk[np.isin(pk, bk)])


def test_out_of_memory_at_65536_chunks_propagates(planned, monkeypatch):
    bk, bv, pk = _sparse(24, npr=300)
    seen = []
    _out_of_memory_above(monkeypatch, 0, seen)
    planned(2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ft.join_count(bk, bv, pk, device="cpu")
    # every doubling from 2 to 65536 was tried once, each failing at its
    # first chunk (at most 1 row past 300 chunks)
    assert len(seen) == 16 and seen[-1] == 1


def test_single_shot_out_of_memory_falls_back_to_chunks(monkeypatch):
    bk, bv, pk = _sparse(29, npr=10_000)
    seen = []
    _out_of_memory_above(monkeypatch, 9_999, seen)
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   return_info=True)
    assert count == oracle_count(bk, pk)
    assert seen[0] == 10_000 and info["probe_chunks"] == 2
    # a direct (dense) single shot does not stream: it raises
    dense = np.arange(5_000, dtype=np.uint64)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ft.join_count(dense, dense, np.arange(10_000, dtype=np.uint64),
                      device="cpu")


def test_unresolved_chunk_reruns_alone_on_merge(planned, monkeypatch):
    # the first chunk reports a dropped build row and a wrong count; it
    # alone reruns on merge
    bk, bv, pk = _sparse(31)
    real = tapi._graph
    calls = []

    def lossy(mode, strategy, *a, **kw):
        fn = real(mode, strategy, *a, **kw)

        def run(*args):
            out = fn(*args)
            calls.append(strategy)
            if calls.count("partitioned") != 1 or strategy != "partitioned":
                return out
            return (out[0] - 1, *out[1:-1],
                    out[-1] + torch.tensor([0, 0, 0, 1]))
        return run

    monkeypatch.setattr(tapi, "_graph", lossy)
    planned(3)
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   return_info=True)
    assert count == oracle_count(bk, pk) and info["retried"]
    assert info["probe_chunks"] == 3
    # the depth-2 pipeline launches chunk 1 before it reads chunk 0
    assert calls == ["partitioned", "partitioned", "merge", "partitioned"]
    calls.clear()
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert info["retried"] and count == oracle_count(bk, pk)
    # merge emits (hash, key) order: compare the rows as a multiset
    _, _, skeys, svals = ft.join_materialize(bk, bv, pk, device="cpu",
                                             strategy="merge",
                                             return_arrays=True)
    for g, w in zip(_sorted_rows(keys, vals), _sorted_rows(skeys, svals)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunks", [2, 3])
def test_short_last_chunk_counts_no_extra_rows(planned, chunk_sizes, chunks):
    # 0 is a real build key, so a pad row of key 0 would count (the JAX
    # package's re-chunk fault, ee40467); the port slices each chunk at its
    # true length
    rng = np.random.default_rng(991)
    bk = np.zeros(1_000, dtype=np.uint64) | np.uint64(2**40)
    bk[::2] = 0
    bv = rng.integers(0, 2**31, bk.size, dtype=np.uint64)
    pk = rng.integers(0, 3, 7_991, dtype=np.uint64)
    planned(chunks)
    count, _, info = ft.join_count(bk, bv, pk, device="cpu",
                                   strategy="partitioned", return_info=True)
    assert count == int((pk == 0).sum()) and info["probe_chunks"] == chunks
    assert sum(chunk_sizes) == pk.size and chunk_sizes[-1] < chunk_sizes[0]
    count, _, keys, _ = ft.join_materialize(bk, bv, pk, device="cpu",
                                            strategy="partitioned",
                                            return_arrays=True)
    assert count == int((pk == 0).sum()) and keys.size == count


@pytest.mark.parametrize("strategy", ["direct", "merge", "global", "vmem"])
def test_explicit_strategies_bypass_the_plan(monkeypatch, strategy):
    def exploding(*a):
        raise AssertionError("the plan must not be consulted")

    monkeypatch.setattr(tapi, "choose_plan", exploding)
    rng = np.random.default_rng(2)
    bk = rng.integers(0, 3_000, 2_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, 2_000, dtype=np.uint64)
    pk = rng.integers(0, 3_000, 5_000, dtype=np.uint64)
    count, _, info = ft.join_count(bk, bv, pk, strategy=strategy,
                                   device="cpu", return_info=True)
    assert count == oracle_count(bk, pk) == fj.join_count(bk, bv, pk)[0]
    assert info["strategy"] == strategy and info["probe_chunks"] == 1


def test_chunked_dense_count_routes_direct(planned, chunk_sizes,
                                           monkeypatch):
    open_gates(monkeypatch)
    rng = np.random.default_rng(55)
    nb, npr = 30_000, 240_000
    bk = rng.integers(0, int(nb * 1.1), nb, dtype=np.uint64)
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.3), npr, dtype=np.uint64)
    planned(3)
    count, _, info = ft.adaptive_join_count(bk, bv, pk, device="cpu",
                                            return_info=True)
    assert count == oracle_count(bk, pk) == fj.adaptive_join_count(
        bk, bv, pk)[0]
    assert info["probe_chunks"] == 3 and info["strategy"] == "direct"
    assert info["d_rows"] > 0 and chunk_sizes == [80_000] * 3


def test_chunked_materialize_stays_partitioned(planned, monkeypatch):
    # the gates open: one shot goes direct, chunks stay partitioned
    open_gates(monkeypatch)
    rng = np.random.default_rng(56)
    nb, npr = 30_000, 240_000
    bk = rng.permutation(np.arange(nb, dtype=np.uint64))
    bv = rng.integers(0, 2**31, nb, dtype=np.uint64)
    pk = rng.integers(0, int(nb * 1.3), npr, dtype=np.uint64)
    single = ft.adaptive_join(bk, bv, pk, device="cpu", return_info=True)
    assert single[-1]["strategy"] == "direct"         # one shot: dense
    planned(3)
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert count == oracle_count(bk, pk) == single[0]
    assert info["strategy"] == "partitioned" and info["probe_chunks"] == 3
    np.testing.assert_array_equal(keys, pk[pk < nb])
    np.testing.assert_array_equal(vals, bv[np.argsort(bk)][keys.astype(
        np.int64)])


# --- the planner ----------------------------------------------------------

H100_BUDGET = int(80 * 1024**3 * tcost.HBM_HEADROOM)


def test_plan_budgets_the_depth2_pipeline():
    # an 8 GiB budget, under which no chunk reaches MAX_CHUNK_ROWS
    nb, npr, budget = 10_000_000, 10_000_000_000, 8 * 1024**3
    for mode, per_row, pipelined, fixed in (
            ("count", 8 + tcost.TRANSIENT_BYTES_COUNT, 8,
             tcost.BUILD_BYTES_COUNT),
            ("materialize", 24 + tcost.TRANSIENT_BYTES_MATERIALIZE, 24,
             tcost.BUILD_BYTES_MATERIALIZE)):
        assert tcost.footprint(nb, mode) == (fixed * nb, per_row, pipelined)
        n = tcost.plan_probe_chunks(nb, npr, mode, budget)
        chunk_rows = (budget - fixed * nb) // (per_row + pipelined)
        assert chunk_rows < tcost.MAX_CHUNK_ROWS
        assert n > 1 and n == -(-npr // chunk_rows)
        # a probe side that fits one shot is not charged the pipeline
        fits = (budget - fixed * nb) // per_row
        assert tcost.plan_probe_chunks(nb, fits, mode, budget) == 1
        assert tcost.plan_probe_chunks(nb, fits + 1, mode, budget) > 1


@pytest.mark.parametrize("mode", ["count", "materialize"])
def test_plan_caps_chunks_at_the_longest_measured_probe_side(mode):
    # the H100 budget would take several billion probe rows in one shot;
    # no chunk is longer than the longest probe side run on the card
    cap = tcost.MAX_CHUNK_ROWS
    assert tcost.plan_probe_chunks(10_000_000, cap, mode, H100_BUDGET) == 1
    assert tcost.plan_probe_chunks(10_000_000, cap + 1, mode,
                                   H100_BUDGET) == 2
    fixed, per_row, _ = tcost.footprint(10_000_000, mode)
    if mode == "count":
        assert (H100_BUDGET - fixed) // per_row > 4 * cap
        assert tcost.plan_probe_chunks(10_000_000, 4 * cap, mode,
                                       H100_BUDGET) == 4


def test_plan_raises_on_an_oversized_build():
    with pytest.raises(MemoryError):
        tcost.plan_probe_chunks(10**11, 10**6, "count", H100_BUDGET)
    with pytest.raises(MemoryError):
        tcost.plan_probe_chunks(1_000, 10, "materialize", 1_000)


def test_plan_shrinks_with_the_budget():
    plans = [tcost.plan_probe_chunks(1_000_000, 50_000_000, "count", b)
             for b in (1 << 36, 1 << 31, 1 << 30, 1 << 28)]
    assert plans == sorted(plans) and plans[0] == 1 and plans[-1] > plans[1]


def test_config3_plans_one_chunk_on_an_h100():
    # BASELINE.json config #3: 1e7 build x 1e9 probe rows, both modes in
    # one shot on an 80 GB card under the H100 constants; a 4e9-row probe
    # side streams a materialize
    for mode in ("count", "materialize"):
        plan = tcost.choose_plan(10_000_000, 1_000_000_000, DEFAULT_CONFIG,
                                 mode, H100_BUDGET)
        assert plan.strategy == "partitioned" and plan.probe_chunks == 1
    assert tcost.plan_probe_chunks(10_000_000, 4_000_000_000, "materialize",
                                   H100_BUDGET) > 1
