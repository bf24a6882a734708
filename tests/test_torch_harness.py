"""The port's harness twins (flash_hash_join_tpu_torch/harness/) on the CPU,
against the JAX package's benchmark.py, scripts/fuzz_join.py and joins.

The benchmark twin: the generated suites equal the JAX harness's, every
impl label's count (both tasks) equals the JAX package's matching
function's on the same case, J1 CSV suites load as written, a wrong count
makes main exit 1, and the DuckDB rows work with the JAX harness tests'
fake DuckDB.  The fuzzer twin: gen_case draws the JAX fuzzer's arrays, its
iterations pass, a planted off-by-one fails, --chunked streams, and on a
handful of seeds its joins equal the JAX package's.  The port runs with
device="cpu" (each kernel's plain PyTorch version).  Tolerance: exact
equality.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

import benchmark as jax_bm
import flash_hash_join_tpu as fj
from flash_hash_join_tpu_torch import api
from flash_hash_join_tpu_torch.harness import benchmark as hb
from flash_hash_join_tpu_torch.harness import fuzz_join as hf
from tests.test_benchmark_harness import _FakeDuckdb

REPO = Path(__file__).resolve().parent.parent
M64 = 2**64 - 1

# the JAX package's function for each impl label of the harness
JAX_IMPLS = {
    "adaptive_join": (fj.adaptive_join_count, fj.adaptive_join),
    "adaptive_bloom": (fj.adaptive_join_count_bloom, fj.adaptive_join_bloom),
    "flash_join": (fj.hash_join_count, fj.hash_join),
    "flash_join_radix": (fj.hash_join_count_radix, fj.hash_join_radix),
    "flash_join_bloom": (fj.hash_join_count_bloom, fj.hash_join_bloom),
    "flash_join_radix_bloom": (fj.hash_join_count_radix_bloom,
                               fj.hash_join_radix_bloom),
}


def _jax_fuzzer():
    """scripts/fuzz_join.py as a module (its top level imports numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_join", REPO / "scripts" / "fuzz_join.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the benchmark twin ------------------------------------------------------

def test_impl_labels_match_the_jax_harness():
    assert list(hb.IMPLS) == list(JAX_IMPLS)


def test_gen_suites_equal_the_jax_harness():
    ours, theirs = hb.gen_suites(10_000, 0), jax_bm.gen_suites(10_000, 0)
    assert [s[0] for s in ours] == [s[0] for s in theirs]
    for (_, cases), (_, jcases) in zip(ours, theirs):
        assert [c[0] for c in cases] == [c[0] for c in jcases]
        for case, jcase in zip(cases, jcases):
            for a, b in zip(case[1:], jcase[1:]):
                assert a.dtype == b.dtype == np.uint64
                np.testing.assert_array_equal(a, b)


def test_run_suites_counts_equal_the_jax_functions(capsys):
    suites = hb.gen_suites(10_000, 0)
    results, ok = hb.run_suites(suites, device="cpu",
                                check_values_max=10_000)
    assert ok and all(r["ok"] for r in results)
    assert {r["oracle"] for r in results} == {"native"}
    cases = {case_id: (bk, bv, pk) for case_id, bk, bv, pk in suites[0][1]}
    runs = [r for r in results if r["task"] != "check_values"]
    assert len(runs) == len(cases) * len(hb.IMPLS) * 2
    for r in runs:
        count_fn, mat_fn = JAX_IMPLS[r["label"]]
        fn = count_fn if r["task"] == "join_count" else mat_fn
        assert r["count"] == fn(*cases[r["case"]])[0], r
    checks = [r for r in results if r["task"] == "check_values"]
    assert len(checks) == len(cases) * 3 and all(r["ok"] for r in checks)
    out = capsys.readouterr().out
    assert out.count("RESULT,Library=") == len(runs)
    assert "Alias=adaptive_join" in out and "Alias=flash_join_radix" in out


def _j1_csvs(tmp_path, x_name: str = "NA", n: int = 1_000):
    """A J1 set named as db-benchmark names J1 1e7 (x, and its tables of
    n / 1e6, n / 1e3 and n rows), with n / 100, n / 10 and n rows in them
    and string columns between the numeric ones; x named J1_1e7_<x_name>.
    Returns the arrays of each case."""
    rng = np.random.default_rng(5)
    x = {c: rng.integers(0, 2**40, n, dtype=np.uint64)
         for c in ("id1", "id2", "id3", "v1")}
    tables = {x_name: (["id1", "id2", "id3", "id4", "id5", "id6", "v1"], x)}
    want = {}
    for qid, right, keycol, rows, cols in (
            ("Q1", "1e1", "id1", n // 100, ["id1", "id4", "v2"]),
            ("Q2", "1e4", "id2", n // 10, ["id1", "id2", "id4", "id5", "v2"]),
            ("Q5", "1e7", "id3", n, ["id1", "id2", "id3", "id4", "id5",
                                     "id6", "v2"])):
        t = tables[right][1] if right in tables else {
            c: rng.integers(0, 2**40, rows, dtype=np.uint64)
            for c in ("id1", "id2", "id3")}
        t[keycol][::2] = rng.choice(x[keycol], t[keycol][::2].size)
        t["v2"] = rng.integers(1, 101, len(t["id1"]), dtype=np.uint64)
        tables[right] = (cols, t)
        want[f"1e7-{qid}"] = (t[keycol], t["v2"], x[keycol])
    for right, (cols, t) in tables.items():
        with open(tmp_path / f"J1_1e7_{right}_0_0.csv", "w") as f:
            f.write(",".join(cols) + "\n")
            for i in range(len(t["id1"])):
                f.write(",".join(str(t[c][i]) if c in t else f"id{i % 9}"
                                 for c in cols) + "\n")
    (tmp_path / "J1_1e7_NA_0_0.txt").write_text("not a suite")
    return want


# x as db-benchmark names it (NA), and as the reference harness reads it:
# J1_<n>_<n>_0_0.csv, the big table, which then is x as well
@pytest.mark.parametrize("x_name", ["NA", "1e7"])
def test_load_csv_suites_reads_the_arrays_written(tmp_path, x_name):
    want = _j1_csvs(tmp_path, x_name)
    suites = hb.load_csv_suites(str(tmp_path))
    assert [s[0] for s in suites] == ["1e7"]
    cases = {c[0]: c[1:] for c in suites[0][1]}
    assert sorted(cases) == sorted(want)
    for case_id, arrays in want.items():
        for got, expected in zip(cases[case_id], arrays):
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, expected)


def test_load_csv_suites_skips_an_incomplete_set(tmp_path):
    _j1_csvs(tmp_path)
    os.remove(tmp_path / "J1_1e7_1e4_0_0.csv")
    assert hb.load_csv_suites(str(tmp_path)) == []


@pytest.mark.parametrize("planted,code", [(False, 0), (True, 1)])
def test_main_exits_1_on_a_wrong_count(monkeypatch, capsys, planted, code):
    count_fn, mat_fn, strat, bloom = hb.IMPLS["adaptive_join"]
    if planted:
        def count_plus_one(*a, **kw):
            count, secs = count_fn(*a, **kw)
            return count + 1, secs
        monkeypatch.setitem(hb.IMPLS, "adaptive_join",
                            (count_plus_one, mat_fn, strat, bloom))
    with pytest.raises(SystemExit) as exit_:
        hb.main(["--gen", "1e4", "--device", "cpu", "--no-charts",
                 "--no-duckdb", "--impls", "adaptive_join", "--cases", "Q2",
                 "--device-time"])
    assert exit_.value.code == code
    out = capsys.readouterr().out
    assert ("PARITY FAILURE: adaptive_join/join_count" in out) == planted
    assert "oracle=native" in out
    # no device on the CPU, so no Device= column
    assert ",Device=" not in out and "on a card only" in out


def test_duckdb_competitor_rows_and_parity():
    rng = np.random.default_rng(3)
    bk = rng.integers(0, 5_000, 4_000).astype(np.uint64)  # has duplicates
    bv = rng.integers(0, 100, 4_000).astype(np.uint64)
    pk = rng.integers(0, 6_000, 20_000).astype(np.uint64)
    expected = int(np.isin(pk, np.unique(bk)).sum())
    results = []
    assert hb.run_duckdb_case(_FakeDuckdb, "T-Q2", bk, bv, pk, expected,
                              results)
    assert len(results) == 4
    assert {r["task"] for r in results} == {"join_count",
                                            "join_materialize"}
    assert all(r["count"] == expected and r["ok"] for r in results)
    assert {r["label"] for r in results} == {"duckdb (Join Only)",
                                             "duckdb (Ingest + Join)"}


def test_duckdb_parity_failure_detected():
    bk = np.array([1, 2, 3], np.uint64)
    pk = np.array([1, 2, 9], np.uint64)
    results = []
    assert not hb.run_duckdb_case(_FakeDuckdb, "T-bad", bk, bk, pk,
                                  expected=999, results=results)
    assert results and all(not r["ok"] for r in results)


def test_duckdb_absent_detection():
    mod = hb.duckdb_module()
    try:
        import duckdb  # noqa: F401
        assert mod is not None
    except ImportError:
        assert mod is None


# ---- the fuzzer twin ---------------------------------------------------------

@pytest.mark.parametrize("fixed_shapes", [False, True])
def test_gen_case_draws_the_jax_fuzzers_arrays(fixed_shapes):
    jax_fuzz = _jax_fuzzer()
    assert hf.FIXED_SHAPES == jax_fuzz.FIXED_SHAPES
    for seed in range(64):
        ours = hf.gen_case(np.random.default_rng(seed), fixed_shapes)
        theirs = jax_fuzz.gen_case(np.random.default_rng(seed), fixed_shapes)
        assert ours[0] == theirs[0]
        for a, b in zip(ours[1:], theirs[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fuzz_iterations_pass(capsys):
    with pytest.raises(SystemExit) as exit_:
        hf.main(["--iters", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert exit_.value.code == 0, out
    assert "DONE 16 iters, 0 failures" in out and "FAIL" not in out


def test_planted_off_by_one_fails(monkeypatch, capsys):
    real = api.join_count

    def off_by_one(*a, **kw):
        count, *rest = real(*a, **kw)
        return (count + 1, *rest)

    monkeypatch.setattr(api, "join_count", off_by_one)
    with pytest.raises(SystemExit) as exit_:
        hf.main(["--iters", "3", "--seed", "9", "--device", "cpu"])
    out = capsys.readouterr().out
    assert exit_.value.code == 1
    assert out.count("FAIL seed=") == 3 and "FAIL seed=9 " in out
    assert "DONE 3 iters, 3 failures" in out


def test_chunked_streams_and_restores(monkeypatch):
    monkeypatch.setenv("FHJ_CHUNK_OVERLAP", "1")
    chunks = []
    real = api._run_chunked

    def spy(route, *a, **kw):
        chunks.append(route.probe_chunks)
        return real(route, *a, **kw)

    monkeypatch.setattr(api, "_run_chunked", spy)
    plan = api.choose_plan
    res = hf.run_fuzz(12, 0, chunked=True, device="cpu",
                      log=pytest.fail)
    assert res["fails"] == 0
    # iterations 0, 1, 6 and 7 (adaptive, partitioned) probe >= 4096 rows
    assert res["streamed"] == 4 and chunks and min(chunks) >= 2
    assert set(chunks) <= {2, 3, 4}
    assert api.choose_plan is plan and os.environ["FHJ_CHUNK_OVERLAP"] == "1"


def test_direct_eligibility_is_the_ports_rule():
    rng = np.random.default_rng(0)
    dense = rng.integers(0, 1_000, 5_000, dtype=np.uint64)
    assert hf.strategies_for(5, dense, dense, dense) == ("direct", "direct")
    # count only: past MAX_BUILD_ROWS build rows a materialize is not direct
    many = np.arange((1 << 20) + 1, dtype=np.uint64)
    assert hf.strategies_for(5, many, many, many) == ("direct", "merge")
    wide = np.array([0, 2**33], np.uint64)
    assert hf.strategies_for(5, wide, wide, wide) == ("merge", "merge")
    # vmem only on builds of at most 40000 rows probed twice over
    assert hf.strategies_for(4, dense, dense, dense[:9_000]) == ("merge",
                                                                 "merge")
    assert hf.strategies_for(4, dense, dense, np.tile(dense, 2))[0] == "vmem"


def test_pair_membership_and_multiset():
    np.testing.assert_array_equal(hb.pair_multiset([2, 1, 2], [9, 8, 7]),
                                  [[1, 8], [2, 7], [2, 9]])
    assert hb.pair_multiset([], []).shape == (0, 2)
    # both rows' pairs are build rows (1, 8), (2, 9) and (2, 7); only the
    # minimum build row of key 2 is the winner, and the multisets differ
    want = hb.pair_multiset([2, 1, M64], [9, 8, 0])
    assert not np.array_equal(hb.pair_multiset([2, 1, M64], [7, 8, 0]), want)
    np.testing.assert_array_equal(hb.pair_multiset([M64, 2, 1], [0, 9, 8]),
                                  want)


def test_planted_wrong_winner_fails(monkeypatch, capsys):
    """The last build row of a duplicate key in place of the first: the
    count and the key multiset stay right, the pairs do not.  Seeds
    266-271 run every strategy of the rotation (vmem and direct included)
    on builds whose duplicate keys are probed."""
    real = api.join_materialize

    def last_row_wins(bk, bv, pk, **kw):
        out = list(real(bk, bv, pk, **kw))
        rk = np.asarray(bk, np.uint64)[::-1]
        uniq, last = np.unique(rk, return_index=True)
        out[3] = np.asarray(bv, np.uint64)[::-1][
            last[np.searchsorted(uniq, out[2])]]
        return tuple(out)

    monkeypatch.setattr(api, "join_materialize", last_row_wins)
    with pytest.raises(SystemExit) as exit_:
        hf.main(["--iters", "6", "--seed", "266", "--device", "cpu"])
    out = capsys.readouterr().out
    assert exit_.value.code == 1
    fails = [line for line in out.splitlines() if line.startswith("FAIL")]
    assert len(fails) == 6, out
    assert all("(key, value) multiset" in line for line in fails), out
    assert {f"strat={s}" for s in hf.STRATEGIES} <= {
        w for line in fails for w in line.split()}, out


# seeds of the random mode (not dense_wide, whose interpreted JAX kernel
# compiles for minutes on the CPU; the fuzzer still runs it, port against
# oracle): direct, merge, global, vmem and partitioned, each with matches
@pytest.mark.parametrize("seed", [5, 20, 33, 34, 61])
def test_port_equals_the_jax_package_on_fuzz_seeds(seed):
    dist, bk, bv, pk = hf.gen_case(np.random.default_rng(seed))
    assert dist != "dense_wide"
    strat, mat_strat = hf.strategies_for(seed, bk, bv, pk)
    count = api.join_count(bk, bv, pk, strategy=strat, device="cpu")[0]
    assert count > 0
    assert count == fj.join_count(bk, bv, pk, strategy=strat)[0]
    got = api.join_materialize(bk, bv, pk, strategy=mat_strat,
                               return_arrays=True, device="cpu")
    want = fj.join_materialize(bk, bv, pk, strategy=mat_strat,
                               return_arrays=True)
    assert got[0] == want[0] == count
    np.testing.assert_array_equal(np.sort(got[2]), np.sort(want[2]))
