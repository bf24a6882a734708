"""The port's adaptive dispatcher on the CPU: the measured gates of
flash_hash_join_tpu_torch/ops/direct_bitmap.py on both sides of each
threshold, adaptive's route against the gate's decision (the thresholds
patched down to small shapes so that each gate binds both ways), the
gate-drift check's verdict on fixed times, the crossover sweep on a tiny
grid and the FHJ_PROFILE_DIR trace hook.

Inputs come from numpy generators with a fixed seed; the port runs with
device="cpu" (the kernels' plain PyTorch versions).  Tolerance: exact
equality of counts and of the sorted (key, value) rows with the JAX
package's adaptive_* and the numpy oracle (tests/oracle.py); build keys
are unique where values are compared with the JAX package.
"""

import glob
import os

import numpy as np
import pytest

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch import api as tapi
from flash_hash_join_tpu_torch.harness import crossover
from flash_hash_join_tpu_torch.harness import gate_drift
from flash_hash_join_tpu_torch.models.cost import JoinPlan
from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb
from tests.oracle import oracle_count, oracle_materialize
from tests.torch_gates import open_gates


# ---- the gate functions at the true constants ------------------------------

def _floor_sides(name):
    """(below, at) the probe-row floor `name`: a floor of 0 has no below."""
    floor = getattr(tdb, name)
    return ([floor - 1] if floor > 0 else []) + [floor]


def test_probe_floor_on_both_sides():
    for npr in _floor_sides("ADAPTIVE_MIN_PROBE_ROWS"):
        want = npr >= tdb.ADAPTIVE_MIN_PROBE_ROWS
        assert tdb.adaptive_wins("count", 1_000, npr, 1_100) == want


@pytest.mark.parametrize("span", [tdb.ADAPTIVE_SCAN_DOMAIN_BITS - 1,
                                  tdb.ADAPTIVE_SCAN_DOMAIN_BITS,
                                  tdb.ADAPTIVE_SCAN_DOMAIN_BITS + 1])
def test_scan_cap_on_both_sides(span):
    # up to the cap the scan band (K2) is direct; past the scan band's
    # 2^20 slots the large band's gate decides
    npr = 40_000_000
    got = tdb.adaptive_wins("count", 40_000, npr, span)
    if span <= tdb.ADAPTIVE_SCAN_DOMAIN_BITS:
        assert got
    elif span <= tdb.MAX_DOMAIN_BITS:
        assert not got
    else:
        assert got == tdb.large_span_wins(40_000, npr)


@pytest.mark.parametrize("nb", [2_500_000, 40_000_000, 100_000_000])
def test_large_span_wins_on_both_sides(nb):
    for npr in _floor_sides("LARGE_MIN_PROBE_ROWS"):
        assert tdb.large_span_wins(nb, npr) == (
            npr >= tdb.LARGE_MIN_PROBE_ROWS)
        assert tdb.adaptive_wins("count", nb, npr, int(nb * 1.1)) == (
            tdb.large_span_wins(nb, npr))


@pytest.mark.parametrize("v_rows,narrow,floor", [
    (8, True, "MAT_MIN_PROBE_ROWS"),
    (64, True, "MAT_MIN_PROBE_ROWS"),
    (128, True, "MAT_STAGED_MIN_PROBE_ROWS"),
    (1024, True, "MAT_STAGED_MIN_PROBE_ROWS"),
    (8192, True, "MAT_STAGED_MIN_PROBE_ROWS"),
    (8, False, "MAT_WIDE_MIN_PROBE_ROWS"),
    (1024, False, "MAT_WIDE_MIN_PROBE_ROWS")])
def test_mat_wins_on_both_sides(v_rows, narrow, floor):
    for npr in _floor_sides(floor):
        want = npr >= getattr(tdb, floor)
        assert tdb.mat_wins(v_rows, npr, narrow_values=narrow) == want
        assert tdb.adaptive_wins("materialize", 1_000, npr, v_rows * 100,
                                 narrow_values=narrow) == (
            want and npr >= tdb.ADAPTIVE_MIN_PROBE_ROWS)


# the sweep's J1 cells (PERF.md section 5): what the gates decide for them
@pytest.mark.parametrize("mode,n,q,expect", [
    ("count", 10_000_000, "Q1", "direct"),
    ("count", 40_000_000, "Q2", "direct"),
    ("count", 100_000_000, "Q5", "direct"),
    ("materialize", 10_000_000, "Q1", "partitioned"),
    ("materialize", 10_000_000, "Q2", "partitioned"),
    ("materialize", 40_000_000, "Q1", "partitioned"),
    ("materialize", 40_000_000, "Q2", "partitioned"),
    ("materialize", 100_000_000, "Q1", "partitioned"),
    ("materialize", 100_000_000, "Q2", "direct")])
def test_j1_cells_route_as_measured(mode, n, q, expect):
    nb = max(n // {"Q1": 1_000_000, "Q2": 1_000, "Q5": 1}[q], 1)
    span = int(nb * 1.1)
    bk = np.array([0, span - 1], dtype=np.uint64)
    bv = np.array([1, 100], dtype=np.uint64)
    # the route of the key columns' span; the build rows only size it
    wins = tdb.adaptive_wins(mode, nb, n, span)
    assert ("direct" if wins else "partitioned") == expect
    if mode == "count" or nb <= tdb.MAX_BUILD_ROWS:
        assert ft.adaptive_strategy(bk, bv, n, mode=mode,
                                    device="cpu") == expect


# ---- adaptive's route with the thresholds patched down --------------------

def _dense(nb, npr, span, seed, unique=False):
    """nb build keys over [0, span) (unique: distinct, 0 and span - 1 among
    them), values 1..100, npr probe keys over 1.2 x the span."""
    rng = np.random.default_rng(seed)
    bk = (np.concatenate([[0, span - 1], 1 + rng.permutation(span - 2)[
        :nb - 2]]) if unique
          else rng.integers(0, span, nb)).astype(np.uint64)
    bv = rng.integers(1, 101, nb, dtype=np.uint64)
    pk = rng.integers(0, int(span * 1.2), npr, dtype=np.uint64)
    return bk, bv, pk


def _check_count(bk, bv, pk, expect):
    count, _, info = ft.adaptive_join_count(bk, bv, pk, device="cpu",
                                            return_info=True)
    assert info["strategy"] == expect == ft.adaptive_strategy(
        bk, bv, pk.size, device="cpu")
    assert not info["retried"]
    jcount, _ = fj.adaptive_join_count(bk, bv, pk)
    assert count == jcount == oracle_count(bk, pk)


def _check_materialize(bk, bv, pk, expect):
    count, _, keys, vals, info = ft.join_materialize(
        bk, bv, pk, device="cpu", return_arrays=True, return_info=True)
    assert info["strategy"] == expect == ft.adaptive_strategy(
        bk, bv, pk.size, mode="materialize", device="cpu")
    assert not info["retried"]
    jcount, _, jkeys, jvals = fj.join_materialize(bk, bv, pk,
                                                  return_arrays=True)
    ocount, okeys, ovals = oracle_materialize(bk, bv, pk)   # unique keys
    assert count == jcount == ocount
    want = _pairs(okeys, ovals)
    np.testing.assert_array_equal(_pairs(keys, vals), want)
    np.testing.assert_array_equal(_pairs(jkeys, jvals), want)


def _pairs(keys, vals):
    order = np.lexsort((vals, keys))
    return np.stack([keys[order], vals[order]])


@pytest.mark.parametrize("bind", [True, False])
def test_probe_floor_binds_both_ways(bind, monkeypatch):
    open_gates(monkeypatch)
    bk, bv, pk = _dense(2_000, 30_000, 2_200, seed=1, unique=True)
    monkeypatch.setattr(tdb, "ADAPTIVE_MIN_PROBE_ROWS",
                        pk.size + 1 if bind else pk.size)
    expect = "partitioned" if bind else "direct"
    _check_count(bk, bv, pk, expect)
    _check_materialize(bk, bv, pk, expect)


@pytest.mark.parametrize("bind", [True, False])
def test_scan_cap_binds_both_ways(bind, monkeypatch):
    open_gates(monkeypatch)
    bk, bv, pk = _dense(3_000, 20_000, 40_000, seed=2)
    span = int(bk.max()) - int(bk.min()) + 1
    monkeypatch.setattr(tdb, "ADAPTIVE_SCAN_DOMAIN_BITS",
                        span - 1 if bind else span)
    _check_count(bk, bv, pk, "partitioned" if bind else "direct")


@pytest.mark.parametrize("bind", [True, False])
def test_large_span_gate_binds_both_ways(bind, monkeypatch):
    # a span past 2^20 slots: the large band (K1)
    open_gates(monkeypatch)
    bk, bv, pk = _dense(20_000, 40_000, 3_000_000, seed=3)
    monkeypatch.setattr(tdb, "LARGE_MIN_PROBE_ROWS",
                        pk.size + 1 if bind else pk.size)
    _check_count(bk, bv, pk, "partitioned" if bind else "direct")


@pytest.mark.parametrize("floor,span,wide", [
    ("MAT_MIN_PROBE_ROWS", 900, False),          # v_rows 8 (K7)
    ("MAT_STAGED_MIN_PROBE_ROWS", 14_000, False),  # v_rows 128 (K7)
    ("MAT_STAGED_MIN_PROBE_ROWS", 60_000, False),  # v_rows 512 (K8)
    ("MAT_WIDE_MIN_PROBE_ROWS", 60_000, True)])  # u64 values
@pytest.mark.parametrize("bind", [True, False])
def test_mat_gate_binds_both_ways(floor, span, wide, bind, monkeypatch):
    open_gates(monkeypatch)
    bk, bv, pk = _dense(min(span // 2, 2_000), 25_000, span, seed=span,
                        unique=True)
    if wide:
        bv = bv + np.uint64(2**40)
    monkeypatch.setattr(tdb, floor, pk.size + 1 if bind else pk.size)
    _check_materialize(bk, bv, pk, "partitioned" if bind else "direct")


def test_chunked_count_gates_on_rows_per_chunk(monkeypatch):
    # three probe chunks of 10_000 rows: a floor above a chunk's rows (but
    # below the whole probe side) shuts the gate, one at a chunk opens it
    open_gates(monkeypatch)
    monkeypatch.setattr(tapi, "choose_plan",
                        lambda nb, npr, cfg, mode, budget: JoinPlan(
                            "partitioned", cfg.group_bits(nb), 3))
    bk, bv, pk = _dense(1_000, 30_000, 1_100, seed=4)
    for floor, expect in ((10_001, "partitioned"), (10_000, "direct")):
        monkeypatch.setattr(tdb, "ADAPTIVE_MIN_PROBE_ROWS", floor)
        count, _, info = ft.adaptive_join_count(bk, bv, pk, device="cpu",
                                                return_info=True)
        assert info["probe_chunks"] == 3 and info["strategy"] == expect
        assert count == oracle_count(bk, pk)


def test_explicit_direct_ignores_the_gates(monkeypatch):
    # the gates shut: adaptive goes partitioned, an explicit direct still
    # runs direct, and a domain direct cannot take still raises
    for name in ("ADAPTIVE_MIN_PROBE_ROWS", "MAT_MIN_PROBE_ROWS"):
        monkeypatch.setattr(tdb, name, 10**12)
    bk, bv, pk = _dense(500, 5_000, 900, seed=5)
    for fn, mode in ((ft.join_count, "count"),
                     (ft.join_materialize, "materialize")):
        assert ft.adaptive_strategy(bk, bv, pk.size, mode=mode,
                                    device="cpu") == "partitioned"
        info = fn(bk, bv, pk, strategy="direct", device="cpu",
                  return_info=True)[-1]
        assert info["strategy"] == "direct"
    with pytest.raises(ValueError):
        ft.join_count(bk + np.uint64(2**40), bv, pk, strategy="direct",
                      device="cpu")


def test_adaptive_strategy_needs_nonempty_sides():
    with pytest.raises(ValueError):
        ft.adaptive_strategy(np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                             10, device="cpu")


# ---- the gate-drift check --------------------------------------------------

@pytest.mark.parametrize("t_direct,t_alt,routes_direct,ok,direct_wins", [
    (1.0, 2.0, True, True, True),       # gate direct, direct faster
    (2.0, 1.0, False, True, False),     # gate partitioned, partitioned faster
    (2.0, 1.0, True, False, False),     # gate direct, partitioned 2x faster
    (1.0, 2.0, False, False, True),     # gate partitioned, direct 2x faster
    (1.10, 1.0, True, True, False),     # a tie within --tol: 10 % < 15 %
    (1.0, 1.14, False, True, True),     # a tie within --tol: 14 %
])
def test_gate_drift_verdict_on_fixed_times(t_direct, t_alt, routes_direct,
                                           ok, direct_wins):
    got_ok, got_wins, margin = gate_drift.verdict(t_direct, t_alt,
                                                  routes_direct, 0.15)
    assert (got_ok, got_wins) == (ok, direct_wins)
    assert margin == pytest.approx(abs(t_direct - t_alt)
                                   / min(t_direct, t_alt))


def _tiny_sentinels(monkeypatch, times):
    """Two sentinels on either side of a patched probe floor; every
    measure_device_seconds call returns the real count and times[strategy]
    seconds."""
    open_gates(monkeypatch)
    monkeypatch.setattr(tdb, "ADAPTIVE_MIN_PROBE_ROWS", 20_000)
    pts = (gate_drift._grid("floor_out", "ADAPTIVE_MIN_PROBE_ROWS", "count",
                            1_000, 10_000, 1_100),
           gate_drift._grid("floor_in", "ADAPTIVE_MIN_PROBE_ROWS", "count",
                            1_000, 30_000, 1_100))
    monkeypatch.setattr(gate_drift, "SENTINELS", pts)
    real = ft.measure_device_seconds

    def fixed(bk, bv, pk, *, mode, strategy, number, device):
        count = real(bk, bv, pk, mode=mode, strategy=strategy, number=0,
                     device=device)[0]
        return count, times(len(pk), strategy), 0.0, False
    monkeypatch.setattr(ft, "measure_device_seconds", fixed)


def test_gate_drift_exit_code(monkeypatch, capsys):
    # times that agree with the gate: every line PASS, exit 0
    _tiny_sentinels(monkeypatch, lambda npr, s: (
        1.0 if (s == "direct") == (npr >= 20_000) else 2.0))
    with pytest.raises(SystemExit) as e:
        gate_drift.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert e.value.code == 0
    assert [ln.split(",")[0] for ln in out[1:]] == ["PASS"] * 3
    assert "gate_routes=partitioned" in out[1]
    assert "gate_routes=direct" in out[2]
    # times against the gate past --tol: FAIL lines, exit 1
    _tiny_sentinels(monkeypatch, lambda npr, s: (
        2.0 if (s == "direct") == (npr >= 20_000) else 1.0))
    with pytest.raises(SystemExit) as e:
        gate_drift.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert e.value.code == 1
    assert [ln.split(",")[0] for ln in out[1:]] == ["FAIL"] * 3
    assert out[-1] == "FAIL,total,failures=2"


def test_gate_drift_sentinels_sit_on_both_sides():
    # every gate has a sentinel a side (or, where it never binds, at both
    # ends of its measured region); each routes as its label says
    labels = {s.label for s in gate_drift.sentinels()}
    gates = {s.gate for s in gate_drift.sentinels()}
    assert gates == {"ADAPTIVE_MIN_PROBE_ROWS", "ADAPTIVE_SCAN_DOMAIN_BITS",
                     "LARGE_MIN_PROBE_ROWS", "MAT_MIN_PROBE_ROWS",
                     "MAT_STAGED_MIN_PROBE_ROWS", "MAT_WIDE_MIN_PROBE_ROWS"}
    assert len(labels) == len(gate_drift.sentinels())
    for s in gate_drift.sentinels() + gate_drift.sentinels(quick=True):
        p = s.point
        wins = tdb.adaptive_wins(p.mode, p.nb, p.npr, p.span,
                                 narrow_values=not p.wide)
        assert wins == s.label.endswith("_in"), s
        assert not s.cell or s.cell in ("1e7-Q2", "4e7-Q1", "4e7-Q2",
                                        "4e7-Q5", "1e8-Q1", "1e8-Q2",
                                        "1e8-Q5"), s


# ---- the crossover sweep ---------------------------------------------------

def test_crossover_on_a_tiny_grid(capsys):
    with pytest.raises(SystemExit) as e:
        crossover.main(["--mode", "count", "--j1", "2e4", "--nb", "3e3",
                        "--npr", "5e3", "--device", "cpu", "--repeats", "1"])
    assert e.value.code == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("RESULT,")]
    assert len(lines) == 4
    cases = {}
    for ln in lines:
        row = dict(kv.split("=", 1) for kv in ln.split(",")[1:])
        assert row["winner"] in ("direct", "partitioned")
        assert row["adaptive_route"] == "direct"   # the count gates hold
        cases[row["case"]] = int(row["count"])
    for c in crossover.j1_points("count", [20_000]):
        bk, _, pk = crossover.make_data(c, 0, {})
        assert cases[c.case] == oracle_count(bk, pk)
    p = crossover.Point("count", 3_000, 5_000, 3_300)
    bk, _, pk = crossover.make_data(p, 0, {})
    assert cases[p.case] == oracle_count(bk, pk)
    assert int(bk.min()) == 0 and int(bk.max()) == 3_299


def test_crossover_materialize_checks_rows():
    rows, ok = crossover.run_sweep(
        [crossover.Point("materialize", 800, 6_000, 921),
         crossover.Point("materialize", 800, 6_000, 921, wide=True)],
        device="cpu", repeats=1, log=lambda s: None)
    assert ok and len(rows) == 2
    for row, wide in zip(rows, (False, True)):
        assert row["rung"] == "v_rows:8" and row["band"] == "scan"
        assert row["values"] == ("u64" if wide else "narrow")
        assert row["rows_checked"] and row["direct_core_ms"] is not None
        assert row["adaptive_route"] == tapi.adaptive_strategy(
            *crossover.make_data(crossover.Point(
                "materialize", 800, 6_000, 921, wide=wide), 0, {})[:2],
            6_000, mode="materialize", device="cpu")


def test_crossover_flags_a_wrong_count(monkeypatch):
    monkeypatch.setattr(crossover.native, "host_join_count",
                        lambda bk, pk: -1)
    lines = []
    rows, ok = crossover.run_sweep(
        [crossover.Point("count", 100, 1_000, 110)], device="cpu",
        repeats=1, log=lines.append)
    assert not ok and not rows and lines[0].startswith("WRONG,")


# ---- the profiler hook -----------------------------------------------------

def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    bk, bv, pk = _dense(1_000, 8_000, 1_100, seed=6)
    want = ft.adaptive_join_count(bk, bv, pk, device="cpu")[0]
    monkeypatch.setenv("FHJ_PROFILE_DIR", str(tmp_path))
    count, _ = ft.adaptive_join_count(bk, bv, pk, device="cpu")
    assert count == want == oracle_count(bk, pk)
    traces = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
