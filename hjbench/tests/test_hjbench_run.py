"""Runs of the harness on the CPU at small sizes: a clean run is correct,
a run with the timed path broken underneath is not; the traced run's
readers; the process's exits; no module of JAX or the JAX package."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hjbench import catalog, run
from hjbench.drivers import resident
from hjbench.tests.conftest import run_small

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESIDENT = ["j1-1e8.q5.count", "mmhj-a.hash-join", "j1-1e8.q5.join"]
DIST = "dist-zipf-c5.count"
CELLS = RESIDENT + [DIST]


@pytest.mark.parametrize("name", CELLS)
def test_clean_run_is_correct(name):
    res = run_small(name)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == ({"count_gap", "failed_joins"}
                                  if name.endswith("count") else
                                  {"count_gap", "rows_wrong", "failed_joins"})
    m = res["metrics"]
    assert set(m) == {"probe_rows_per_s", "setup_s"}
    assert m["probe_rows_per_s"] > 0 and m["setup_s"] > 0


def _half_batch(fn):
    """Half of the probe rows left out."""
    return lambda *a: fn(*a[:7], a[7] // 2)


def _answer_altered(fn):
    """The count, and for a materialize one output value, altered where
    they are produced."""
    def broken(*a):
        out = list(fn(*a))
        out[0] = out[0] + 1
        if len(out) == 6:
            out[3] = out[3].clone()
            out[3][0] ^= 1
        return tuple(out)
    return broken


def _nothing_done(fn):
    """Returns its outputs untouched: a count of 0 and zeroed planes."""
    def broken(*a):
        out = fn(*a)
        return (torch.zeros_like(out[0]),
                *(torch.zeros_like(o) for o in out[1:-1]), out[-1])
    return broken


def _value_altered_only(fn):
    """One output value altered, the count left right (materialize)."""
    def broken(*a):
        out = list(fn(*a))
        if len(out) == 6:
            out[4] = out[4].clone()
            out[4][out[0] // 2] ^= 1 << 7
        return tuple(out)
    return broken


def _rows_dropped(fn):
    """Right answers, but special[3] says build rows were dropped: the
    engine's callers must rerun such a join on merge."""
    def broken(*a):
        out = list(fn(*a))
        out[-1] = out[-1].clone()
        out[-1][3] = 1
        return tuple(out)
    return broken


FAULTS = [(name, fault) for name in RESIDENT
          for fault in (_half_batch, _answer_altered, _nothing_done,
                        _value_altered_only, _rows_dropped)
          if not (fault is _value_altered_only and name.endswith("count"))]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    real = resident.join_fn
    monkeypatch.setattr(resident, "join_fn",
                        lambda mode, info: fault(real(mode, info)))
    res = run_small(name)
    assert not res["correct"], res["checks"]


def test_distributed_run_on_a_four_rank_cpu_mesh():
    """The four-card cell on four CPU ranks of one in-process mesh: the
    public call's count, judged against the reference, with its facts."""
    res = run_small(DIST)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    f = res["facts"]
    assert f["route"] == "distributed" and f["ranks"] == 4
    assert f["hot_keys"] >= 1 and f["reruns"] == 0 and f["overflow"] == 0
    assert set(f["stages_median_s"]) == {"split_h2d", "hot_keys",
                                         "build_exchange", "build", "probe",
                                         "finish"}


def _dj():
    from flash_hash_join_tpu_torch.parallel import distributed_join
    return distributed_join


def _dist_half_batch(monkeypatch):
    """Half of each rank's probe rows left out."""
    real = _dj().shard_columns

    def shard(mesh, arrays):
        return [s[:4] + [p[:p.numel() // 2] for p in s[4:]]
                for s in real(mesh, arrays)]
    monkeypatch.setattr(_dj(), "shard_columns", shard)


def _dist_no_exchange(monkeypatch):
    """The exchange between the ranks left out: a rank keeps the rows it
    would send to itself and receives no other rank's."""
    from flash_hash_join_tpu_torch.parallel.mesh import Mesh
    real = Mesh.all_to_all

    def local(self, sends, send_splits, recv_splits):
        keep, splits = [], []
        for s, (t, sp) in enumerate(zip(sends, send_splits)):
            a = sum(sp[:s])
            keep.append(t[a:a + sp[s]])
            splits.append([sp[s] if d == s else 0 for d in range(len(sp))])
        return real(self, keep, splits, recv_splits)
    monkeypatch.setattr(Mesh, "all_to_all", local)


def _dist_count_altered(monkeypatch):
    """A rank's count altered where it is produced."""
    real = _dj()._LocalJoin.finish

    def finish(self):
        count, planes = real(self)
        return count + 1, planes
    monkeypatch.setattr(_dj()._LocalJoin, "finish", finish)


def _dist_nothing_done(monkeypatch):
    """Every rank returns its state untouched: a count of 0."""
    monkeypatch.setattr(_dj()._LocalJoin, "finish",
                        lambda self: (torch.zeros((), dtype=torch.int64),
                                      None))


def _dist_call_raises(monkeypatch):
    """The public call raises: no count comes back."""
    def boom(*a, **k):
        raise RuntimeError("a rank was lost")
    monkeypatch.setattr(_dj(), "distributed_join_exact", boom)


DIST_FAULTS = [_dist_half_batch, _dist_no_exchange, _dist_count_altered,
               _dist_nothing_done, _dist_call_raises]


@pytest.mark.parametrize("fault", DIST_FAULTS,
                         ids=[f.__name__.strip("_") for f in DIST_FAULTS])
def test_broken_distributed_path_is_not_correct(fault, monkeypatch):
    """Each fault set up after the warm-up, so that it breaks the window's
    calls alone, under the public call."""
    from hjbench.drivers import api
    real_init = api.Driver.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        fault(monkeypatch)
    monkeypatch.setattr(api.Driver, "__init__", init)
    res = run_small(DIST)
    assert not res["correct"], res["checks"]


def test_a_traffic_file_without_driver_runs_resident(monkeypatch):
    """q5.count names no driver: the resident driver runs it."""
    assert "driver" not in catalog.traffic("q5.count")
    used = []
    real = resident.Driver.__init__

    def init(self, *a, **k):
        used.append(a[3]["entry"])
        real(self, *a, **k)
    monkeypatch.setattr(resident.Driver, "__init__", init)
    res = run_small("j1-1e8.q5.count")
    assert used == ["adaptive_join_count"] and res["correct"]
    assert res["facts"] == {"route": "direct"}
    with pytest.raises(KeyError):
        catalog.driver("no_such_driver")
    with pytest.raises(KeyError):
        catalog.driver("../cell")


def test_unrebuildable_routes_fail_loudly():
    info = dict(strategy="partitioned", d_rows=0, nb=10, use_bloom=False,
                probe_chunks=2, retried=False)
    with pytest.raises(RuntimeError):
        resident.join_fn("count", info)
    with pytest.raises(RuntimeError):
        resident.join_fn("count", dict(info, probe_chunks=1, retried=True))
    with pytest.raises(RuntimeError):
        resident.join_fn("materialize", dict(info, probe_chunks=1,
                                             strategy="direct"))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_cpu(name):
    """No device op runs on the CPU, so every reader finds nothing and
    returns None; the window and the check are as untraced."""
    res = run_small(name, trace=True)
    assert res["correct"]
    assert res["metrics"] and all(v is None for v in res["metrics"].values())
    assert res["trace"]["busy_s"] == 0 and res["trace"]["window_s"] > 0


def test_forbidden_modules_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "flash_hash_join_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flash_hash_join_tpu.api", sys)
    assert run.forbidden_modules() == ["flash_hash_join_tpu"]


def test_a_run_imports_no_jax():
    """The modules a run imports, in a fresh process: every cell run on
    the CPU, traced, then sys.modules by whole top-level name."""
    code = (
        "import sys; from hjbench.tests.conftest import run_small\n"
        "from hjbench import run\n"
        f"for c in {CELLS!r}:\n"
        "    run_small(c, trace=True, seconds=0.1)\n"
        "assert 'flash_hash_join_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=300,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_exits_without_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "hjbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, timeout=120, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    """A directory holding only BENCHMARK.json and the harness has no
    program to measure: a run fails before any result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "hjbench"), tmp_path / "hjbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import time; from hjbench import catalog, cell\n"
            "man = catalog.manifest(); cfg = catalog.config(man, 'j1-1e8')\n"
            "cell.run(cfg, catalog.traffic('q5.count'), "
            "catalog.datagen('j1'), seed=1, seconds=0.1, trace=False, "
            "device='cpu', per_layer={}, t_start=time.perf_counter())\n"
            "print('result')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         timeout=120, capture_output=True, text=True, env=env)
    assert out.returncode != 0 and "result" not in out.stdout
    assert "flash_hash_join_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_cell_on_card():
    """One short run of the first cell on a card: the result line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "hjbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, timeout=600, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert 0 < res["metrics"]["kernels.roofline"]["value"] <= 100
