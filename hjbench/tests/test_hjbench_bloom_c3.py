"""The bloom-filtered selective join, bloom-c3.count-bloom, on the CPU at
small sizes of its own: the generator's draws, a clean run judged correct
against the reference, broken paths judged not correct, and its two
readers (None on the CPU, their arithmetic on a made-up trace)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from hjbench import catalog, cell
from hjbench.drivers import resident
from hjbench.peaks import HBM_BYTES_PER_S
from hjbench.spans import JOIN
from hjbench.trace import Op, Trace

NAME = "bloom-c3.count-bloom"
SMALL = dict(build_rows=1 << 12, probe_rows=1 << 16)
SEED = 2**40 + 17
MS = 1e-3


def small_cfg(**kw) -> dict:
    man = catalog.manifest()
    return dict(catalog.config(man, catalog.workload(man, NAME)["config"]),
                **SMALL, **kw)


def run_small(trace: bool = False, seed: int = SEED) -> dict:
    man = catalog.manifest()
    w = catalog.workload(man, NAME)
    cfg = small_cfg()
    per_layer = ({m["name"]: catalog.reader(m["name"])
                  for m in catalog.metrics_of(man, "per_layer", NAME)}
                 if trace else {})
    return cell.run(cfg, catalog.traffic(w["traffic"]),
                    catalog.datagen(cfg["generator"]), seed=seed,
                    seconds=0.3, trace=trace, device="cpu",
                    per_layer=per_layer, t_start=time.perf_counter(),
                    cards=w["chips"])


def test_the_cell_and_its_files():
    man = catalog.manifest()
    w = catalog.workload(man, NAME)
    cfg = catalog.config(man, w["config"])
    assert w["chips"] == 1 and cfg["reduced"] == []
    assert (cfg["build_rows"], cfg["probe_rows"], cfg["match_share"],
            cfg["key_bits"]) == (10**7, 10**9, 0.05, 62)
    t = catalog.traffic(w["traffic"])
    assert (t["entry"], t["mode"], t["table"]) == ("hash_join_count_bloom",
                                                   "count", None)
    assert "driver" not in t          # the resident driver
    assert t["bytes"] == {"build_row": 8, "probe_row": 8, "match": 0}
    layer = {m["name"]: m for m in catalog.metrics_of(man, "per_layer", NAME)}
    assert {"span.global.prune_ms", "global.prune.roofline"} <= set(layer)


@pytest.mark.parametrize("piece", [None, 1000])
def test_generator_draws(piece, monkeypatch):
    gen = catalog.datagen("selective")
    if piece is not None:            # many pieces, a hit list cut in each
        monkeypatch.setattr(gen, "PIECE", piece)
    cfg = small_cfg()
    bk, bv, pk = gen.make(cfg, None, SEED)
    assert bk.dtype == bv.dtype == pk.dtype == np.uint64
    assert (bk.size, bv.size, pk.size) == (SMALL["build_rows"],
                                           SMALL["build_rows"],
                                           SMALL["probe_rows"])
    assert (bk < 2**62).all() and (bv < 2**63).all() and (pk < 2**62).all()
    hit = np.isin(pk, bk)
    assert hit.sum() == round(pk.size * cfg["match_share"])   # exactly 5 %
    # the hits spread over the probe side, the misses absent from the build
    quarters = hit.reshape(4, -1).sum(1)
    assert quarters.min() > 0.6 * quarters.mean()
    assert np.unique(pk[~hit]).size > 0.99 * (~hit).sum()
    again = gen.make(cfg, None, SEED)
    for a, b in zip((bk, bv, pk), again):
        np.testing.assert_array_equal(a, b)
    other = gen.make(cfg, None, SEED + 1)
    assert not np.array_equal(pk, other[2])


def test_generator_refuses_tables_and_wide_keys():
    gen = catalog.datagen("selective")
    with pytest.raises(ValueError):
        gen.make(small_cfg(), "big", 1)
    with pytest.raises(ValueError):
        gen.make(small_cfg(key_bits=63), None, 1)


def test_clean_run_is_correct():
    res = run_small()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"] == {"count_gap": 0, "failed_joins": 0}
    assert res["facts"] == {"route": "global"}
    m = res["metrics"]
    assert set(m) == {"probe_rows_per_s", "setup_s"}
    assert m["probe_rows_per_s"] > 0 and m["setup_s"] > 0


def test_the_window_runs_the_bloom_prune(monkeypatch):
    seen = []
    real = resident.join_fn

    def join_fn(mode, info):
        seen.append(info)
        return real(mode, info)
    monkeypatch.setattr(resident, "join_fn", join_fn)
    from flash_hash_join_tpu_torch.utils import spans
    before = spans.counts()[spans.GLOBAL_PRUNE]
    res = run_small()
    assert res["correct"]
    assert seen[0]["strategy"] == "global" and seen[0]["use_bloom"]
    # the warm-up, the resident join and each of the window's joins
    assert spans.counts()[spans.GLOBAL_PRUNE] - before >= 2 + res["attempted"]


def _count_off_by_one(fn):
    def broken(*a):
        count, special = fn(*a)
        return count + 1, special
    return broken


def _bloom_off(fn):
    """Every probe row a hit: a bloom that passed all and a walk that
    matched all."""
    def broken(*a):
        count, special = fn(*a)
        return torch.full_like(count, a[7]), special
    return broken


def _rows_dropped(fn):
    def broken(*a):
        count, special = fn(*a)
        special = special.clone()
        special[3] = 1
        return count, special
    return broken


@pytest.mark.parametrize("fault", [_count_off_by_one, _bloom_off,
                                   _rows_dropped],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_path_is_not_correct(fault, monkeypatch):
    real = resident.join_fn
    monkeypatch.setattr(resident, "join_fn",
                        lambda mode, info: fault(real(mode, info)))
    res = run_small()
    assert not res["correct"], res["checks"]


def test_traced_run_on_cpu_reads_none():
    res = run_small(trace=True)
    assert res["correct"]
    # device.idle_share lists no cells: every cell reports it
    assert set(res["metrics"]) == {"span.global.prune_ms",
                                   "global.prune.roofline",
                                   "device.idle_share"}
    assert all(v is None for v in res["metrics"].values())


def _cell_bytes() -> float:
    """bloom-c3.count-bloom's bytes a join, as the harness traces them."""
    cfg = catalog.config(catalog.manifest(), "bloom-c3")
    return 8.0 * (cfg["build_rows"] + cfg["probe_rows"])


def _pruned_joins(bytes_per_join: float | None = None) -> Trace:
    """Two joins, each: a memset and prune_kernel launched in
    fhj.global.prune (4 ms), then a walk kernel in fhj.global.walk; by
    default at bloom-c3.count-bloom's bytes a join."""
    host, ops = [], []
    for j in range(2):
        t0 = j * 20
        host += [Op(JOIN, t0 * MS, (t0 + 15) * MS),
                 Op("fhj.global.walk", (t0 + 1) * MS, (t0 + 14) * MS),
                 Op("fhj.global.prune", (t0 + 1) * MS, (t0 + 3) * MS),
                 Op("cudaMemsetAsync", (t0 + 1.5) * MS, (t0 + 1.6) * MS),
                 Op("cudaLaunchKernel", (t0 + 2) * MS, (t0 + 2.1) * MS),
                 Op("cudaLaunchKernel", (t0 + 5) * MS, (t0 + 5.1) * MS)]
        ops += [Op("Memset (Device)", (t0 + 2) * MS, (t0 + 2.5) * MS),
                Op("void (anonymous namespace)::prune_kernel(Prune)",
                   (t0 + 3) * MS, (t0 + 7) * MS),
                Op("void (anonymous namespace)::slice_walk_kernel<8, "
                   "false, 2>(Walk)", (t0 + 7) * MS, (t0 + 9) * MS)]
    return Trace(ops=ops, host=host, window=(0.0, 40 * MS), joins=2,
                 bytes_per_join=_cell_bytes() if bytes_per_join is None
                 else bytes_per_join)


def test_readers_on_a_made_up_trace():
    t = _pruned_joins()
    # the memset and the kernel: 0.5 + 4 ms a join; the walk kernel not
    assert catalog.reader("span.global.prune_ms")(t) == pytest.approx(4.5)
    roof = catalog.reader("global.prune.roofline")(t)
    cfg = catalog.config(catalog.manifest(), "bloom-c3")
    want = 100 * 8 * cfg["probe_rows"] / HBM_BYTES_PER_S / 4e-3
    assert roof == pytest.approx(want) and 0 < roof < 100
    empty = Trace(ops=[], host=[], window=(0.0, 1.0), joins=2,
                  bytes_per_join=1.0)
    for name in ("span.global.prune_ms", "global.prune.roofline"):
        assert catalog.reader(name)(empty) is None


def test_prune_roofline_refuses_another_cells_trace():
    """The roofline's bytes are bloom-c3's: a trace at another cell's bytes
    a join raises rather than report its time against them."""
    with pytest.raises(ValueError, match="bloom-c3.count-bloom alone"):
        catalog.reader("global.prune.roofline")(_pruned_joins(8.0e8))
    assert catalog.reader("span.global.prune_ms")(
        _pruned_joins(8.0e8)) == pytest.approx(4.5)
