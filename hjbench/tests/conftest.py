"""Small cells for the harness's CPU tests: the real configuration files
with their row counts cut, the real traffic files."""

from __future__ import annotations

import json
import time

from hjbench import catalog, cell

SMALL = {
    "j1": dict(x_rows=60_000, tables={"small": 10, "medium": 600,
                                      "big": 60_000}),
    "mmhj": dict(build_rows=1 << 12, probe_rows=1 << 16),
    "zipf": dict(build_rows=1 << 14, probe_rows=1 << 16),
}
# cells whose files are in the harness but which BENCHMARK.json does not
# list (PERF.md says why): their configuration, traffic and chips
UNLISTED = {
    "dist-zipf-c5.count": dict(config="dist-zipf-c5", traffic="dist.count",
                               chips=4),
}


def workload(name: str) -> dict:
    """A cell's entry: BENCHMARK.json's, or UNLISTED's."""
    if name in UNLISTED:
        return dict(UNLISTED[name], name=name)
    return catalog.workload(catalog.manifest(), name)


def config(name: str) -> dict:
    """A configuration's file, found by its name."""
    return json.loads((catalog.HERE / "configs" / f"{name}.json").read_text())


def small_cell(name: str):
    """(cfg, traffic, generator) of a cell, rows cut."""
    w = workload(name)
    cfg = config(w["config"])
    cfg = dict(cfg, **SMALL[cfg["generator"]])
    return cfg, catalog.traffic(w["traffic"]), catalog.datagen(cfg["generator"])


def run_small(name: str, *, seed: int = 2**31 + 11, trace: bool = False,
              seconds: float = 0.3) -> dict:
    cfg, traffic, gen = small_cell(name)
    man = catalog.manifest()
    per_layer = ({m["name"]: catalog.reader(m["name"])
                  for m in catalog.metrics_of(man, "per_layer", name)}
                 if trace else {})
    return cell.run(cfg, traffic, gen, seed=seed, seconds=seconds,
                    trace=trace, device="cpu", per_layer=per_layer,
                    t_start=time.perf_counter(),
                    cards=workload(name)["chips"])
