"""Everything a run needs, found by the names in BENCHMARK.json.

A cell names a configuration (configs/<config>.json, the `file` of its
entry; its generator is datagen/<generator>.py) and a traffic mix
(traffic/<traffic>.json, whose driver is drivers/<driver>.py); each
per-layer metric is a reader in metrics/<metric>.py.  A later benchmark
adds a configuration, a mix, a driver or a metric by adding such files
and entries, without editing this one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def manifest(path: Path = MANIFEST) -> dict:
    return json.loads(path.read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config(man: dict, name: str) -> dict:
    return json.loads((ROOT / _named(man["configs"], name, "config")["file"])
                      .read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _load(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind}/{name}.py")
    mod_name = f"hjbench.{kind}." + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def datagen(name: str):
    """The generator module: make(cfg, table, seed) -> (bk, bv, pk)."""
    return _load("datagen", name)


def driver(name: str):
    """A driver module (drivers/<name>.py, a Python identifier), imported
    as hjbench.drivers.<name>: its Driver runs a cell's set-up and window."""
    if not name.isidentifier() or not (HERE / "drivers" /
                                       f"{name}.py").is_file():
        raise KeyError(f"no drivers/{name}.py")
    return importlib.import_module(f"hjbench.drivers.{name}")


def reader(metric: str):
    """A per-layer metric's reader: read(trace) -> value or None."""
    return _load("metrics", metric).read


def metrics_of(man: dict, kind: str, cell: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]
