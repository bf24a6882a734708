"""BENCHMARK.json against its contract's shape, and every configuration,
traffic mix and metric found by name."""

from __future__ import annotations

import json
import re
import textwrap

from hjbench import catalog

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_characters():
    man = catalog.manifest()
    assert set(man) == KEYS["top"]
    assert len(catalog.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["paths"]) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p for p in man["paths"])
    assert len(man["command"]) <= 32 and all(line(w) for w in man["command"])
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
                else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e and kind != "end_to_end":
                    assert line(e[k]), (e["name"], k)
    assert len(names) == len(set(names))
    for c in man["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in man["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) \
        == len(man["workloads"])


def test_metrics_and_bounds():
    man = catalog.manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in man["workloads"]}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert m["moves"] in [x["name"] for x in
                                  catalog.metrics_of(man, "end_to_end", c)]
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        got = {m["name"] for m in catalog.metrics_of(man, "end_to_end", c)}
        assert "setup_s" in got and len(got) >= 2
        assert catalog.metrics_of(man, "per_layer", c)


def test_every_name_found():
    man = catalog.manifest()
    for c in man["configs"]:
        cfg = catalog.config(man, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert callable(catalog.datagen(cfg["generator"]).make)
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        t = catalog.traffic(w["traffic"])
        assert t["mode"] in ("count", "materialize")
    for m in man["per_layer"]:
        assert callable(catalog.reader(m["name"]))


def test_added_files_are_found(tmp_path, monkeypatch):
    """A later benchmark adds a configuration, a mix and a metric as files
    and entries: the catalog finds them without an edit."""
    for d in ("configs", "traffic", "metrics", "datagen"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "new-cfg.json").write_text(json.dumps(
        {"name": "new-cfg", "generator": "newgen", "reduced": []}))
    (tmp_path / "traffic" / "new.mix.json").write_text(json.dumps(
        {"entry": "hash_join_count", "mode": "count"}))
    (tmp_path / "datagen" / "newgen.py").write_text(
        "def make(cfg, table, seed):\n    return 'made'\n")
    (tmp_path / "metrics" / "new.layer_ms.py").write_text(textwrap.dedent("""
        def read(t):
            return 1.5
    """))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "new-cfg", "file": "configs/new-cfg.json"}],
        "workloads": [{"name": "new-cfg.new.mix", "config": "new-cfg",
                       "traffic": "new.mix"}],
        "end_to_end": [], "per_layer": []}))
    monkeypatch.setattr(catalog, "HERE", tmp_path)
    monkeypatch.setattr(catalog, "ROOT", tmp_path)
    man = catalog.manifest(tmp_path / "BENCHMARK.json")
    w = catalog.workload(man, "new-cfg.new.mix")
    cfg = catalog.config(man, w["config"])
    assert catalog.datagen(cfg["generator"]).make(cfg, None, 1) == "made"
    assert catalog.traffic(w["traffic"])["entry"] == "hash_join_count"
    assert catalog.reader("new.layer_ms")(None) == 1.5


def test_unlisted_cell_files_are_whole():
    """dist-zipf-c5.count is out of BENCHMARK.json (PERF.md says why); its
    files stay whole, so that a later benchmark adds it by entries alone:
    the configuration and its cut, the traffic and its driver, the three
    dist.* readers."""
    from hjbench.tests.conftest import UNLISTED, config
    for name, w in UNLISTED.items():
        cfg = config(w["config"])
        assert cfg["name"] == w["config"] and line(cfg["source"])
        assert callable(catalog.datagen(cfg["generator"]).make)
        assert set(cfg["reduced"]) == set(cfg["published"])
        assert all(cfg[k] != cfg["published"][k] for k in cfg["reduced"])
        assert cfg["chips"] == w["chips"]
        t = catalog.traffic(w["traffic"])
        assert callable(catalog.driver(t["driver"]).Driver)
    for m in ("dist.h2d_ms", "dist.exchange_ms", "dist.kernels_ms"):
        assert callable(catalog.reader(m))
