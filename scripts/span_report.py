#!/usr/bin/env python3
"""What the benchmark's span readers see in one traced window of a cell,
and what a span costs with no profiler running.

    python3 scripts/span_report.py --workload <cell> [--seed N] [--seconds S]
    python3 scripts/span_report.py --cost         # ns a span, no profiler

Runs the cell as `python3 -m hjbench.run --trace 1` does (hjbench/cell.py),
keeps its Trace, and prints one JSON line: the runtime calls and device
ops by class (hjbench/spans.py pairs them), the spans a join by name, the
device time a join by innermost span and by layer (the span readers'
numbers), the device ops launched outside every span by name, the share
of device time given to a span, and every per-layer reader of
BENCHMARK.json on the same trace (the kernel-name readers beside their
span twins).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def span_cost(n: int = 1_000_000) -> dict:
    """ns a `with span(...)` block with no profiler running, against the
    same block over a nullcontext."""
    from flash_hash_join_tpu_torch.utils import spans
    best = {}
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span(spans.JOIN):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            with spans.NONE:
                pass
        t2 = time.perf_counter()
        for k, v in (("span_ns", t1 - t0), ("nullcontext_ns", t2 - t1)):
            best[k] = min(best.get(k, v), v)
    out = {k: v / n * 1e9 for k, v in best.items()}
    out["added_ns"] = out["span_ns"] - out["nullcontext_ns"]
    return out


def report(t) -> dict:
    from hjbench import catalog, spans
    per_join = 1e3 / t.joins
    calls = Counter(h.name for h in t.host if h.name.startswith("cu"))
    classes = Counter(spans.op_class(o.name) for o in t.ops)
    fhj = Counter(h.name for h in t.host if h.name.startswith("fhj."))
    out = {"joins": t.joins, "ops": len(t.ops),
           "runtime_calls": dict(calls.most_common()),
           "device_ops_by_class": dict(classes),
           "spans_a_join": {k: v / t.joins for k, v in fhj.items()}}
    got = spans.attributed(t)
    out["paired"] = got is not None
    if got is not None:
        inner, layer, loose = defaultdict(float), defaultdict(float), \
            defaultdict(float)
        for op, names in got:
            d = op.end - op.start
            if names:
                inner[names[-1]] += d
                for n in set(names):
                    layer[n] += d
            else:
                loose[op.name[:100]] += d
        total = sum(op.end - op.start for op, _ in got)
        out["ms_a_join_innermost"] = {k: v * per_join
                                      for k, v in sorted(inner.items())}
        out["ms_a_join_layer"] = {k: v * per_join
                                  for k, v in sorted(layer.items())}
        out["ms_a_join_unattributed"] = {k: v * per_join
                                         for k, v in loose.items()}
        out["attributed_share"] = 1 - sum(loose.values()) / total
    man = catalog.manifest()
    out["readers"] = {m["name"]: catalog.reader(m["name"])(t)
                      for m in man["per_layer"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--cost", action="store_true")
    a = ap.parse_args(argv)
    if a.cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("span_report.py needs a CUDA card", file=sys.stderr)
        return 2
    from hjbench import catalog
    from hjbench import cell as cell_run
    man = catalog.manifest()
    w = catalog.workload(man, a.workload)
    cfg = catalog.config(man, w["config"])
    kept = []
    res = cell_run.run(
        cfg, catalog.traffic(w["traffic"]), catalog.datagen(cfg["generator"]),
        seed=a.seed, seconds=a.seconds, trace=True, device="cuda",
        per_layer={"trace": kept.append}, t_start=time.perf_counter())
    line = {"workload": a.workload, "seed": a.seed,
            "correct": res["correct"], "torch": torch.__version__,
            "card": torch.cuda.get_device_name(0), **report(kept[0])}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
