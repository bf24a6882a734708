"""Run one cell of BENCHMARK.json once and print its result.

    python3 -m hjbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last the numbers
compared, each beside its limit (also the last lines of standard error).
Between them, facts and not metrics: the route and the driver's other
facts, the peak memory of each of the cell's cards (memory_peak_bytes is
the largest), the set-up's marks, the reference's seconds, the card.
Exits 2 without a result where the cell's cards are missing, 3 where a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flash_hash_join_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name
    (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from hjbench import catalog
    man = catalog.manifest()
    cell = catalog.workload(man, a.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from hjbench import cell as cell_run
    from hjbench.check import LIMITS
    kind = "per_layer" if a.trace else "end_to_end"
    metrics = catalog.metrics_of(man, kind, a.workload)
    cfg = catalog.config(man, cell["config"])
    res = cell_run.run(
        cfg, catalog.traffic(cell["traffic"]), catalog.datagen(cfg["generator"]),
        seed=a.seed, seconds=a.seconds, trace=bool(a.trace), device="cuda",
        per_layer={m["name"]: catalog.reader(m["name"])
                   for m in metrics} if a.trace else {},
        t_start=T_START, cards=cell["chips"])

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = {
        "correct": res["correct"], "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": {m["name"]: {"value": res["metrics"][m["name"]],
                                "unit": m["unit"]}
                    for m in metrics
                    if res["metrics"].get(m["name"]) is not None},
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"],
                   "memory_peak_bytes": res["peak"]},
    }
    if a.trace:
        line["device"].update(busy_s=res["trace"]["busy_s"],
                              window_s=res["trace"]["window_s"])
        line["breakdown"] = res["trace"]["breakdown"]
    line.update(res["facts"])
    line["memory_peak_bytes_per_card"] = res["peaks"]
    line["setup_marks"] = res["setup_marks"]
    line["reference_s"] = res["reference_s"]
    line["card"] = power_limit()
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                      for k, v in res["checks"].items()}
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
