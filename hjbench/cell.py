"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's columns from the seed; the traffic's driver
(drivers/<driver>.py, `resident` where the traffic names none) then does
the rest of the set-up, its warm-up included, and runs the window: a
closed loop, one join in flight.  Once the window has closed, the peak
memory of each of the cell's cards is read, the program's state is
freed, and the reference judges every join's count and failure, and the
rows the driver kept.
"""

from __future__ import annotations

import contextlib
import time

import torch

from hjbench import catalog, check
from hjbench.trace import from_profiler

DEFAULT_DRIVER = "resident"


def _nospan(name):
    return contextlib.nullcontext()


def cards_of(dev: torch.device, cards: int) -> list[torch.device]:
    """The cards a cell uses (the current one first), none on the CPU."""
    if dev.type != "cuda":
        return []
    if cards == 1:
        return [dev]
    return [torch.device("cuda", i) for i in range(cards)]


def run(cfg: dict, traffic: dict, gen, *, seed: int, seconds: float,
        trace: bool, device, per_layer: dict, t_start: float,
        cards: int = 1) -> dict:
    """Measure one cell; returns the result's fields (without the device
    facts the caller adds).  per_layer maps a metric name to its reader;
    t_start is the host clock at the process's start; cards is the cell's
    chips."""
    if traffic["loop"] != "closed" or traffic["in_flight"] != 1:
        raise ValueError("the harness drives a closed loop with one join "
                         "in flight")
    dev = torch.device(device)
    on = cards_of(dev, cards)
    mode = traffic["mode"]
    seed = seed % (1 << 64)
    marks = [("start", time.perf_counter() - t_start)]

    def mark(name):
        marks.append((name, time.perf_counter() - t_start))
    bk, bv, pk = gen.make(cfg, traffic["table"], seed)
    nb, npr = bk.size, pk.size
    if on:
        # the peak is the program's: from the warm-up call on
        torch.cuda.empty_cache()
        for d in on:
            torch.cuda.reset_peak_memory_stats(d)
    mark("columns")

    drv = catalog.driver(traffic.get("driver", DEFAULT_DRIVER)).Driver(
        bk, bv, pk, traffic, dev=dev, cards=cards, seed=seed, mark=mark)
    setup_s = marks[-1][1]

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            counts, attempted, failed, wall = drv.window(seconds,
                                                         record_function)
    else:
        counts, attempted, failed, wall = drv.window(seconds, _nospan)
    peaks = [torch.cuda.max_memory_allocated(d) for d in on]
    kept, facts = drv.kept, drv.facts()
    drv.release()
    del drv
    if on:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check.compare(bk, bv, pk, mode, counts, kept, dev,
                           failed=failed)
    result = {"correct": check.verdict(checks), "attempted": attempted,
              "failed": failed, "facts": facts,
              "peak": max(peaks, default=0), "peaks": peaks,
              "checks": checks, "setup_marks": marks,
              "reference_s": time.perf_counter() - t_ref}
    if trace:
        b = traffic["bytes"]
        per_join = (nb * b["build_row"] + npr * b["probe_row"]
                    + (counts[-1] if counts else 0) * b["match"])
        t = from_profiler(prof, len(counts), per_join, cards=len(on) or 1)
        result["metrics"] = {k: r(t) for k, r in per_layer.items()}
        result["trace"] = {"busy_s": t.mean_busy_s(),
                           "window_s": t.window_s,
                           "breakdown": t.breakdown()}
    else:
        result["metrics"] = {"probe_rows_per_s": len(counts) * npr / wall,
                             "setup_s": setup_s}
    return result
