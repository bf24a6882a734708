"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's columns from the seed, calls the traffic's public
entry once with return_info=True (the warm-up; its info is the route the
port's planner chose), puts the columns on the device with the public
utils.u64.device_planes, takes the join function of that route from the
public engine.count_graph / engine.materialize_graph, and runs it once on
the resident planes.  The window then calls that function again and
again, one join in flight (a closed loop): each call builds and probes
the whole join, and ends when its count and special[3] are read on the
host.  Once the window has closed, the peak memory is read, the program's
planes are freed, and the reference judges every join's count and
dropped-rows flag and the rows of two of them: one drawn from the seed
among the first KEEP_FROM, and the last.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from hjbench import check
from hjbench.trace import WINDOW_SPAN, from_profiler

KEEP_FROM = 8


def join_fn(mode: str, info: dict):
    """The join function of the route in a public entry's info, from the
    engine's public names; a route they cannot rebuild fails loudly."""
    from flash_hash_join_tpu_torch import engine
    if info["probe_chunks"] != 1 or info["retried"]:
        raise RuntimeError(f"route {info} streams chunks or retried on "
                           "merge; a resident join cannot replay it")
    tier = dict(n_build=info["nb"], use_bloom=info["use_bloom"])
    if mode == "count":
        return engine.count_graph(info["strategy"], info["d_rows"], **tier)
    if info["strategy"] == "direct":
        raise RuntimeError("a direct materialize's value planes are not in "
                           "the public info; the route cannot be rebuilt")
    return engine.materialize_graph(info["strategy"], **tier)


class _Reader:
    """Reads a join's (count, special[3]) on the host.  On a card the two
    numbers are copied into pinned memory behind an event; the host spins
    on its own clock until EXPECT of the last join's time has passed,
    then polls the event every POLL_S, so that its wake-up adds little
    latency and a traced window records few event queries (a 30 s window
    polled from the join's start would record about 1.5 million)."""

    EXPECT = 0.9
    POLL_S = 2e-5

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.expect = 0.0
        if self.cuda:
            self.done = torch.cuda.Event()
            self.host = torch.empty(2, dtype=torch.int64, pin_memory=True)

    def begin(self):
        self.t = time.perf_counter()

    def read(self, out) -> list:
        """(count, special[3]) of a join's outputs."""
        pair = torch.stack([out[0], out[-1][3]])
        if not self.cuda:
            return pair.tolist()
        self.host.copy_(pair, non_blocking=True)
        self.done.record()
        _spin_until(self.t + self.expect)
        while not self.done.query():
            _spin_until(time.perf_counter() + self.POLL_S)
        self.expect = self.EXPECT * (time.perf_counter() - self.t)
        return self.host.tolist()


def _spin_until(t: float) -> None:
    while time.perf_counter() < t:
        pass


def _window(fn, args, seconds: float, keep_at: int, dev, span):
    """The closed loop, the collector off.  Returns (counts, failed, wall
    seconds, kept joins' outputs)."""
    reader = _Reader(dev)
    counts, kept, failed = [], [], 0
    out = None
    gc.collect()
    gc.disable()
    try:
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with span("hjbench.dispatch"):
                    reader.begin()
                    out = fn(*args)
                with span("hjbench.read"):
                    count, bad = reader.read(out)
                counts.append(count)
                failed += bad != 0
                if len(out) == 6 and len(counts) - 1 == keep_at:
                    kept.append((count, *out[1:5]))
            wall = time.perf_counter() - t0
    finally:
        gc.enable()
    if len(out) == 6 and len(counts) - 1 != keep_at:
        kept.append((counts[-1], *out[1:5]))
    return counts, failed, wall, kept


def _nospan(name):
    return contextlib.nullcontext()


def run(cfg: dict, traffic: dict, gen, *, seed: int, seconds: float,
        trace: bool, device, per_layer: dict, t_start: float) -> dict:
    """Measure one cell; returns the result's fields (without the device
    facts the caller adds).  per_layer maps a metric name to its reader;
    t_start is the host clock at the process's start."""
    import flash_hash_join_tpu_torch as fhj
    from flash_hash_join_tpu_torch.utils.u64 import device_planes

    if traffic["loop"] != "closed" or traffic["in_flight"] != 1:
        raise ValueError("the harness drives a closed loop with one join "
                         "in flight")
    dev = torch.device(device)
    mode = traffic["mode"]
    seed = seed % (1 << 64)
    marks = [("start", time.perf_counter() - t_start)]
    bk, bv, pk = gen.make(cfg, traffic["table"], seed)
    nb, npr = bk.size, pk.size
    if dev.type == "cuda":
        # the peak is the program's: from the warm-up call on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("columns", time.perf_counter() - t_start))

    entry = getattr(fhj, traffic["entry"])
    _, _, info = entry(bk, bv, pk, device=dev, return_info=True)
    marks.append(("entry", time.perf_counter() - t_start))
    fn = join_fn(mode, info)
    args = [*device_planes(bk, dev), *device_planes(bv, dev),
            *device_planes(pk, dev), nb, npr]
    fn(*args)[0].item()
    setup_s = time.perf_counter() - t_start
    marks.append(("resident", setup_s))

    keep_at = int(np.random.default_rng(seed).integers(KEEP_FROM))
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            counts, failed, wall, kept = _window(
                fn, args, seconds, keep_at, dev, record_function)
    else:
        counts, failed, wall, kept = _window(fn, args, seconds, keep_at,
                                             dev, _nospan)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del args, fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check.compare(bk, bv, pk, mode, counts, kept, dev,
                           failed=failed)
    result = {"correct": check.verdict(checks), "attempted": len(counts),
              "failed": failed, "info": info, "peak": peak, "checks": checks,
              "setup_marks": marks,
              "reference_s": time.perf_counter() - t_ref}
    if trace:
        b = traffic["bytes"]
        per_join = (nb * b["build_row"] + npr * b["probe_row"]
                    + counts[-1] * b["match"])
        t = from_profiler(prof, len(counts), per_join)
        result["metrics"] = {k: r(t) for k, r in per_layer.items()}
        result["trace"] = {"busy_s": t.busy_s(), "window_s": t.window_s,
                           "breakdown": t.breakdown()}
    else:
        result["metrics"] = {"probe_rows_per_s": len(counts) * npr / wall,
                             "setup_s": setup_s}
    return result
