"""The `resident` driver: joins on columns resident on one card.

Set-up calls the traffic's public entry once with return_info=True (the
warm-up; its info is the route the port's planner chose), puts the
columns on the device with the public utils.u64.device_planes, takes the
join function of that route from the public engine.count_graph /
engine.materialize_graph, and runs it once on the resident planes.  The
window then calls that function again and again, one join in flight (a
closed loop): each call builds and probes the whole join, and ends when
its count and special[3] are read on the host.  A join whose special[3]
says build rows were dropped has failed.  The rows of two materializes
are kept for the check: one drawn from the seed among the first
KEEP_FROM, and the last.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from hjbench.trace import WINDOW_SPAN

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


class Driver:
    """Set-up on construction; window() measures; facts() after it."""

    def __init__(self, bk, bv, pk, traffic: dict, *, dev: torch.device,
                 cards: int, seed: int, mark):
        import flash_hash_join_tpu_torch as fhj
        from flash_hash_join_tpu_torch.utils.u64 import device_planes
        entry = getattr(fhj, traffic["entry"])
        _, _, self.info = entry(bk, bv, pk, device=dev, return_info=True)
        mark("entry")
        self.fn = join_fn(traffic["mode"], self.info)
        self.args = [*device_planes(bk, dev), *device_planes(bv, dev),
                     *device_planes(pk, dev), bk.size, pk.size]
        self.fn(*self.args)[0].item()
        mark("resident")
        self.dev = dev
        self.keep_at = int(np.random.default_rng(seed).integers(KEEP_FROM))
        self.kept = []

    def window(self, seconds: float, span) -> tuple[list, int, int, float]:
        """(counts, joins attempted, failed joins, wall seconds); the kept
        rows in .kept."""
        counts, failed, wall, self.kept = _window(
            self.fn, self.args, seconds, self.keep_at, self.dev, span)
        return counts, len(counts), failed, wall

    def facts(self) -> dict:
        return {"route": self.info["strategy"]}

    def release(self) -> None:
        """Frees the resident planes and the join function."""
        del self.args, self.fn
