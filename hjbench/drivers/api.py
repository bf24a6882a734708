"""The `api` driver: the program's public call on numpy columns.

Set-up makes the call WARMUP_CALLS times.  The window then calls it
again and again, one call in flight (a closed loop); a call ends when
the public call returns its count on the host, so each call pays the
host's split, the copies to the cards and the read-back as a user's call
does.  A traffic file with `"distributed": true` names a distributed
entry: the driver passes n_devices = the cell's cards (one in-process
mesh, a rank a card).  `kwargs` are passed to the call as they stand.  A
call that raises or returns no count has failed; a rank's rerun on merge
is the program's contract and no failure.  The driver judges counts
only: it keeps no rows.
"""

from __future__ import annotations

import functools
import gc
import statistics
import sys
import time
import traceback

import torch

from hjbench.trace import WINDOW_SPAN

# the call after the first still ran 40-50 % slower than the rest on four
# H100s (dist-zipf-c5.count, PERF.md): set-up makes both
WARMUP_CALLS = 2
# the facts of the last call the result line carries, where its info has them
LAST_FACTS = ("ranks", "hot_keys", "reruns", "overflow")


class Driver:
    """Set-up on construction; window() measures; facts() after it."""

    def __init__(self, bk, bv, pk, traffic: dict, *, dev: torch.device,
                 cards: int, seed: int, mark):
        import flash_hash_join_tpu_torch as fhj
        if traffic["mode"] != "count":
            raise ValueError("the api driver judges counts only")
        kwargs = dict(traffic.get("kwargs", {}), device=dev,
                      return_info=True)
        self.distributed = traffic.get("distributed", False)
        if self.distributed:
            kwargs["n_devices"] = cards
        self.call = functools.partial(getattr(fhj, traffic["entry"]),
                                      bk, bv, pk, **kwargs)
        for i in range(WARMUP_CALLS):
            count, _, _ = self.call()
            if not isinstance(count, int):
                raise RuntimeError(f"the warm-up call returned {count!r}")
            mark(f"warm-up {i + 1}")
        self.kept, self.infos, self.call_s = [], [], []

    def window(self, seconds: float, span) -> tuple[list, int, int, float]:
        """The closed loop, the collector off: (counts, calls attempted,
        failed calls, wall seconds)."""
        counts, failed = [], 0
        gc.collect()
        gc.disable()
        try:
            with span(WINDOW_SPAN):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    t = time.perf_counter()
                    with span("hjbench.call"):
                        try:
                            count, _, info = self.call()
                        except Exception:   # counted; the loop goes on
                            if not failed:
                                traceback.print_exc(file=sys.stderr)
                            failed += 1
                            continue
                    self.call_s.append(time.perf_counter() - t)
                    if not isinstance(count, int):
                        failed += 1
                        continue
                    counts.append(count)
                    self.infos.append(info)
                wall = time.perf_counter() - t0
        finally:
            gc.enable()
        return counts, len(counts) + failed, failed, wall

    def facts(self) -> dict:
        """The route; the median of each of the program's stages over the
        window's calls and the last call's ranks, hot keys, reruns and
        overflow; each call's wall seconds, in order."""
        out = {"route": ("distributed" if self.distributed
                         else self.infos[-1]["strategy"]
                         if self.infos else None)}
        stages = [i["stages"] for i in self.infos if "stages" in i]
        if stages:
            out["stages_median_s"] = {k: statistics.median(s[k]
                                                           for s in stages)
                                      for k in stages[0]}
        if self.infos:
            out.update({k: self.infos[-1][k] for k in LAST_FACTS
                        if k in self.infos[-1]})
        if self.call_s:
            out["call_s"] = self.call_s
        return out

    def release(self) -> None:
        self.call = None
