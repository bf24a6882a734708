"""The traced window, reduced from torch.profiler's events.

A traced run profiles the window alone (CPU and CUDA activity).  The
window is the harness's `hjbench.window` span; device operations are the
profiler's kernels, memsets and copies on the cell's cards, each with the
index of its card.  A card's busy time is the union of its ops' intervals
inside the window.  An idle gap is a stretch of the window in which no
card runs an op (the union over the cards), named by the innermost host
event of the window's thread at the gap's middle.  On one card every
per-card reading is the whole trace's.  The per-layer readers in metrics/
take their numbers from a `Trace`.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass

SPAN_PREFIX = "hjbench."
WINDOW_SPAN = SPAN_PREFIX + "window"
NAME_CHARS = 160              # a name's length in the breakdown


@dataclass(frozen=True)
class Op:
    name: str
    start: float              # seconds from the window's start
    end: float
    card: int = 0             # the card a device op ran on


@dataclass
class Trace:
    """What the readers see: the device ops of the window in start order
    (on every card), its host events, its bounds, the joins (calls) it
    completed, the bytes the traffic's byte model gives one join, the
    cell's cards."""

    ops: list[Op]
    host: list[Op]
    window: tuple[float, float]
    joins: int
    bytes_per_join: float
    cards: int = 1

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self, card: int | None = None
                       ) -> list[tuple[float, float]]:
        """The merged intervals in which an op ran: on `card`, or on any
        card where card is None."""
        w0, w1 = self.window
        ops = self.ops if card is None else [o for o in self.ops
                                             if o.card == card]
        merged: list[list[float]] = []
        for op in sorted(ops, key=lambda o: o.start):
            s, e = max(op.start, w0), min(op.end, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, card: int | None = None) -> float:
        return sum(e - s for s, e in self.busy_intervals(card))

    def card_busy_s(self) -> list[float]:
        """Each of the cell's cards' busy seconds, in card order."""
        return [self.busy_s(c) for c in range(self.cards)]

    def mean_busy_s(self) -> float:
        """Busy seconds averaged over the cell's cards."""
        return sum(self.card_busy_s()) / self.cards

    def op_seconds(self) -> float:
        """Summed duration of the device ops (a stream's ops do not overlap)."""
        return sum(o.end - o.start for o in self.ops)

    def gaps(self) -> list[tuple[float, float]]:
        """The stretches of the window in which no card runs an op."""
        w0, w1 = self.window
        out, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if w1 > t:
            out.append((t, w1))
        return out

    def seconds_matching(self, patterns, absorb=()) -> float:
        """Summed seconds of the device ops whose name matches one of
        `patterns`, and of each op matching `absorb` whose next op not
        matching `absorb` matches `patterns` (a memset or a shared scan
        kernel counted with the stage it serves)."""
        want = re.compile("|".join(patterns))
        soak = re.compile("|".join(absorb)) if absorb else None
        total, pending = 0.0, 0.0
        for op in self.ops:
            if soak is not None and soak.search(op.name) \
                    and not want.search(op.name):
                pending += op.end - op.start
                continue
            if want.search(op.name):
                total += pending + op.end - op.start
            pending = 0.0
        return total

    def ms_per_join(self, patterns, absorb=()):
        """Milliseconds a join of the matching ops, None when none ran."""
        s = self.seconds_matching(patterns, absorb)
        return s / self.joins * 1e3 if s > 0 and self.joins else None

    def card_ms_per_join(self, patterns):
        """Milliseconds a join of the matching ops, summed over the cards
        and divided by the cell's cards; None when none ran."""
        ms = self.ms_per_join(patterns)
        return ms / self.cards if ms is not None else None

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (summed over the cards), and
        the idle gaps (stretches in which no card is busy) by what the host
        was doing, each summed by name."""
        by_op: dict[str, float] = defaultdict(float)
        for o in self.ops:
            by_op[o.name[:NAME_CHARS]] += o.end - o.start
        by_host: dict[str, float] = defaultdict(float)
        gaps = self.gaps()
        for (g0, g1), name in zip(gaps, self._host_at([(a + b) / 2
                                                        for a, b in gaps])):
            by_host[name[:NAME_CHARS]] += g1 - g0

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}

    def _host_at(self, times: list[float]) -> list[str]:
        """The innermost host event open at each time (times ascending)."""
        events = sorted(self.host, key=lambda o: (o.start, -o.end))
        starts = [o.start for o in events]
        names, stack, i = [], [], 0
        for t in times:
            j = bisect.bisect_right(starts, t)
            while i < j:
                ev = events[i]
                while stack and stack[-1].end <= ev.start:
                    stack.pop()
                stack.append(ev)
                i += 1
            while stack and stack[-1].end < t:
                stack.pop()
            names.append(stack[-1].name if stack else "host, no event")
        return names


def from_profiler(prof, joins: int, bytes_per_join: float,
                  cards: int = 1) -> Trace:
    """A Trace of a finished torch.profiler run over the window.  Device
    ops are the events on the cards but the harness's own spans, which the
    profiler mirrors there, each with its card's index."""
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    on_card = [e.device_type() == DeviceType.CUDA for e in events]
    spans = [e for e, card in zip(events, on_card)
             if not card and e.name() == WINDOW_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"the trace has {len(spans)} {WINDOW_SPAN} spans")
    window = spans[0]
    base, thread = window.start_ns(), window.start_thread_id()

    def op(e, card=0):  # integer ns from the window's start, then seconds
        start = e.start_ns() - base
        return Op(e.name(), start / 1e9, (start + e.duration_ns()) / 1e9,
                  card)
    device = sorted((op(e, e.device_index())
                     for e, card in zip(events, on_card)
                     if card and not e.name().startswith(SPAN_PREFIX)),
                    key=lambda o: o.start)
    host = [op(e) for e, card in zip(events, on_card)
            if not card and e is not window
            and e.start_thread_id() == thread]
    return Trace(ops=device, host=host,
                 window=(0.0, window.duration_ns() / 1e9), joins=joins,
                 bytes_per_join=bytes_per_join, cards=cards)
