"""The traced window's device ops given to the program's spans, for the
readers metrics/span.*.py.

The program (flash_hash_join_tpu_torch/utils/spans.py) records its spans,
named fhj.*, as host events while the profiler runs; they nest, one
thread's at a time.  The window's host events (Trace.host, the window's
thread) also hold the CUDA runtime calls that enqueued every device op.
Each cell runs one stream, so the k-th call of a class enqueued the k-th
device op of that class, over the whole profile in start order.  The
classes: kernel launches and kernels; memsets (cudaMemsetAsync) and
`Memset` ops; copies (cudaMemcpyAsync) and `Memcpy` ops.  A device op is
given to the spans open at its call's start, the innermost last; an op
enqueued outside every fhj.* span (the harness's stack and read of a
join's count) is given to none.  No kernel name is read.

Every span metric is None where any class's calls and device ops differ
in number: a call that enqueued no op (a memset of zero bytes), an op
enqueued from another thread or stream, or a record the profiler lost,
and the pairing can no longer be trusted.  Every span metric is None, too,
where the window ran no device op (a CPU run) or has no fhj.join span (a
program without spans).
"""

from __future__ import annotations

import bisect
from operator import attrgetter, itemgetter

SPAN_PREFIX = "fhj."
JOIN = "fhj.join"

# the runtime calls that enqueue a device op, by class: those a card trace
# of each cell names (torch 2.11, CUDA 12.8, the kernels' library too).
# The other calls there enqueue nothing: cudaEventQuery,
# cudaEventRecordWithFlags, cudaDeviceGetAttribute, cudaFuncSetAttribute,
# cudaOccupancyMaxActiveBlocksPerMultiprocessorWithFlags,
# cudaStreamIsCapturing, cudaPeekAtLastError, cudaMalloc, cudaHostAlloc,
# cudaDeviceSynchronize.  A kernel a call of another name launches
# outnumbers the listed calls: the pairing fails.
CALLS = {"cudaLaunchKernel": "kernel", "cudaMemsetAsync": "memset",
         "cudaMemcpyAsync": "memcpy"}


def op_class(name: str) -> str:
    """The class of a device op, by the profiler's name for it."""
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        return "memcpy"
    return "kernel"


def _stacks_at(spans, times) -> list[tuple[str, ...]]:
    """The names of the spans open at each time (times ascending), the
    outermost first; spans nest."""
    spans = sorted(spans, key=lambda s: (s.start, -s.end))
    starts = [s.start for s in spans]
    out, stack, i = [], [], 0
    for t in times:
        j = bisect.bisect_right(starts, t)
        while i < j:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(tuple(s.name for s in stack))
    return out


def joins(t) -> list:
    """The fhj.join spans of the window."""
    return [h for h in t.host if h.name == JOIN]


START = attrgetter("start")


def attributed(t):
    """[(op, names of the spans open at its launch, outermost first)] for
    every device op, or None where the pairing fails or there is nothing
    to attribute (the module's docstring)."""
    if not t.ops or not joins(t):
        return None
    calls: dict[str, list] = {c: [] for c in set(CALLS.values())}
    for h in t.host:
        c = CALLS.get(h.name)
        if c is not None:
            calls[c].append(h)
    ops: dict[str, list] = {c: [] for c in calls}
    for o in t.ops:
        ops[op_class(o.name)].append(o)
    if any(len(calls[c]) != len(ops[c]) for c in calls):
        return None
    pairs = sorted(((launch.start, op) for c in calls
                    for launch, op in zip(sorted(calls[c], key=START),
                                          sorted(ops[c], key=START))),
                   key=itemgetter(0))
    fhj = [h for h in t.host if h.name.startswith(SPAN_PREFIX)]
    stacks = _stacks_at(fhj, [s for s, _ in pairs])
    return [(op, st) for (_, op), st in zip(pairs, stacks)]


def layer_ms(t, span: str):
    """Milliseconds a join of the device ops launched inside `span`, or a
    span nested in it; None where nothing was attributed to it."""
    ops = attributed(t)
    if ops is None or not t.joins:
        return None
    s = sum(op.end - op.start for op, names in ops if span in names)
    return s / t.joins * 1e3 if s > 0 else None


def dispatch_host_ms(t):
    """Milliseconds a join of the fhj.join spans' host time."""
    if attributed(t) is None or not t.joins:
        return None
    return sum(j.end - j.start for j in joins(t)) / t.joins * 1e3


def dispatch_idle_ms(t):
    """Milliseconds a join in which no device op ran while an fhj.join
    span was open: the window's idle gaps intersected with those spans."""
    if attributed(t) is None or not t.joins:
        return None
    spans = sorted((j.start, j.end) for j in joins(t))
    idle, i = 0.0, 0
    for g0, g1 in t.gaps():
        while i < len(spans) and spans[i][1] <= g0:
            i += 1
        k = i
        while k < len(spans) and spans[k][0] < g1:
            idle += max(0.0, min(g1, spans[k][1]) - max(g0, spans[k][0]))
            k += 1
    return idle / t.joins * 1e3
