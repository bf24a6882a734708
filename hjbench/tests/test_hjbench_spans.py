"""The span readers (hjbench/spans.py, metrics/span.*.py) on synthetic
traces: the program's fhj.* spans and the runtime calls as host events,
the device ops as the profiler names them on the card."""

from __future__ import annotations

import pytest

from hjbench import catalog, spans
from hjbench.trace import Op, Trace

MS = 1e-3
JOIN_AT = 100                   # ms between the joins' starts

# a join's host events, ms from its start: (name, start, end)
SPANS = [("hjbench.dispatch", 0, 10), ("fhj.join", 1, 9),
         ("fhj.direct", 1.5, 2.5),
         ("fhj.partitioned.build", 3, 4), ("fhj.partitioned.probe", 4.1, 4.5),
         ("fhj.global.build", 5, 6), ("fhj.k.global_build", 5.1, 5.9),
         ("fhj.global.walk", 6.1, 7), ("fhj.compact", 7.1, 8),
         ("hjbench.read", 10, 20)]
# its launches, in order: (runtime call, ms, device op, its ms)
LAUNCHES = [("cudaLaunchKernel", 2, "direct_kernel", 2),
            ("cudaMemsetAsync", 3.2, "Memset (Device)", 1),
            ("cudaLaunchKernel", 3.5, "DeviceRadixSortOnesweepKernel", 3),
            ("cudaLaunchKernel", 4.2, "range_probe_kernel", 4),
            ("cudaMemsetAsync", 5.2, "Memset (Device)", 1),
            ("cudaLaunchKernel", 5.5, "finish_kernel", 5),
            ("cudaLaunchKernel", 6.5, "slice_walk_kernel", 6),
            ("cudaMemsetAsync", 7.2, "Memset (Device)", 0.5),
            ("cudaLaunchKernel", 7.5, "compact_kernel", 1.5),
            ("cudaLaunchKernel", 8.5, "CatArrayBatchedCopy", 0.5),
            ("cudaLaunchKernel", 10.5, "CatArrayBatchedCopy", 0.25),
            ("cudaMemcpyAsync", 10.7, "Memcpy DtoH (Device -> Pinned)", 0.25)]
DEVICE_FROM = 2.1               # ms: the first op starts; then back to back
# by hand, ms a join
WANT = {"span.direct.ms": 2, "span.partitioned.build_ms": 4,
        "span.partitioned.probe_ms": 4, "span.global.build_ms": 6,
        "span.global.walk_ms": 6, "span.compact.ms": 2,
        "span.dispatch.host_ms": 8,
        # fhj.join [1, 9] against the device idle until 2.1
        "span.dispatch.idle_ms": 1.1}


def two_joins(spans_on=True, extra_calls=()):
    host, ops = [], []
    for j in range(2):
        base = j * JOIN_AT
        host += [Op(n, (base + a) * MS, (base + b) * MS) for n, a, b in SPANS
                 if spans_on or not n.startswith("fhj.")]
        t = base + DEVICE_FROM
        for call, at, op, dur in LAUNCHES:
            host.append(Op(call, (base + at) * MS, (base + at + 0.01) * MS))
            ops.append(Op(op, t * MS, (t + dur) * MS))
            t += dur
    host += [Op(c, at * MS, (at + 0.01) * MS) for c, at in extra_calls]
    return Trace(ops=ops, host=host, window=(0.0, 2 * JOIN_AT * MS), joins=2,
                 bytes_per_join=1.0)


def read(name, t):
    return catalog.reader(name)(t)


def test_each_reader_on_two_joins():
    t = two_joins()
    for name, want in WANT.items():
        assert read(name, t) == pytest.approx(want), name


def test_the_manifest_lists_every_span_reader():
    names = {m["name"] for m in catalog.manifest()["per_layer"]}
    assert set(WANT) <= names


def test_pairing_by_class_and_innermost_span():
    got = spans.attributed(two_joins())
    by_op = [(op.name, names[-1] if names else None) for op, names in got]
    assert by_op[:len(LAUNCHES)] == [
        ("direct_kernel", "fhj.direct"),
        ("Memset (Device)", "fhj.partitioned.build"),
        ("DeviceRadixSortOnesweepKernel", "fhj.partitioned.build"),
        ("range_probe_kernel", "fhj.partitioned.probe"),
        # the innermost span wins over its parent
        ("Memset (Device)", "fhj.k.global_build"),
        ("finish_kernel", "fhj.k.global_build"),
        ("slice_walk_kernel", "fhj.global.walk"),
        ("Memset (Device)", "fhj.compact"),
        ("compact_kernel", "fhj.compact"),
        # launched in fhj.join after its tiers closed
        ("CatArrayBatchedCopy", "fhj.join"),
        # the harness's stack and read: no span of the program
        ("CatArrayBatchedCopy", None),
        ("Memcpy DtoH (Device -> Pinned)", None)]
    assert got[5][1] == ("fhj.join", "fhj.global.build",
                         "fhj.k.global_build")
    # a layer holds what is nested in it
    assert spans.layer_ms(two_joins(), "fhj.k.global_build") == \
        pytest.approx(6)


def test_memset_with_no_device_op_fails_the_pairing():
    t = two_joins(extra_calls=[("cudaMemsetAsync", 150)])
    assert spans.attributed(t) is None
    for name in WANT:
        assert read(name, t) is None, name
    t = two_joins(extra_calls=[("cudaMemcpyAsync", 150)])
    assert read("span.dispatch.host_ms", t) is None


def test_a_kernel_launched_by_another_call_fails_the_pairing():
    t = two_joins(extra_calls=[("cuLaunchKernel", 150)])
    assert spans.attributed(t) is not None      # it enqueued nothing
    t = Trace(ops=[*t.ops, Op("triton_kernel", 0.151, 0.152)], host=t.host,
              window=t.window, joins=t.joins, bytes_per_join=1.0)
    assert spans.attributed(t) is None


def test_the_calls_that_enqueue_nothing_are_not_paired():
    t = two_joins(extra_calls=[("cudaEventQuery", 150),
                               ("cudaEventRecord", 151),
                               ("cudaStreamSynchronize", 152)])
    assert read("span.compact.ms", t) == pytest.approx(2)


def test_idle_gaps_intersect_the_join_spans():
    t = two_joins()
    gaps = t.gaps()
    assert gaps[0] == pytest.approx((0.0, DEVICE_FROM * MS))
    # the gap between the joins lies outside both fhj.join spans but for
    # the second's first 1.1 ms
    assert spans.dispatch_idle_ms(t) == pytest.approx(1.1)


def test_no_spans_or_no_device_ops_read_nothing():
    parent = two_joins(spans_on=False)          # a program without spans
    cpu = Trace(ops=[], host=[Op("fhj.join", 0.0, 0.5)], window=(0.0, 1.0),
                joins=1, bytes_per_join=1.0)   # a CPU run
    for t in (parent, cpu):
        for name in WANT:
            assert read(name, t) is None, name
