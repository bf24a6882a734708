"""The reduction of a traced window, and each per-layer reader, on
synthetic device ops named as the profiler names them on the card."""

from __future__ import annotations

import pytest

from hjbench import catalog
from hjbench.peaks import HBM_BYTES_PER_S
from hjbench.trace import Op, Trace

BUILD = ["Memset (Device)", "Memset (Device)",
         "void (anonymous namespace)::hist_kernel<(anonymous namespace)::"
         "BuildRecords, true>((anonymous namespace)::Level)",
         "(anonymous namespace)::scan_kernel((anonymous namespace)::Scan)",
         "void (anonymous namespace)::scatter_kernel<(anonymous namespace)::"
         "BuildRecords, true>((anonymous namespace)::Level)",
         "(anonymous namespace)::finish_kernel((anonymous namespace)::Finish)"]
WALK = ["Memset (Device)",
        "void (anonymous namespace)::hist_kernel<(anonymous namespace)::"
        "ProbeRecords, true>((anonymous namespace)::Level)",
        "(anonymous namespace)::scan_kernel((anonymous namespace)::Scan)",
        "void (anonymous namespace)::scatter_kernel<(anonymous namespace)::"
        "ProbeRecords, true>((anonymous namespace)::Level)",
        "void (anonymous namespace)::slice_walk_kernel<8, true, 2>"
        "((anonymous namespace)::Walk)",
        "(anonymous namespace)::restore_kernel((anonymous namespace)::Restore)"]
COMPACT = ["Memset (Device)",
           "(anonymous namespace)::compact_kernel(unsigned char const*, long, "
           "(anonymous namespace)::Planes, int, long, unsigned long long*)",
           "void at::native::CatArrayBatchedCopy_contig<...>",
           "Memcpy DtoH (Device -> Pageable)"]
SORT = ["void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<...>",
        "void at_cuda_detail::cub::DeviceRadixSortExclusiveSumKernel<...>",
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>",
        "void (anonymous namespace)::range_probe_materialize_kernel<int>(...)"]


def global_join_trace(joins=2):
    """joins of the global tier's materialize, each op 1 ms long after a
    1 ms gap, the host inside hjbench.dispatch."""
    ops, t = [], 0.0
    for _ in range(joins):
        for name in BUILD + WALK + COMPACT:
            t += 1e-3
            ops.append(Op(name, t, t + 1e-3))
            t += 1e-3
    host = [Op("hjbench.dispatch", 0.0, t), Op("cudaLaunchKernel", 0.0, 5e-4)]
    return Trace(ops=ops, host=host, window=(0.0, t + 1e-3), joins=joins,
                 bytes_per_join=6.7e9)


def test_busy_gaps_and_breakdown():
    t = global_join_trace()
    n = len(t.ops)
    assert t.busy_s() == pytest.approx(n * 1e-3)
    assert t.op_seconds() == pytest.approx(n * 1e-3)
    assert len(t.gaps()) == n + 1
    b = t.breakdown()
    assert b["device_ops"][0] == ["Memset (Device)", pytest.approx(8e-3)]
    assert len(b["device_ops"]) == 10
    host = dict(b["idle_gaps"])
    assert host["cudaLaunchKernel"] == pytest.approx(1e-3)
    assert host["hjbench.dispatch"] == pytest.approx((n - 1) * 1e-3)
    assert host["host, no event"] == pytest.approx(1e-3)


def test_overlapping_ops_merge():
    t = Trace(ops=[Op("a", 0.1, 0.5), Op("b", 0.2, 0.3), Op("c", 0.4, 0.9)],
              host=[], window=(0.0, 1.0), joins=1, bytes_per_join=1.0)
    assert t.busy_intervals() == [(0.1, 0.9)]
    assert t.gaps() == [(0.0, 0.1), (0.9, 1.0)]


def reader(name):
    return catalog.reader(name)


def test_global_build_and_walk_tell_shared_kernels_apart():
    t = global_join_trace(joins=2)
    assert reader("global.build_ms")(t) == pytest.approx(len(BUILD))
    assert reader("global.walk_ms")(t) == pytest.approx(len(WALK))
    assert reader("compact.ms")(t) == pytest.approx(2.0)
    assert reader("partitioned.sort_ms")(t) is None
    assert reader("dispatch.kernels_per_join")(t) == len(BUILD + WALK +
                                                         COMPACT)
    per_join = len(BUILD + WALK + COMPACT) * 1e-3
    assert reader("kernels.roofline")(t) == pytest.approx(
        100 * 6.7e9 / HBM_BYTES_PER_S / per_join)
    assert reader("device.idle_share")(t) == pytest.approx(
        100 * (1 - t.busy_s() / t.window_s))


def test_partitioned_sort():
    ops = [Op(n, i * 1e-3, i * 1e-3 + 5e-4) for i, n in
           enumerate(SORT + COMPACT)]
    t = Trace(ops=ops, host=[], window=(0.0, 1.0), joins=1,
              bytes_per_join=1.0)
    assert reader("partitioned.sort_ms")(t) == pytest.approx(1.5)
    assert reader("global.build_ms")(t) is None
    assert reader("global.walk_ms")(t) is None


def test_readers_find_nothing_without_ops():
    t = Trace(ops=[], host=[], window=(0.0, 1.0), joins=3, bytes_per_join=1)
    for m in catalog.manifest()["per_layer"]:
        assert reader(m["name"])(t) is None, m["name"]
