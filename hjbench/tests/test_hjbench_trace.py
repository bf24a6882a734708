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
# the partitioned build's sort (csrc/range_build.cu) after its memset, then
# the range probes, whose count kernel the sort reader must not take
SORT = ["Memset (Device)",
        "(anonymous namespace)::count_kernel(unsigned int const*, unsigned "
        "int const*, long, unsigned int*, unsigned int*)",
        "void (anonymous namespace)::pass_kernel<3>((anonymous namespace)::"
        "Pass)",
        "void (anonymous namespace)::pass_kernel<4>((anonymous namespace)::"
        "Pass)",
        "void (anonymous namespace)::range_probe_count_kernel<0>(long long "
        "const*, long, int const*, int const*, long, unsigned long long*)",
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
    """The memset, count_kernel and both pass kernels: 4 ops of 0.5 ms;
    neither range probe kernel."""
    ops = [Op(n, i * 1e-3, i * 1e-3 + 5e-4) for i, n in
           enumerate(SORT + COMPACT)]
    t = Trace(ops=ops, host=[], window=(0.0, 1.0), joins=1,
              bytes_per_join=1.0)
    assert reader("partitioned.sort_ms")(t) == pytest.approx(2.0)
    assert reader("global.build_ms")(t) is None
    assert reader("global.walk_ms")(t) is None
    probes = [Op(n, i * 1e-3, i * 1e-3 + 5e-4)
              for i, n in enumerate(SORT[4:])]
    assert reader("partitioned.sort_ms")(
        Trace(ops=probes, host=[], window=(0.0, 1.0), joins=1,
              bytes_per_join=1.0)) is None


def test_readers_find_nothing_without_ops():
    t = Trace(ops=[], host=[], window=(0.0, 1.0), joins=3, bytes_per_join=1)
    for m in catalog.manifest()["per_layer"]:
        assert reader(m["name"])(t) is None, m["name"]


def _union_busy(ops, window):
    """The busy time as the reduction read it before Trace had cards: the
    union of every op's interval inside the window."""
    w0, w1 = window
    merged = []
    for o in sorted(ops, key=lambda o: o.start):
        a, b = max(o.start, w0), min(o.end, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged)


def one_card_traces():
    yield global_join_trace(joins=3)
    rng = __import__("random").Random(5)
    names = BUILD + WALK + COMPACT + SORT
    ops = []
    for _ in range(400):
        s0 = rng.uniform(-0.01, 1.0)
        ops.append(Op(rng.choice(names), s0, s0 + rng.expovariate(300)))
    ops.sort(key=lambda o: o.start)
    yield Trace(ops=ops, host=[Op("hjbench.dispatch", 0.0, 0.7)],
                window=(0.0, 0.99), joins=7, bytes_per_join=3.3e9)


@pytest.mark.parametrize("t", list(one_card_traces()), ids=["joins", "random"])
def test_one_card_readers_are_as_before(t):
    """On one card the per-card readings are the whole trace's, bit for
    bit: the idle share, the busy seconds, the ops a join, the roofline,
    the idle gaps."""
    busy = _union_busy(t.ops, t.window)
    assert t.cards == 1 and t.busy_s() == busy and t.busy_s(0) == busy
    assert t.mean_busy_s() == busy and t.card_busy_s() == [busy]
    assert reader("device.idle_share")(t) == \
        100.0 * (1.0 - busy / t.window_s)
    assert reader("dispatch.kernels_per_join")(t) == len(t.ops) / t.joins
    per_join = sum(o.end - o.start for o in t.ops) / t.joins
    assert reader("kernels.roofline")(t) == \
        100.0 * (t.bytes_per_join / HBM_BYTES_PER_S) / per_join
    ms = t.ms_per_join((r"^(?!Memcpy)",))
    assert t.card_ms_per_join((r"^(?!Memcpy)",)) == ms


H2D = "Memcpy HtoD (Pageable -> Device)"
P2P = "Memcpy PtoP (Device -> Device)"
D2D = "Memcpy DtoD (Device -> Device)"
D2H = "Memcpy DtoH (Device -> Pageable)"


def four_card_trace():
    """Two calls on four cards over a 10 s window.  Card c copies in for
    (4 + c) 100 ms, exchanges 50 ms by peer copies and 10 ms on the card,
    runs kernels and memsets for 200 ms and copies 1 ms out, a call; card 3
    runs nothing in the second call."""
    ops = []
    for call in range(2):
        t0 = call * 5.0
        for c in range(4 if call == 0 else 3):
            t = t0
            for name, ms in ((H2D, 100 * (4 + c)), (P2P, 50), (D2D, 10),
                             ("Memset (Device)", 20),
                             ("void (anonymous namespace)::slice_walk_kernel"
                              "<8, true, 2>((anonymous namespace)::Walk)",
                              180), (D2H, 1)):
                ops.append(Op(name, t, t + ms / 1e3, c))
                t += ms / 1e3
    ops.sort(key=lambda o: o.start)
    return Trace(ops=ops, host=[], window=(0.0, 10.0), joins=2,
                 bytes_per_join=1.0, cards=4)


def test_four_cards_read_apart():
    t = four_card_trace()
    busy = [2 * (0.1 * (4 + c) + 0.261) for c in range(3)] + [0.7 + 0.261]
    assert t.card_busy_s() == pytest.approx(busy)
    assert t.mean_busy_s() == pytest.approx(sum(busy) / 4)
    # the mean of the cards' idle shares, not the union's
    assert reader("device.idle_share")(t) == pytest.approx(
        sum(100 * (1 - b / 10) for b in busy) / 4)
    # the union: card 3 the longest in the first call, card 2 in the second
    assert t.busy_s() == pytest.approx(0.7 + 0.261 + 0.6 + 0.261)
    # ms a call, summed over the cards and divided by the four of them
    h2d = (2 * (400 + 500 + 600) + 700) / 2 / 4
    assert reader("dist.h2d_ms")(t) == pytest.approx(h2d)
    assert reader("dist.exchange_ms")(t) == pytest.approx(7 * 60 / 2 / 4)
    assert reader("dist.kernels_ms")(t) == pytest.approx(7 * 200 / 2 / 4)
    # the idle gaps are the stretches in which no card is busy
    gaps = t.gaps()
    assert gaps[0] == pytest.approx((0.961, 5.0))
    assert sum(b - a for a, b in gaps) == pytest.approx(10 - t.busy_s())


def test_dist_readers_find_no_copies_on_a_resident_join():
    t = global_join_trace()
    assert reader("dist.h2d_ms")(t) is None
    assert reader("dist.exchange_ms")(t) is None
