"""The port's spans (flash_hash_join_tpu_torch/utils/spans.py) on the CPU:
each tier's resident join nests its spans as the module's table says,
records them as host events of scope FUNCTION (never a user annotation,
which the profiler would mirror onto the card), records nothing with no
profiler running, and counts every span either way; the public API's
spans, the FHJ_PROFILE_DIR trace of a whole call, and the launch counts'
keys."""

from __future__ import annotations

import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch import api as tapi
from flash_hash_join_tpu_torch import engine
from flash_hash_join_tpu_torch.models.cost import JoinPlan
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import device_planes

S = spans
LAUNCH_KEYS = ["dense_bitmap", "scan_domain_count", "range_probe_count",
               "range_probe_materialize", "range_directory", "compact",
               "probe_gather_bitmap", "probe_gather_staged",
               "materialize_copy", "probe_count_vmem",
               "probe_materialize_vmem", "concat_ragged_blocks",
               "global_walk_count", "global_walk_materialize",
               "global_build", "range_build", "global_prune"]


def _columns(nb=3000, npr=5000, domain=4000, seed=7):
    rng = np.random.default_rng(seed)
    bk = rng.choice(domain, nb, replace=False).astype(np.uint64)
    bv = rng.integers(0, 2**40, nb, dtype=np.uint64)
    pk = rng.integers(0, domain, npr, dtype=np.uint64)
    return bk, bv, pk


def _args(bk, bv, pk):
    return [*device_planes(bk, "cpu"), *device_planes(bv, "cpu"),
            *device_planes(pk, "cpu"), bk.size, pk.size]


# (the engine's function, the edges (parent, child) of its fhj.* spans,
# None the root)
J = (None, S.JOIN)
CASES = {
    "direct-count": (lambda: engine.count_graph("direct", 8),
                     {J, (S.JOIN, S.DIRECT)}),
    "direct-materialize": (
        lambda: engine.materialize_graph("direct", 32),
        {J, (S.JOIN, S.DIRECT), (S.JOIN, S.COMPACT)}),
    "partitioned-count": (
        lambda: engine.count_graph("partitioned"),
        {J, (S.JOIN, S.PARTITIONED_BUILD), (S.JOIN, S.PARTITIONED_PROBE)}),
    "partitioned-materialize": (
        lambda: engine.materialize_graph("partitioned"),
        {J, (S.JOIN, S.PARTITIONED_BUILD), (S.JOIN, S.PARTITIONED_PROBE),
         (S.JOIN, S.COMPACT)}),
    "global-count": (
        lambda: engine.count_graph("global", n_build=3000),
        {J, (S.JOIN, S.GLOBAL_BUILD), (S.JOIN, S.GLOBAL_WALK)}),
    # a count with bloom prunes each chunk of the plain walk first
    "global-count-bloom": (
        lambda: engine.count_graph("global", n_build=3000, use_bloom=True),
        {J, (S.JOIN, S.GLOBAL_BUILD), (S.JOIN, S.GLOBAL_WALK),
         (S.GLOBAL_WALK, S.GLOBAL_PRUNE)}),
    "global-materialize": (
        lambda: engine.materialize_graph("global", n_build=3000),
        {J, (S.JOIN, S.GLOBAL_BUILD), (S.JOIN, S.GLOBAL_WALK),
         (S.JOIN, S.COMPACT)}),
    "vmem-materialize": (
        lambda: engine.materialize_graph("vmem", n_build=3000),
        {J, (S.JOIN, S.VMEM), (S.VMEM, S.COMPACT)}),
    "merge-count": (lambda: engine.count_graph("merge"),
                    {J, (S.JOIN, S.MERGE)}),
    "merge-materialize": (lambda: engine.materialize_graph("merge"),
                          {J, (S.JOIN, S.MERGE), (S.MERGE, S.COMPACT)}),
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _fhj_events(prof):
    return [e for e in prof.events() if e.name.startswith("fhj.")]


def _edges(events) -> set:
    """(nearest fhj.* ancestor or None, name) of each fhj.* event."""
    out = set()
    for e in events:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("fhj."):
            p = p.cpu_parent
        out.add((p.name if p is not None else None, e.name))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_spans_nest_as_the_table_says(case):
    make, edges = CASES[case]
    bk, bv, pk = _columns()
    fn, args = make(), _args(bk, bv, pk)
    prof, out = _profiled(lambda: fn(*args))
    assert int(out[0]) == int(np.isin(pk, bk).sum())
    events = _fhj_events(prof)
    assert _edges(events) == edges
    assert Counter(e.name for e in events)[S.JOIN] == 1
    # host events of scope FUNCTION, as aten ops are, never mirrored onto
    # the card as a user annotation
    kineto = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("fhj.")]
    assert sorted(e.name() for e in kineto) == sorted(e.name for e in events)
    assert {e.name() for e in kineto} <= set(S.NAMES)
    for e in kineto:
        assert e.scope() == 0, e.name()
        assert not e.is_user_annotation(), e.name()


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_records_nothing_and_counts(case, monkeypatch):
    make, edges = CASES[case]
    fn, args = make(), _args(*_columns())

    def recorded(name):
        raise AssertionError(f"span {name} recorded with no profiler")

    monkeypatch.setattr(spans, "_event", recorded)
    before = spans.counts()
    fn(*args)
    after = spans.counts()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == Counter(child for _, child in edges)
    assert not any(k.startswith(S.KERNEL_PREFIX) for k in moved)


def test_public_call_spans_route_copy_join_readback():
    bk, bv, pk = _columns()
    prof, out = _profiled(lambda: ft.join_materialize(
        bk, bv, pk, strategy="partitioned", device="cpu",
        return_arrays=True))
    assert out[0] == int(np.isin(pk, bk).sum())
    edges = _edges(_fhj_events(prof))
    assert {(None, S.API_ROUTE), (None, S.API_H2D), (None, S.JOIN),
            (None, S.API_READBACK)} <= edges
    assert (S.JOIN, S.PARTITIONED_BUILD) in edges


def test_streamed_chunks_span_their_copy_and_join(monkeypatch):
    monkeypatch.setattr(tapi, "choose_plan", lambda nb, npr, cfg, mode,
                        budget: JoinPlan("partitioned", cfg.group_bits(nb),
                                         3))
    bk, bv, pk = _columns()
    prof, out = _profiled(lambda: ft.join_materialize(
        bk, bv, pk, strategy="partitioned", device="cpu",
        return_arrays=True, return_info=True))
    assert out[-1]["probe_chunks"] == 3
    events = _fhj_events(prof)
    names = Counter(e.name for e in events)
    assert names[S.API_CHUNK] == 3 and names[S.JOIN] == 3
    edges = _edges(events)
    assert {(None, S.API_CHUNK), (S.API_CHUNK, S.API_H2D),
            (S.API_CHUNK, S.JOIN), (None, S.API_H2D)} <= edges


def test_profile_dir_traces_the_whole_call(tmp_path, monkeypatch):
    monkeypatch.setenv("FHJ_PROFILE_DIR", str(tmp_path))
    bk, bv, pk = _columns()
    count, _, keys, _ = ft.join_materialize(bk, bv, pk, strategy="global",
                                            device="cpu", return_arrays=True)
    assert count == keys.size == int(np.isin(pk, bk).sum())
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {S.API_ROUTE, S.API_H2D, S.JOIN, S.GLOBAL_BUILD, S.GLOBAL_WALK,
            S.COMPACT, S.API_READBACK} <= names


def test_launch_counts_keys_and_registry():
    counts = ft.launch_counts()
    assert list(counts) == LAUNCH_KEYS
    assert [S.KERNEL_PREFIX + k for k in LAUNCH_KEYS] == list(S.KERNELS)
    before = counts["compact"]
    with spans.span(S.K_COMPACT):
        pass
    assert ft.launch_counts()["compact"] == before + 1
    # the CPU path launches nothing
    bk, bv, pk = _columns()
    _, _, info = ft.join_materialize(bk, bv, pk, strategy="global",
                                     device="cpu", return_info=True)
    assert list(info["launches"]) == LAUNCH_KEYS
    assert not any(info["launches"].values())


def test_span_names_are_the_constants():
    assert len(set(S.NAMES)) == len(S.NAMES)
    assert all(n.startswith("fhj.") for n in S.NAMES)
    assert set(spans.counts()) == set(S.NAMES)
    with pytest.raises(KeyError):
        spans.span("fhj.not_a_span")


def test_counts_lose_no_update_across_threads():
    """The distributed ranks span from a thread a card: many threads and a
    short switch interval lose no increment."""
    n, threads = 20_000, 16
    before = spans.counts()[S.MERGE]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span(S.MERGE):
                    pass
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert spans.counts()[S.MERGE] - before == n * threads


def test_reset_zeroes_every_count():
    with spans.span(S.JOIN):
        pass
    spans.reset()
    assert not any(spans.counts().values())
