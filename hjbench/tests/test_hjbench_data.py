"""The copied generators' shapes and each traffic file's byte model."""

from __future__ import annotations

import numpy as np
import pytest

from hjbench import catalog
from hjbench.tests.conftest import small_cell


def test_j1_q5_follows_join_datagen():
    """join-datagen.R at Q5: x and big each a permutation of n of the
    keys 1..1.1n, sharing 0.9n of them, so 0.9 of x's rows match once."""
    cfg, traffic, gen = small_cell("j1-1e8.q5.count")
    n = 1_000_000
    cfg = dict(cfg, x_rows=n, tables=dict(cfg["tables"], big=n))
    bk, bv, pk = gen.make(cfg, "big", 2**63 + 5)
    assert bk.dtype == bv.dtype == pk.dtype == np.uint64
    assert bk.size == pk.size == n
    assert np.unique(bk).size == np.unique(pk).size == n
    both = np.union1d(bk, pk)
    assert both.size == 1.1 * n and both.min() == 1 and both.max() == 1.1 * n
    assert np.isin(pk, bk).sum() == 0.9 * n
    # v2: round(runif(max=100), 6) cast to uint64
    assert bv.min() == 0 and bv.max() in (99, 100)
    assert abs(np.bincount(bv.astype(np.int64)).std() / (n / 100)) < 0.05


def test_j1_smaller_tables_pad_x_from_their_keys():
    """A right table of n rows joins on split_xlr(n): x's rows are drawn
    from the n keys of x + l, every one of them present."""
    cfg, _, gen = small_cell("j1-1e8.q5.count")
    for table in ("small", "medium"):
        bk, bv, pk = gen.make(cfg, table, 7)
        n = cfg["tables"][table]
        assert bk.size == np.unique(bk).size == bv.size == n
        assert pk.size == cfg["x_rows"] and np.unique(pk).size == n
        assert np.isin(pk, bk).mean() == pytest.approx(0.9, abs=0.05)


def test_j1_same_seed_same_columns_and_tables_apart():
    cfg, _, gen = small_cell("j1-1e8.q5.count")
    a, b = gen.make(cfg, "big", 9), gen.make(cfg, "big", 9)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(gen.make(cfg, "big", 10)[2], a[2])
    assert gen.make(cfg, "small", 9)[0].size == cfg["tables"]["small"]
    with pytest.raises(ValueError):
        gen.make(cfg, "huge", 9)


def test_mmhj_a_one_match_a_probe():
    cfg, traffic, gen = small_cell("mmhj-a.hash-join")
    bk, bv, pk = gen.make(cfg, traffic["table"], 2**31 + 5)
    assert np.array_equal(np.sort(bk),
                          np.arange(1, cfg["build_rows"] + 1, dtype=np.uint64))
    assert pk.size == cfg["probe_rows"]
    counts = np.bincount(np.searchsorted(np.sort(bk), pk),
                         minlength=bk.size)
    assert np.isin(pk, bk).all() and counts.sum() == pk.size
    # keys uniform over R: every key drawn about probe_rows / build_rows times
    assert abs(counts.mean() - 16) < 1e-9 and counts.std() < 6
    assert bv.max() > 2**63     # full 64-bit payloads


def test_zipf_build_keys_unique_misses_and_seeded():
    """dist-zipf-c5's columns: unique ascending build keys below 2^62 with
    63-bit values; exactly a tenth of the probe rows miss, spread over the
    probe side; the same seed gives the same columns."""
    cfg, traffic, gen = small_cell("dist-zipf-c5.count")
    cfg = dict(cfg, build_rows=1 << 16, probe_rows=1 << 20)
    bk, bv, pk = gen.make(cfg, traffic["table"], 2**63 + 17)
    assert bk.dtype == bv.dtype == pk.dtype == np.uint64
    assert bk.size == bv.size and pk.size == cfg["probe_rows"]
    assert np.all(bk[1:] > bk[:-1]) and bk.size > 0.999 * cfg["build_rows"]
    assert bk.max() < 2**62 and pk.max() < 2**62
    assert bv.max() >= 2**62 and bv.max() < 2**63
    miss = ~np.isin(pk, bk)
    assert miss.sum() == round(0.1 * pk.size)
    # uniform over the probe side: each eighth holds about an eighth
    per_eighth = miss.reshape(8, -1).sum(1) / miss.sum()
    assert np.all(np.abs(per_eighth - 0.125) < 0.01)
    again = gen.make(cfg, traffic["table"], 2**63 + 17)
    assert all(np.array_equal(x, y) for x, y in zip((bk, bv, pk), again))
    assert not np.array_equal(gen.make(cfg, None, 2**63 + 18)[2], pk)
    with pytest.raises(ValueError):
        gen.make(cfg, "big", 1)


def test_zipf_ranks_follow_numpy_zipf():
    """The probe hits' ranks among the ascending build keys against numpy's
    own zipf draw of a = 1.2: the share of each of the first ranks, and
    the ranks past the last key clipped to it."""
    cfg, traffic, gen = small_cell("dist-zipf-c5.count")
    n, m = 1 << 12, 1 << 21
    cfg = dict(cfg, build_rows=n, probe_rows=m)
    bk, _, pk = gen.make(cfg, None, 5)
    hit = pk[np.isin(pk, bk)]
    rank = np.searchsorted(bk, hit) + 1
    want = np.minimum(np.random.default_rng(5).zipf(1.2, m), bk.size)
    for k in (1, 2, 3, 10, bk.size):
        got_share = (rank == k).mean()
        want_share = (want == k).mean()
        assert abs(got_share - want_share) < 4e-3 + 0.05 * want_share, k
    # one key, the smallest, draws about 1 / zeta(1.2) = 17.9 % of the hits
    assert abs((rank == 1).mean() - 0.179) < 0.005


@pytest.mark.parametrize("name,mode,build,probe,match", [
    ("dist.count", "count", 16, 8, 0),
    ("q5.count", "count", 8, 8, 0),
    ("q5.join", "materialize", 16, 8, 16),
    ("hash-join", "materialize", 16, 8, 16),
])
def test_traffic_byte_models(name, mode, build, probe, match):
    """Least bytes: each input byte read once (a count reads the keys
    alone), each output (key, value) row written once."""
    t = catalog.traffic(name)
    assert t["mode"] == mode
    assert t["bytes"] == {"build_row": build, "probe_row": probe,
                          "match": match}
    assert t["loop"] == "closed" and t["in_flight"] == 1


def test_j1_count_least_bytes():
    """J1 1e8 Q5's count moves 1.6 GB: 0.48 ms at 3.35 TB/s."""
    from hjbench.peaks import HBM_BYTES_PER_S
    man = catalog.manifest()
    cfg = catalog.config(man, "j1-1e8")
    b = catalog.traffic("q5.count")["bytes"]
    least = cfg["tables"]["big"] * b["build_row"] + cfg["x_rows"] * b["probe_row"]
    assert least == 1.6e9
    assert abs(least / HBM_BYTES_PER_S - 0.4776e-3) < 1e-6
