"""The plain reference against an independent numpy join, and the control
reading above every limit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hjbench import check
from hjbench.reference import join as ref
from hjbench.tests.conftest import small_cell

EDGE = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2,
                 2**64 - 1], np.uint64)


def numpy_first_match(bk, bv, pk):
    """Each probe row whose key is in bk, with the value of its key's
    minimum build row, in probe order: a dict, row by row."""
    first = {}
    for row in range(bk.size):
        first.setdefault(int(bk[row]), int(bv[row]))
    keys = [int(k) for k in pk if int(k) in first]
    return (np.array(keys, np.uint64),
            np.array([first[k] for k in keys], np.uint64))


def cases():
    rng = np.random.default_rng(7)
    yield "dups", rng.integers(0, 50, 300, dtype=np.uint64), \
        rng.integers(0, 2**64, 300, dtype=np.uint64), \
        rng.integers(0, 70, 1000, dtype=np.uint64)
    yield "edges", np.concatenate([EDGE, EDGE[::-1]]), \
        np.arange(16, dtype=np.uint64), np.concatenate([EDGE, EDGE + 3])
    wide = rng.integers(0, 2**64, 400, dtype=np.uint64)
    yield "wide", wide, rng.integers(0, 2**64, 400, dtype=np.uint64), \
        rng.permutation(np.concatenate([
            rng.integers(0, 2**64, 300, dtype=np.uint64), wide[::3]]))
    yield "no_probe", EDGE, EDGE, np.zeros(0, np.uint64)


@pytest.mark.parametrize("name,bk,bv,pk", list(cases()),
                         ids=[c[0] for c in cases()])
@pytest.mark.parametrize("block_rows", [7, 1 << 20])
def test_reference_equals_numpy(name, bk, bv, pk, block_rows):
    want_k, want_v = numpy_first_match(bk, bv, pk)
    table = ref.build(bk, bv, "cpu")
    blocks = list(ref.probe(table, pk, "cpu", block_rows=block_rows))
    got_k = np.concatenate([b.keys.numpy().view(np.uint64) for b in blocks]
                           or [np.zeros(0, np.uint64)])
    got_v = np.concatenate([b.values.numpy().view(np.uint64) for b in blocks]
                           or [np.zeros(0, np.uint64)])
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_v, want_v)


def test_compare_judges_planes_exactly():
    bk, bv, pk = next(cases())[1:]
    want_k, want_v = numpy_first_match(bk, bv, pk)
    n = want_k.size
    bits = lambda a: torch.from_numpy(a.view(np.int64))     # noqa: E731
    good = (n, *check.planes(bits(want_k)), *check.planes(bits(want_v)))
    assert check.compare(bk, bv, pk, "materialize", [n], [good], "cpu",
                         block_rows=64) == {"count_gap": 0, "rows_wrong": 0,
                                            "failed_joins": 0}
    bad_v = want_v.copy()
    bad_v[n // 2] ^= np.uint64(1 << 40)
    bad = (n, *check.planes(bits(want_k)), *check.planes(bits(bad_v)))
    short = (n - 3, *good[1:])
    got = check.compare(bk, bv, pk, "materialize", [n, n - 3], [bad, short],
                        "cpu", failed=2, block_rows=64)
    assert got == {"count_gap": 3, "rows_wrong": 1 + 3, "failed_joins": 2}
    assert not check.verdict({"count_gap": 0, "failed_joins": 1})


def test_planes_round_trip():
    raw = np.concatenate([EDGE, np.arange(5, dtype=np.uint64)])
    bits = torch.from_numpy(raw.view(np.int64))
    assert torch.equal(check.u64_bits(*check.planes(bits)), bits)


@pytest.mark.parametrize("name", ["j1-1e8.q5.count", "mmhj-a.hash-join",
                                  "j1-1e8.q5.join", "dist-zipf-c5.count"])
def test_control_fails(name):
    """The control (keys matched by a 32-bit fingerprint) at a size a test
    holds: the cell's own columns with its rows cut, so fingerprints
    collide less often than at the cell's size; still above the limit."""
    cfg, traffic, gen = small_cell(name)
    cfg = dict(cfg, x_rows=2_000_000,
               tables=dict(cfg.get("tables", {}), big=2_000_000),
               build_rows=1 << 20, probe_rows=1 << 21)
    bk, bv, pk = gen.make(cfg, traffic["table"], 3)
    checks = check.control(bk, bv, pk, traffic["mode"], "cpu")
    assert not check.verdict(checks), checks
