"""K4's two routes (ops/cuda/range_probe.py) on the CPU: the plan that picks
between them, and the plain version of the 1-level route (the probes
partitioned by the top bits of their directory bucket, looked up slice by
slice, put back in probe order) against the plain 0-level K4 and the numpy
oracle.

Inputs are models/workload.range_probe_cases, also run on the card by
tests/test_torch_cuda.py.  Tolerance: exact, in probe order.
"""

import numpy as np
import pytest
import torch

from flash_hash_join_tpu_torch.models import cost
from flash_hash_join_tpu_torch.models.workload import range_probe_cases
from flash_hash_join_tpu_torch.ops import range_table as rt
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.utils.u64 import device_planes, to_numpy_u64

CASES = {c.name: c for c in range_probe_cases()}
MB = 2**20


def _table(case):
    kh, kl = device_planes(case.build_keys, "cpu")
    vh, vl = device_planes(case.build_values, "cpu")
    return rt.build_range_table(kh, kl, vh, vl, case.build_keys.size,
                                with_values=True)


def _oracle(case):
    """(hit, values) per probe row: the key's minimum build row's value,
    rows at or past np_valid never hitting."""
    bk, pk = case.build_keys, case.probe_keys
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = (uniq[pos] == pk) & (np.arange(pk.size) < case.np_valid)
    return hit, np.where(hit, case.build_values[first[pos]], 0)


def _sliced(case, table, ph, pl, pbits):
    with rp.forced(pbits=pbits, pass_rows=case.pass_rows):
        p = rp._plan(table, case.np_valid, ph.device)
        assert p.pbits == min(pbits, rp.table_dir_bits(table)) > 0
        return rp.range_probe_materialize(table, ph, pl, case.np_valid)


@pytest.mark.parametrize("pbits", [1, 3, rp.MAX_PBITS])
@pytest.mark.parametrize("name", CASES)
def test_sliced_plain_equals_k4_plain_and_oracle(name, pbits, monkeypatch):
    case = CASES[name]
    table = _table(case)
    ph, pl = device_planes(case.probe_keys, "cpu")
    calls = []
    plain = rp.range_probe_sliced_plain
    monkeypatch.setattr(rp, "range_probe_sliced_plain",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    got = _sliced(case, table, ph, pl, pbits)
    assert len(calls) == 1                 # the wrapper took the 1-level route
    want = rp.range_probe_materialize_plain(table, ph, pl, case.np_valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name
    hit, vals = _oracle(case)
    np.testing.assert_array_equal(got[0].numpy(), hit)
    np.testing.assert_array_equal(to_numpy_u64(got[1], got[2], hit.size),
                                  vals)


def test_sliced_cases_cover_their_edges():
    c = CASES
    assert rp.directory_bits(c["small_table_plus_one"].build_keys.size) > 0
    assert rp.directory_bits(rp.SMALL_TABLE) == 0
    # the outlier puts all but one key into bucket 0 of the first slice
    t = _table(c["far_outlier"])
    assert int(t.dir[1]) == t.keys.numel() - 1
    # no probe of all_outside is inside the keys
    bk, pk = c["all_outside"].build_keys, c["all_outside"].probe_keys
    assert not ((pk >= bk.min()) & (pk <= bk.max())).any()
    assert (pk < bk.min()).any() and (pk > bk.max()).any()
    m64 = np.uint64(2**64 - 1)
    assert (c["u64_max"].build_keys == m64).any()
    assert (c["u64_max"].probe_keys == m64).any()
    dup = c["duplicates"].build_keys
    assert np.unique(dup).size < dup.size
    cut = c["np_valid_cut"]
    assert cut.np_valid < cut.probe_keys.size
    passes = c["passes_of_1000"]
    assert passes.np_valid > 2 * passes.pass_rows
    assert passes.np_valid % passes.pass_rows            # a short last pass
    j1 = c["j1"]
    assert np.isin(j1.probe_keys, j1.build_keys).mean() == pytest.approx(0.9)


@pytest.mark.parametrize("name", ["j1", "duplicates", "np_valid_cut"])
def test_sliced_join_materialize_emits_probe_order(name):
    case = CASES[name]
    planes = [*device_planes(case.build_keys, "cpu"),
              *device_planes(case.build_values, "cpu"),
              *device_planes(case.probe_keys, "cpu")]
    with rp.forced(pbits=rp.MAX_PBITS):
        out = rt.range_join_materialize(*planes, case.build_keys.size,
                                        case.np_valid)
    hit, vals = _oracle(case)
    count = int(out[0])
    assert count == int(hit.sum()) and out[-1].tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(to_numpy_u64(out[1], out[2], count),
                                  case.probe_keys[hit])
    np.testing.assert_array_equal(to_numpy_u64(out[3], out[4], count),
                                  vals[hit])


# ---- the plan -----------------------------------------------------------------

J1_1E8 = 16 * 10**8 + 4 * (2**23 + 1)       # J1 1e8 Q5's table: 1.63 GB


def test_plan_at_j1_1e8_q5():
    # 2^7 slices of ~12.7 MB, one pass of the 1e8 rows, the walk's blocks
    p = rp.plan(10**8, J1_1E8, 23)
    assert p == rp.Plan(7, 10**8, 4 * 132)
    assert J1_1E8 / 2**p.pbits <= rp.SLICE_BYTES < J1_1E8 / 2**(p.pbits - 1)


def test_plan_keeps_k4_where_the_table_is_near_l2():
    l2 = 50 * MB
    near = rp.MIN_TABLE_L2 * l2
    rows = 10**8
    assert rp.plan(rows, near, 20, l2_bytes=l2).pbits == 0
    assert rp.plan(rows, near + 1, 20, l2_bytes=l2).pbits > 0
    # the multiple is of the card's own L2
    assert rp.plan(rows, near + 1, 20, l2_bytes=2 * l2).pbits == 0
    # the sweep's tables: 2^23 keys (136 MiB) keep K4, 2^24 (272 MiB) slice
    assert rp.plan(rows, 142_606_340, 21, l2_bytes=l2).pbits == 0
    assert rp.plan(rows, 285_212_676, 22, l2_bytes=l2).pbits == 5


def test_plan_keeps_k4_for_too_few_probes():
    nbytes = 256 * MB                          # 16 slices of 16 MB
    bits = rp.slice_bits(nbytes, 20)
    assert bits == 4
    assert rp.plan(rp.MIN_PROBES - 1, nbytes, 20).pbits == 0
    assert rp.plan(rp.MIN_PROBES, nbytes, 20).pbits == bits
    assert rp.plan(2**22, J1_1E8, 23).pbits == 0   # the sweep's break-even
    assert rp.plan(2**24, J1_1E8, 23).pbits == 7
    assert rp.plan(0, nbytes, 20, pbits=3).pbits == 0   # no probe rows


def test_plan_needs_a_directory():
    assert rp.plan(10**8, J1_1E8, 0).pbits == 0
    assert rp.plan(10**8, J1_1E8, 0, pbits=5).pbits == 0
    table = rt.RangeTable(torch.arange(3), torch.zeros(3, 2, dtype=torch.int32),
                          torch.tensor([0, 1, 3], dtype=torch.int32),
                          torch.tensor(1))
    assert rp.table_dir_bits(table) == 0       # fewer than 4 keys
    assert rp.table_dir_bits(table._replace(dir=None, shift=None)) == 0
    assert rp.table_bytes(table) == 16 * 3 + 4 * 3


@pytest.mark.parametrize("p", [1, 2, 5, 7, 9, 23])
@pytest.mark.parametrize("mb", [30, 150, 201, 2_000, 100_000])
def test_plan_bits_are_the_fewest_within_p_and_max_pbits(p, mb):
    nbytes = mb * MB
    bits = rp.slice_bits(nbytes, p)
    sliced = nbytes > rp.MIN_TABLE_L2 * rp.L2_BYTES     # 200 MiB
    assert rp.plan(10**9, nbytes, p).pbits == (bits if sliced else 0)
    assert 1 <= bits <= min(p, rp.MAX_PBITS)
    if bits < min(p, rp.MAX_PBITS):
        assert nbytes / 2**bits <= rp.SLICE_BYTES
    if bits > 1:
        assert nbytes / 2**(bits - 1) > rp.SLICE_BYTES
    assert rp.plan(10**9, nbytes, p, pbits=30).pbits == p    # forced, <= p


@pytest.mark.parametrize("rows,pass_rows,passes", [
    (10**8, None, 1), (rp.PASS_ROWS, None, 1), (rp.PASS_ROWS + 1, None, 2),
    (10**9, None, 8), (29_999, 1_000, 30), (5, 1_000, 1)])
def test_plan_passes_and_blocks(rows, pass_rows, passes):
    p = rp.plan(rows, J1_1E8, 23, pass_rows=pass_rows, sms=100)
    assert p.pass_rows == min(rows, pass_rows or rp.PASS_ROWS)
    assert -(-rows // p.pass_rows) == passes
    assert p.blocks == max(1, min(-(-p.pass_rows // rp.CHUNK_ROWS), 400))


def test_forced_plan_is_restored():
    table = _table(CASES["j1"])
    assert rp._plan(table, 30_000, torch.device("cpu")).pbits == 0
    with rp.forced(pbits=4):
        with rp.forced(pass_rows=7):
            assert rp._plan(table, 30_000, torch.device("cpu"))[:2] == (4, 7)
        assert rp._plan(table, 30_000, torch.device("cpu"))[:2] == (4, 30_000)
    assert rp._forced == {}


def test_materialize_scratch_is_charged_up_to_a_pass():
    big = 10**8                    # J1 1e8 Q5's table: 1.6 GB
    assert cost.probe_scratch_bytes(big, 10**8, "count") == 0
    assert cost.probe_scratch_bytes(big, 10**8, "materialize") == 15 * 10**8
    assert cost.probe_scratch_bytes(big, 10**9, "materialize") == \
        rp.SLICED_SCRATCH_BYTES * rp.PASS_ROWS
    # where K4's plan keeps the 0-level route, nothing is charged: too few
    # probe rows, or a table of 1e6 keys (16 MB) that L2 holds
    assert cost.probe_scratch_bytes(big, rp.MIN_PROBES - 1,
                                    "materialize") == 0
    assert cost.probe_scratch_bytes(10**6, 10**9, "materialize") == 0
    assert rp.built_table_bytes(10**8) == 16 * 10**8 + (2**23 + 1) * 4
    assert rp.built_table_bytes(rp.SMALL_TABLE) == 16 * rp.SMALL_TABLE


def test_planner_charges_the_scratch_only_on_the_sliced_route():
    # a budget that holds the build side and the chunk's planes, and no
    # more, plans one chunk where K4 keeps the 0-level route (a table of
    # 1e6 keys, which L2 holds), and more where it takes the sliced route
    rows = 3 * 10**8
    for nb, sliced in ((10**8, True), (10**6, False)):
        fixed, per_row, _ = cost.footprint(nb, "materialize")
        chunks = cost.plan_probe_chunks(nb, rows, "materialize",
                                        fixed + per_row * rows)
        assert (chunks > 1) == sliced
