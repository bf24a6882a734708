"""The partitioned tier's table build (ops/cuda/range_build.py) on the CPU:
the plain version against the torch.sort build it replaces and a numpy
stable sort, on models/workload.range_build_cases; the pass plan on the
edge spans of the varying bits; a numpy model of the card's sort (a stable
pass a digit of the plan, lowest first) equal to the stable sort; the
wrapper's checks.  The kernels themselves run on the card only
(tests/test_torch_cuda.py -k range_build).  Tolerance: exact."""

import numpy as np
import pytest
import torch

from flash_hash_join_tpu_torch.models.workload import range_build_cases
from flash_hash_join_tpu_torch.ops import range_table as rt
from flash_hash_join_tpu_torch.ops.cuda import range_build as rb
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.utils.u64 import (device_planes, sortable,
                                                 to_numpy_u64)

CASES = range_build_cases()
SIGN = np.uint64(2**63)


def _planes(case):
    return [*device_planes(case.build_keys, "cpu"),
            *device_planes(case.build_values, "cpu")]


def _torch_sort_build(kh, kl, vh, vl, nb):
    """The partitioned build before the kernels, as it was written."""
    keys, order = torch.sort(sortable(kh[:nb], kl[:nb]), stable=True)
    return keys, torch.stack((vh[:nb], vl[:nb]), 1)[order]


def _varying(keys: np.ndarray) -> int:
    if keys.size == 0:
        return 0
    return int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_range_build_plain_equals_the_sort_build(case):
    planes, nb = _planes(case), case.nb_valid
    keys, values = rb.range_build(*planes, nb, with_values=True)
    want_keys, want_values = _torch_sort_build(*planes, nb)
    assert torch.equal(keys, want_keys) and torch.equal(values, want_values)
    count_keys, none = rb.range_build(*planes, nb, with_values=False)
    assert none is None and torch.equal(count_keys, want_keys)
    # numpy: u64 order, equal keys in row order
    order = np.argsort(case.build_keys[:nb], kind="stable")
    np.testing.assert_array_equal(
        keys.numpy(), (case.build_keys[order] ^ SIGN).view(np.int64))
    np.testing.assert_array_equal(
        to_numpy_u64(values[:, 0], values[:, 1], nb),
        case.build_values[order])
    # the table around it: the directory over the same keys
    table = rt.build_range_table(*planes, nb, with_values=True)
    assert torch.equal(table.keys, keys) and torch.equal(table.values, values)
    p = rp.directory_bits(nb)
    if p:
        for got, want in zip((table.dir, table.shift),
                             rp.range_directory_plain(keys, p)):
            assert torch.equal(got, want)
    else:
        assert table.dir is None and table.shift is None


@pytest.mark.parametrize("bits,digits,narrow", [
    (0, (0,), True), (1, (0,), True), (27, (0, 1, 2), True),
    (32, (0, 1, 2, 3), True), (33, (0, 1, 2, 3), False),
    (64, tuple(range(8)), False)])
@pytest.mark.parametrize("with_values", [False, True])
def test_plan_on_edge_spans(bits, digits, narrow, with_values):
    plan = rb.plan((1 << bits) - 1, with_values)
    assert plan.digits == digits and plan.passes == len(digits)
    assert plan.record_bytes == (4 if narrow else 8) + 8 * with_values


@pytest.mark.parametrize("varying,digits,record_bytes", [
    (0x3FE00, (1,), 4), (1 << 40, (4,), 8), (0x8000_0000_0000_0001, (0, 7), 8),
    ((0xFFFF << 16) | 1, (0, 1, 2, 3), 4), ((1 << 35) | (1 << 18), (2, 3), 8)])
def test_plan_sorts_only_the_digits_that_vary(varying, digits, record_bytes):
    assert rb.plan(varying, False) == (digits, len(digits), record_bytes)
    assert rb.plan(varying, True).record_bytes == record_bytes + 8


def _model_sort(keys: np.ndarray, plan) -> np.ndarray:
    """The card's sort in numpy: one stable counting pass a digit of the
    plan, lowest first, each record (its key's low word alone where the
    plan's records are narrow, and its row, for the values) carried whole;
    returns the rows in sorted order."""
    narrow = plan.record_bytes in (4, 12)
    key = keys & np.uint64(2**32 - 1) if narrow else keys.copy()
    rows = np.arange(keys.size)
    bins = 2**rb.DIGIT_BITS
    for k in plan.digits:
        digit = (key >> np.uint64(rb.DIGIT_BITS * k)) & np.uint64(bins - 1)
        counts = np.bincount(digit.astype(np.int64), minlength=bins)
        base = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.empty(keys.size, np.int64)
        for d in np.unique(digit):           # a digit's rows keep their order
            at = np.flatnonzero(digit == d)
            slot[at] = base[int(d)] + np.arange(at.size)
        key[slot], rows[slot] = key.copy(), rows.copy()
    return rows


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_the_passes_of_the_plan_sort_stably(case):
    keys = case.build_keys[:case.nb_valid]
    plan = rb.plan(_varying(keys), with_values=True)
    np.testing.assert_array_equal(_model_sort(keys, plan),
                                  np.argsort(keys, kind="stable"))


def test_plan_of_the_j1_1e8_keys_is_three_narrow_passes():
    case = next(c for c in CASES if c.name == "j1_1e8_range")
    assert rb.plan(_varying(case.build_keys), True) == ((0, 1, 2), 3, 12)
    case = next(c for c in CASES if c.name == "j1_1e8_range_u64_max")
    assert rb.plan(_varying(case.build_keys), True) == (tuple(range(8)), 8,
                                                        16)


def test_range_build_refuses_bad_inputs():
    kh, kl, vh, vl = (torch.zeros(64, dtype=torch.int32) for _ in range(4))
    with pytest.raises(ValueError, match="int32"):
        rb.range_build(kh.long(), kl, vh, vl, 64, with_values=True)
    with pytest.raises(ValueError, match="1-D"):
        rb.range_build(kh, kl.view(8, 8), vh, vl, 64, with_values=True)
    with pytest.raises(ValueError, match="contiguous"):
        rb.range_build(kh, kl, vh[::2], vl, 32, with_values=True)
    with pytest.raises(ValueError, match="rows"):
        rb.range_build(kh, kl, vh, vl[:63], 63, with_values=False)
    with pytest.raises(ValueError, match="one device"):
        rb.range_build(kh, kl, vh.to("meta"), vl, 64, with_values=True)
    for nb in (-1, 65):
        with pytest.raises(ValueError, match="nb_valid"):
            rb.range_build(kh, kl, vh, vl, nb, with_values=True)
    with pytest.raises(ValueError, match="CUDA"):
        rb.device_plan(kh, kl, vh, vl, 64, with_values=True)
