"""Port parity for stable stream compaction: flash_hash_join_tpu_torch's
compaction (K5's plain version on CPU tensors, through ops/compact.py)
against the JAX package's compact_by_mask_pack (the pack kernel in
interpret mode, as tests/test_stream_compact.py runs it) and numpy boolean
indexing.

Inputs are numpy arrays from a fixed seed.  Tolerance: exact — the count
and the [:count] prefix of every plane are equal; rows past count are
unspecified in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops.pallas import stream_compact as jsc
from flash_hash_join_tpu_torch.ops import compact as tc
from flash_hash_join_tpu_torch.ops.cuda import stream_compact as tsc
from flash_hash_join_tpu_torch.utils import u64 as tu64


def _inputs(n, density, n_planes, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32)
            for _ in range(n_planes)]
    return mask, cols


@pytest.mark.parametrize("n,density,n_planes", [
    (0, 0.5, 2),            # empty
    (5, 0.8, 4),            # one partial block
    (1_000, 0.5, 2),
    (4_097, 0.0, 3),        # all miss, one row past a K5 tile
    (40_000, 1.0, 3),       # all hit, not a multiple of either block
    (33_001, 0.31, 4),
])
def test_compact_matches_jax_pack(n, density, n_planes):
    mask, cols = _inputs(n, density, n_planes, seed=n)
    count, outs = tc.compact_by_mask(
        torch.from_numpy(mask), [tu64.to_device(c, "cpu") for c in cols])
    jcount, jouts = jsc.compact_by_mask_pack(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols),
        interpret=True)
    assert count.dtype == torch.int64
    assert int(count) == int(jcount) == int(mask.sum())
    for o, j, c in zip(outs, jouts, cols):
        assert o.dtype == torch.int32 and o.numel() == n
        got = tu64.to_numpy_u32(o[:int(count)])
        np.testing.assert_array_equal(got, np.asarray(j)[:int(count)])
        np.testing.assert_array_equal(got, c[mask])      # stable


@pytest.mark.parametrize("n_out", [0, 7, 400, 1_000])
def test_compact_truncates_to_n_out(n_out):
    mask, cols = _inputs(1_000, 0.6, 2, seed=2)
    count, outs = tsc.compact_by_mask(
        torch.from_numpy(mask), [tu64.to_device(c, "cpu") for c in cols],
        n_out)
    assert int(count) == int(mask.sum())           # the count is never cut
    keep = min(n_out, int(count))
    for o, c in zip(outs, cols):
        assert o.numel() == n_out
        np.testing.assert_array_equal(tu64.to_numpy_u32(o[:keep]),
                                      c[mask][:keep])


def test_compact_entry_takes_widened_planes():
    mask, cols = _inputs(3_000, 0.4, 4, seed=3)
    planes = [tu64.to_device(c, "cpu") for c in cols]
    widened = [tu64.widen(p) for p in planes]
    a = tc.compact_by_mask(torch.from_numpy(mask), planes, n_out=2_000)
    b = tc.compact_by_mask(torch.from_numpy(mask), widened, n_out=2_000)
    assert int(a[0]) == int(b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def test_compact_refuses_bad_inputs():
    mask = torch.zeros(8, dtype=torch.bool)
    plane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):                  # mask not bool
        tsc.compact_by_mask(plane, [plane], 8)
    with pytest.raises(ValueError):                  # no planes / too many
        tsc.compact_by_mask(mask, [], 8)
    with pytest.raises(ValueError):
        tsc.compact_by_mask(mask, [plane] * 5, 8)
    with pytest.raises(ValueError):                  # int64 plane
        tsc.compact_by_mask(mask, [plane.long()], 8)
    with pytest.raises(ValueError):                  # length mismatch
        tsc.compact_by_mask(mask, [plane[:7]], 8)
    with pytest.raises(ValueError):
        tsc.compact_by_mask(mask, [plane], -1)
