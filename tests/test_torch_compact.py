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
from flash_hash_join_tpu_torch.models.workload import ragged_counts
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
    (4_097, 0.0, 3),        # all miss, one row past 4096
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


# ---- FHJ_COMPACT=stream: blockwise sort + K6 ---------------------------------

@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("n_planes", [2, 3, 4])
def test_compact_stream_matches_jax_stream_and_pack(density, n_planes):
    n = 5_003                                  # 5 blocks of 8 x 128 rows
    mask, cols = _inputs(n, density, n_planes, seed=n_planes)
    planes = [tu64.to_device(c, "cpu") for c in cols]
    count, outs = tc.compact_by_mask_stream(torch.from_numpy(mask), planes,
                                            block_rows=8)
    jcount, jouts = jsc.compact_by_mask_stream(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in cols), block_rows=8,
        interpret=True)
    pcount, pouts = tsc.compact_by_mask(torch.from_numpy(mask), planes, n)
    assert int(count) == int(jcount) == int(pcount) == int(mask.sum())
    for o, j, p, c in zip(outs, jouts, pouts, cols):
        assert o.dtype == torch.int32 and o.numel() == n
        got = tu64.to_numpy_u32(o[:int(count)])
        np.testing.assert_array_equal(got, np.asarray(j)[:int(count)])
        np.testing.assert_array_equal(got, tu64.to_numpy_u32(
            p[:int(count)]))
        np.testing.assert_array_equal(got, c[mask])       # stable


@pytest.mark.parametrize("kind", ["random", "residues", "alternating",
                                  "empty", "full"])
@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
def test_concat_ragged_blocks_plain_matches_jax(n_planes, kind):
    # the JAX kernel takes counts in [0, block] only
    rng = np.random.default_rng(5 + n_planes)
    nblocks, block = 7, 8 * 128
    counts = ragged_counts(rng, kind, nblocks, block).astype(np.int32)
    if kind == "random":
        counts[[1, 4]] = [0, block]            # an empty and a full block
    planes = [rng.integers(0, 2**32, (nblocks * 8, 128), dtype=np.uint32)
              for _ in range(n_planes)]
    jouts = jsc.concat_ragged_blocks(
        tuple(jnp.asarray(p) for p in planes), jnp.asarray(counts),
        block_rows=8, interpret=True)
    total, outs = tsc.concat_ragged_blocks(
        [tu64.to_device(p, "cpu").view(nblocks, block) for p in planes],
        torch.from_numpy(counts), with_total=True)
    assert int(total) == int(counts.sum())
    for o, j, p in zip(outs, jouts, planes):
        assert o.numel() == nblocks * block
        got = tu64.to_numpy_u32(o[:int(total)])
        np.testing.assert_array_equal(
            got, np.asarray(j).reshape(-1)[:int(total)])
        np.testing.assert_array_equal(got, np.concatenate(
            [row[:c] for row, c in zip(p.reshape(nblocks, block), counts)]))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_concat_ragged_blocks_clamps_counts(dtype):
    # counts below 0 and above the block length act as 0 and the length,
    # in the planes and in the total
    rng = np.random.default_rng(9)
    nblocks, block = 6, 1_001
    planes = [torch.from_numpy(rng.integers(-2**31, 2**31, (nblocks, block),
                                            dtype=np.int64).astype(np.int32))
              for _ in range(2)]
    big = 2**32 + 3 if dtype == torch.int64 else 2**31 - 1  # low word 3
    counts = torch.tensor([-5, 2_000, 3, -2**31, big, 997], dtype=dtype)
    clamped = counts.clamp(0, block).to(torch.int32)
    total, outs = tsc.concat_ragged_blocks(planes, counts, with_total=True)
    assert total.dtype == torch.int64 and int(total) == 3_002
    want = tsc.concat_ragged_blocks(planes, clamped)
    for o, w, p in zip(outs, want, planes):
        assert torch.equal(o[:3_002], w[:3_002])
        assert torch.equal(o[:3_002], torch.cat(
            [p[1], p[2, :3], p[4], p[5, :997]]))


def test_fhj_compact_stream_routes_compact_by_mask(monkeypatch):
    mask, cols = _inputs(3_000, 0.4, 4, seed=7)
    planes = [tu64.to_device(c, "cpu") for c in cols]
    calls = []
    real = tc.compact_by_mask_stream

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tc, "compact_by_mask_stream", spy)
    pack = tc.compact_by_mask(torch.from_numpy(mask), planes, n_out=2_000)
    assert not calls                                   # "pack": the default
    monkeypatch.setenv("FHJ_COMPACT", "stream")        # read at call time
    stream = tc.compact_by_mask(torch.from_numpy(mask), planes, n_out=2_000)
    assert calls == [1]
    assert int(stream[0]) == int(pack[0]) == int(mask.sum())
    keep = min(2_000, int(pack[0]))
    for s, p in zip(stream[1], pack[1]):
        assert s.numel() == 2_000 and torch.equal(s[:keep], p[:keep])
