"""The `global` tier's table build, written out as the CUDA kernel builds it
(csrc/hash_build.cu): a numpy model of the bucket algorithm.  It must equal
the JAX package's build_table (a stable sort by (home, key), a cumsum and a
cummax, a segmented bloom scan) and the port's build_table_plain, which the
CPU takes, bit for bit: keys, vals, bloom and special, on every case of
models/workload.global_build_cases.

The model: count the rows of each home group; visit each group's rows in
an arbitrary order (a seeded shuffle, as the kernel's atomics leave them),
order them by (key, row) and keep each key's first row; each group's k_b
kept rows take consecutive slots from start_b = max(end_{b-1}, b * G),
end_b = start_b + k_b; a slot past the table, or max_probe_iters groups
past home, counts as dropped (the latter still written); the bloom word of
a group is the OR of its rows' tags, duplicates included.

Inputs come from numpy seeds, handed to both packages.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops import hash_table as jht
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models.workload import global_build_cases
from flash_hash_join_tpu_torch.ops import hash_table as tht
from flash_hash_join_tpu_torch.ops.cuda import hash_build
from flash_hash_join_tpu_torch.utils import u64 as tu64

M32 = 0xFFFFFFFF
M64 = np.uint64(2**64 - 1)
CASES = global_build_cases()


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _hash(keys: np.ndarray) -> np.ndarray:
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(M32)).astype(np.uint32)
    return _fmix32(_fmix32(lo) ^ (hi * np.uint32(0x9E3779B9)))


def _bloom_word(h: np.ndarray, k: int) -> np.ndarray:
    g = (h * np.uint32(0x9E3779B9) + np.uint32(1)).astype(np.uint64)
    word = np.zeros(h.shape, np.uint64)
    for i in range(k):
        word |= np.uint64(1) << ((g >> np.uint64(5 * i)) & np.uint64(31))
    return word


def bucket_model(case, seed: int = 0) -> dict:
    """The build kernel's algorithm in numpy: keys, vals (total_groups, 2G),
    bloom and special as int64 arrays of u32 values."""
    cfg, gbits = case.cfg, case.gbits
    G, ngroups = cfg.group_size, 1 << gbits
    ntot = ngroups + cfg.overflow_groups
    n = max(0, min(case.valid_rows(), case.build_keys.size))
    bk, bv = case.build_keys[:n], case.build_values[:n]
    keys = np.full((ntot, 2 * G), M32, np.int64)
    vals = np.zeros((ntot, 2 * G), np.int64)
    bloom = np.zeros(ntot if case.use_bloom else 1, np.int64)
    special = np.zeros(4, np.int64)

    is_max = bk == M64
    if is_max.any():                     # the first u64-max row's value
        v = int(bv[np.argmax(is_max)])
        special[:3] = 1, v >> 32, v & M32
    h = _hash(bk)
    home = ((h.astype(np.uint64) << np.uint64(case.pre_shift))
            & np.uint64(M32)) >> np.uint64(32 - gbits)
    home = home.astype(np.int64)
    real = np.flatnonzero(~is_max)
    if case.use_bloom:                   # an OR a row at its home group
        np.bitwise_or.at(bloom, home[real],
                         _bloom_word(h[real], cfg.bloom_k).astype(np.int64))

    # counts, their exclusive scan, and each row's id at its group's cursor
    # in an arbitrary order
    counts = np.bincount(home[real], minlength=ngroups)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    perm = np.empty(real.size, np.int64)
    cursor = offsets[:-1].copy()
    for r in np.random.default_rng(seed).permutation(real):
        perm[cursor[home[r]]] = r
        cursor[home[r]] += 1

    end = 0
    for b in range(ngroups):
        group = perm[offsets[b]:offsets[b + 1]]
        ordered = sorted((int(bk[r]), int(r)) for r in group)
        kept = [r for i, (k, r) in enumerate(ordered)
                if i == 0 or k != ordered[i - 1][0]]
        start = max(end, b * G)
        for j, r in enumerate(kept):
            slot = start + j
            if slot >= ntot * G:
                special[3] += 1
                continue
            g, q = divmod(slot, G)
            k, v = int(bk[r]), int(bv[r])
            keys[g, q], keys[g, G + q] = k >> 32, k & M32
            vals[g, q], vals[g, G + q] = v >> 32, v & M32
            if case.max_probe_iters is not None and \
                    g - b >= case.max_probe_iters:
                special[3] += 1          # written, but out of the walk's reach
        end = start + len(kept)
    return dict(keys=keys, vals=vals, bloom=bloom, special=special)


def _planes(case):
    kh, kl = ju64.split_u64(case.build_keys)
    vh, vl = ju64.split_u64(case.build_values)
    return kh, kl, vh, vl


def _jax_table(case) -> dict:
    kw = case.build_kwargs()
    jt = jht.build_table(*(jnp.asarray(a) for a in _planes(case)),
                         case.valid_rows(), **kw)
    return {f: np.asarray(getattr(jt, f)).astype(np.int64)
            for f in ("keys", "vals", "bloom", "special")}


def _port_table(case, fn) -> dict:
    tt = fn(*(tu64.to_device(a, "cpu") for a in _planes(case)),
            case.valid_rows(), **case.build_kwargs())
    return {f: tu64.widen(getattr(tt, f)).numpy()
            for f in ("keys", "vals", "bloom", "special")}


def _assert_same(got: dict, want: dict, what: str):
    for f in ("keys", "vals", "bloom", "special"):
        assert got[f].shape == want[f].shape, (what, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_bucket_model_equals_jax_and_plain_build(case):
    model = bucket_model(case)
    if case.build_keys.size:     # the JAX build refuses an empty side
        _assert_same(model, _jax_table(case), "model vs JAX")
    _assert_same(_port_table(case, tht.build_table_plain), model,
                 "build_table_plain vs model")


def test_bucket_model_ignores_the_order_inside_a_group():
    # the kernel's atomics leave a group's rows in any order
    case = next(c for c in CASES if c.name == "one_large_group_bloom")
    _assert_same(bucket_model(case, seed=1), bucket_model(case, seed=2),
                 "two visiting orders")


def test_cases_cover_the_build_edges():
    # what each case is there for, read off the model's table
    by = {c.name: (c, bucket_model(c)) for c in CASES}

    def written(t):
        G = t["keys"].shape[1] // 2
        return int(((t["keys"][:, :G] != M32) | (t["keys"][:, G:] != M32))
                   .sum())

    c, t = by["crowded"]                                   # past the table
    unique = np.unique(c.build_keys).size
    assert written(t) < unique and t["special"][3] == unique - written(t)
    c, t = by["max_probe_iters_2"]          # counted as dropped, yet written
    assert written(t) == np.unique(c.build_keys).size and t["special"][3] > 0
    assert int(by["u64_max_repeated"][1]["special"][0]) == 1
    assert int(by["n_valid_cut"][1]["special"][0]) == 0    # max past the cut
    c, t = by["one_large_group"]
    h = _hash(c.build_keys)
    assert len(set((h >> np.uint32(28)).tolist())) == 1    # one home group
    assert c.build_keys.size > 2048 and t["special"][3] > 0
    assert {c.cfg.group_size for c in CASES} >= {1, 2, 8, 32}
    assert {c.pre_shift for c in CASES} >= {1, 2, 3}
    assert (by["duplicates_bloom"][1]["bloom"] != 0).any()


def test_build_table_on_cpu_takes_the_plain_build(monkeypatch):
    case = CASES[0]
    calls = []

    def kernel(*a, **kw):
        raise AssertionError("the build kernel was called on CPU tensors")

    def plain(*a, **kw):
        calls.append(1)
        return plain_build(*a, **kw)

    plain_build = tht.build_table_plain
    monkeypatch.setattr(hash_build, "global_build_table", kernel)
    monkeypatch.setattr(tht, "build_table_plain", plain)
    _assert_same(_port_table(case, tht.build_table), bucket_model(case),
                 "build_table on the CPU")
    assert calls == [1]


def test_build_kernel_wrapper_refuses_what_it_does_not_take():
    planes = [torch.zeros(8, dtype=torch.int32) for _ in range(4)]
    kw = dict(gbits=4, group_size=8, overflow_groups=64, with_bloom=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hash_build.global_build_table(*planes, 8, **kw)
    before = hash_build.global_build_table.launches
    tht.build_table(*planes, 8, **kw)                      # the plain build
    assert hash_build.global_build_table.launches == before
