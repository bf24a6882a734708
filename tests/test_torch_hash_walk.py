"""The `global` tier's walk, written out as the CUDA kernel runs it
(csrc/hash_walk.cu): a scalar numpy walk, one probe at a time, at most
max_iters groups a probe.  It must equal the JAX package's probe_count /
probe_materialize (a lax.while_loop that bounds a whole chunk in lockstep,
on the CPU) and the port's plain walk (ops/hash_table.py), which the CPU
takes, on the same tables.  That shows that the per-probe bound of the
kernel gives JAX's lockstep result.

Inputs come from numpy seeds, handed to both packages.  Tolerance: exact
(counts, hit masks and u32 value bit patterns).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops import hash_table as jht
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu_torch.models.workload import global_walk_cases
from flash_hash_join_tpu_torch.ops import hash_table as tht
from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
from flash_hash_join_tpu_torch.utils import u64 as tu64
from flash_hash_join_tpu_torch.utils.config import JoinConfig

M32 = 0xFFFFFFFF
M64 = np.uint64(2**64 - 1)


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _hash(hi: int, lo: int) -> int:
    return _fmix32(_fmix32(lo) ^ ((hi * 0x9E3779B9) & M32))


def _bloom_word(h: int, k: int) -> int:
    g = (h * 0x9E3779B9 + 1) & M32
    word = 0
    for i in range(k):
        word |= 1 << ((g >> (5 * i)) & 31)
    return word


def _home(h: int, gbits: int, pre_shift: int) -> int:
    return ((h << pre_shift) & M32) >> (32 - gbits)


def scalar_walk(table, pk: np.ndarray, n_valid: int, *, gbits, group_size,
                total_groups, use_bloom, bloom_k, max_iters, pre_shift=0):
    """The kernel's algorithm, one probe row at a time: (hit, vh, vl,
    visits) per row, as numpy arrays."""
    G = group_size
    keys = tu64.widen(table.keys).numpy()
    vals = tu64.widen(table.vals).numpy()
    bloom = table.bloom.numpy()
    has_max, max_vh, max_vl, _ = table.special.tolist()
    n = len(pk)
    hit = np.zeros(n, bool)
    vh = np.zeros(n, np.int64)
    vl = np.zeros(n, np.int64)
    visits = np.zeros(n, np.int64)
    for i in range(min(n_valid, n)):
        kh, kl = int(pk[i]) >> 32, int(pk[i]) & M32
        if kh == M32 and kl == M32:
            if has_max > 0:
                hit[i], vh[i], vl[i] = True, max_vh, max_vl
            continue
        h = _hash(kh, kl)
        g = _home(h, gbits, pre_shift)
        if use_bloom:
            tag = _bloom_word(h, bloom_k)
            if int(bloom[g]) & tag != tag:
                continue
        for _ in range(max_iters):
            row = keys[g]
            visits[i] += 1
            match = [q for q in range(G) if row[q] == kh and row[G + q] == kl]
            if match:
                j = match[0]
                hit[i], vh[i], vl[i] = True, vals[g, j], vals[g, G + j]
                break
            if any(row[q] == M32 and row[G + q] == M32 for q in range(G)):
                break
            if g + 1 >= total_groups:
                break
            g += 1
    return hit, vh, vl, visits


def _static(cfg: JoinConfig, gbits: int, use_bloom: bool, pre_shift: int):
    return dict(gbits=gbits, group_size=cfg.group_size,
                total_groups=(1 << gbits) + cfg.overflow_groups,
                use_bloom=use_bloom, bloom_k=cfg.bloom_k,
                max_iters=cfg.max_probe_iters, pre_shift=pre_shift)


def _tables(bk, bv, cfg: JoinConfig, gbits: int, use_bloom: bool,
            pre_shift: int):
    """The JAX package's table and the port's, from the same columns;
    the port's equals the JAX package's element for element."""
    kh, kl = ju64.split_u64(bk)
    vh, vl = ju64.split_u64(bv)
    kw = dict(gbits=gbits, group_size=cfg.group_size,
              overflow_groups=cfg.overflow_groups, with_bloom=use_bloom,
              bloom_k=cfg.bloom_k, pre_shift=pre_shift,
              max_probe_iters=cfg.max_probe_iters)
    jt = jht.build_table(*(jnp.asarray(a) for a in (kh, kl, vh, vl)),
                         len(bk), **kw)
    tt = tht.build_table(*(tu64.to_device(a, "cpu") for a in (kh, kl, vh, vl)),
                         len(bk), **kw)
    for name in ("keys", "vals", "bloom", "special"):
        np.testing.assert_array_equal(
            tu64.widen(getattr(tt, name)).numpy(),
            np.asarray(getattr(jt, name)).astype(np.int64), err_msg=name)
    return jt, tt


def _check_walks(bk, bv, pk, *, cfg: JoinConfig, gbits: int, use_bloom: bool,
                 pre_shift: int = 0, n_valid: int | None = None,
                 probe_chunk: int = 64):
    """The scalar walk == the port's plain walk (row by row) == the JAX
    package (count and materialized rows, probe order), and the port's
    materialize == the scalar walk's hit rows.  Returns the scalar walk."""
    n_valid = len(pk) if n_valid is None else n_valid
    static = _static(cfg, gbits, use_bloom, pre_shift)
    jt, tt = _tables(bk, bv, cfg, gbits, use_bloom, pre_shift)
    hit, vh, vl, visits = scalar_walk(tt, pk, n_valid, **static)
    want_keys = pk[hit]
    want_vals = (vh[hit].astype(np.uint64) << np.uint64(32)) | vl[hit].astype(
        np.uint64)

    ph, pl = ju64.split_u64(pk)
    tph, tpl = tu64.to_device(ph, "cpu"), tu64.to_device(pl, "cpu")
    launches = (hw.global_walk_count.launches,
                hw.global_walk_materialize.launches)
    thit, tvh, tvl = tht.probe_rows(tt, tph, tpl, n_valid,
                                    probe_chunk=probe_chunk, **static)
    np.testing.assert_array_equal(thit.numpy(), hit)
    np.testing.assert_array_equal(tu64.widen(tvh).numpy(), vh)
    np.testing.assert_array_equal(tu64.widen(tvl).numpy(), vl)
    assert int(tht.probe_count(tt, tph, tpl, n_valid, probe_chunk=probe_chunk,
                               **static)) == hit.sum()
    out = tht.probe_materialize(tt, tph, tpl, n_valid,
                                probe_chunk=probe_chunk, **static)
    c = int(out[0])
    assert c == hit.sum()
    np.testing.assert_array_equal(tu64.to_numpy_u64(out[1], out[2], c),
                                  want_keys)
    np.testing.assert_array_equal(tu64.to_numpy_u64(out[3], out[4], c),
                                  want_vals)
    # CPU tensors take the plain walk: the kernel is never launched
    assert (hw.global_walk_count.launches,
            hw.global_walk_materialize.launches) == launches

    jargs = (jnp.asarray(ph), jnp.asarray(pl), n_valid)
    assert int(jht.probe_count(jt, *jargs, probe_chunk=probe_chunk,
                               **static)) == hit.sum()
    jout = jht.probe_materialize(jt, *jargs, probe_chunk=probe_chunk,
                                 **static)
    assert int(jout[0]) == hit.sum()
    np.testing.assert_array_equal(
        ju64.join_u64(np.asarray(jout[1]), np.asarray(jout[2]))[:c], want_keys)
    np.testing.assert_array_equal(
        ju64.join_u64(np.asarray(jout[3]), np.asarray(jout[4]))[:c], want_vals)
    return hit, visits


def _keys_homed(rng, n: int, gbits: int, pre_shift: int, homes) -> np.ndarray:
    """n distinct random u64 keys whose home group is in `homes`."""
    out = []
    while len(out) < n:
        k = rng.integers(0, 2**64, 4 * n + 64, dtype=np.uint64)
        for x in k.tolist():
            if _home(_hash(x >> 32, x & M32), gbits, pre_shift) in homes:
                out.append(x)
    return np.unique(np.array(out[:n], np.uint64))


CROWDED = JoinConfig(group_size=2, overflow_groups=3, probe_chunk=64)


@pytest.mark.parametrize("use_bloom", [False, True])
@pytest.mark.parametrize("pre_shift", [0, 2])
def test_crowded_chains_run_into_the_last_group(use_bloom, pre_shift):
    # 16 home groups of 2 slots and 3 overflow groups; 18 keys homed in the
    # last 3 home groups fill them and spill through every overflow group,
    # so chains cross groups and end at the table's last group
    rng = np.random.default_rng(1 + pre_shift)
    gbits = 4
    bk = _keys_homed(rng, 18, gbits, pre_shift, {13, 14, 15})
    bk = np.concatenate([bk, _keys_homed(rng, 6, gbits, pre_shift,
                                         set(range(8)))])
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    absent = _keys_homed(rng, 40, gbits, pre_shift, {13, 14, 15})
    pk = np.concatenate([bk, absent, rng.integers(0, 2**64, 200,
                                                  dtype=np.uint64)])
    rng.shuffle(pk)
    hit, visits = _check_walks(bk, bv, pk, cfg=CROWDED, gbits=gbits,
                               use_bloom=use_bloom, pre_shift=pre_shift)
    _, tt = _tables(bk, bv, CROWDED, gbits, use_bloom, pre_shift)
    assert int(tt.special[3]) > 0             # chains ran past the end ...
    assert (tt.keys[-1] != -1).all()          # ... so the last group is full
    assert visits.max() >= 4 if not use_bloom else visits.max() >= 2
    assert 0 < hit.sum() <= len(bk)


@pytest.mark.parametrize("use_bloom", [False, True])
def test_max_probe_iters_binds_for_absent_probes(use_bloom):
    rng = np.random.default_rng(5)
    gbits = 4
    cfg = JoinConfig(group_size=2, overflow_groups=8, max_probe_iters=2,
                     probe_chunk=64)
    bk = _keys_homed(rng, 16, gbits, 0, {3, 4, 5})
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    absent = _keys_homed(rng, 60, gbits, 0, {3, 4})
    pk = np.concatenate([bk, absent])
    rng.shuffle(pk)
    hit, visits = _check_walks(bk, bv, pk, cfg=cfg, gbits=gbits,
                               use_bloom=use_bloom)
    assert visits.max() == 2
    # without the bound the same absent probes walk further
    static = _static(JoinConfig(group_size=2, overflow_groups=8), gbits,
                     use_bloom, 0)
    _, tt = _tables(bk, bv, cfg, gbits, use_bloom, 0)
    assert scalar_walk(tt, pk, len(pk), **static)[3].max() > 2


@pytest.mark.parametrize("use_bloom", [False, True])
@pytest.mark.parametrize("build_max", [False, True])
def test_u64_max_probe_rides_special(use_bloom, build_max):
    rng = np.random.default_rng(11)
    bk = rng.integers(0, 2**64, 300, dtype=np.uint64)
    if build_max:
        bk[[7, 100]] = M64                    # the first is the winner
    bv = rng.integers(0, 2**64, 300, dtype=np.uint64)
    pk = np.concatenate([[M64], bk[:50], [M64],
                         rng.integers(0, 2**64, 50, dtype=np.uint64)])
    cfg = JoinConfig(probe_chunk=32)
    hit, _ = _check_walks(bk, bv, pk, cfg=cfg, gbits=cfg.group_bits(300),
                          use_bloom=use_bloom)
    assert hit[0] == hit[51] == build_max


@pytest.mark.parametrize("use_bloom", [False, True])
def test_duplicate_build_keys_take_the_minimum_row(use_bloom):
    rng = np.random.default_rng(12)
    bk = rng.integers(0, 500, 2_000, dtype=np.uint64)
    bv = np.arange(2_000, dtype=np.uint64)
    pk = rng.integers(0, 600, 3_000, dtype=np.uint64)
    cfg = JoinConfig(probe_chunk=512)
    hit, _ = _check_walks(bk, bv, pk, cfg=cfg, gbits=cfg.group_bits(2_000),
                          use_bloom=use_bloom)
    first = {}
    for row, k in enumerate(bk.tolist()):
        first.setdefault(k, row)
    _, tt = _tables(bk, bv, cfg, cfg.group_bits(2_000), use_bloom, 0)
    static = _static(cfg, cfg.group_bits(2_000), use_bloom, 0)
    _, _, vl, _ = scalar_walk(tt, pk, len(pk), **static)
    assert [int(v) for v in vl[hit]] == [first[k] for k in pk[hit].tolist()]


@pytest.mark.parametrize("use_bloom", [False, True])
@pytest.mark.parametrize("n_valid", [0, 1, 777])
def test_n_valid_cut_mid_array(use_bloom, n_valid):
    rng = np.random.default_rng(13)
    bk = rng.integers(0, 2**64, 1_000, dtype=np.uint64)
    bv = rng.integers(0, 2**64, 1_000, dtype=np.uint64)
    pk = np.concatenate([bk[:900], [M64]])
    rng.shuffle(pk)
    cfg = JoinConfig(probe_chunk=128)
    hit, _ = _check_walks(np.concatenate([bk, [M64]]),
                          np.concatenate([bv, [5]]), pk, cfg=cfg,
                          gbits=cfg.group_bits(1_001), use_bloom=use_bloom,
                          n_valid=n_valid, probe_chunk=128)
    assert not hit[n_valid:].any() and hit.sum() == n_valid


@pytest.mark.parametrize("use_bloom", [False, True])
@pytest.mark.parametrize("pre_shift", [1, 3])
def test_pre_shift_tables(use_bloom, pre_shift):
    # a distributed rank's table: its keys share the top pre_shift hash
    # bits, and the home group is read below them
    rng = np.random.default_rng(14 + pre_shift)
    cfg = JoinConfig(probe_chunk=256)
    gbits = cfg.group_bits(800)
    bk = _keys_homed(rng, 800, pre_shift, 0, {1})   # top bits: rank 1
    bv = rng.integers(0, 2**64, len(bk), dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 500),
                         _keys_homed(rng, 500, pre_shift, 0, {1})])
    rng.shuffle(pk)
    hit, _ = _check_walks(bk, bv, pk, cfg=cfg, gbits=gbits,
                          use_bloom=use_bloom, pre_shift=pre_shift,
                          probe_chunk=256)
    assert hit.sum() >= 500


@pytest.mark.parametrize("use_bloom", [False, True])
def test_empty_probe_side(use_bloom):
    rng = np.random.default_rng(15)
    bk = rng.integers(0, 2**64, 100, dtype=np.uint64)
    cfg = JoinConfig(probe_chunk=64)
    hit, _ = _check_walks(bk, bk, np.zeros(0, np.uint64), cfg=cfg,
                          gbits=cfg.group_bits(100), use_bloom=use_bloom)
    assert hit.size == 0


@pytest.mark.parametrize("case", global_walk_cases(), ids=lambda c: c.name)
def test_card_edge_cases_match_jax(case):
    # the cases the card tests and chip_smoke.py hold the kernel to
    _check_walks(case.build_keys, case.build_values, case.probe_keys,
                 cfg=case.cfg, gbits=case.gbits, use_bloom=case.use_bloom,
                 pre_shift=case.pre_shift, n_valid=case.n_valid,
                 probe_chunk=256)


def test_walk_stats_count_groups_without_a_sync_per_chunk():
    rng = np.random.default_rng(16)
    bk = rng.integers(0, 2**64, 2_000, dtype=np.uint64)
    pk = np.concatenate([bk, rng.integers(0, 2**64, 2_000, dtype=np.uint64)])
    cfg = JoinConfig(probe_chunk=1_000)
    gbits = cfg.group_bits(2_000)
    static = _static(cfg, gbits, False, 0)
    _, tt = _tables(bk, bk, cfg, gbits, False, 0)
    _, _, _, visits = scalar_walk(tt, pk, 3_500, **static)
    ph, pl = ju64.split_u64(pk)
    tht.walk_stats.reset()
    tht.probe_count(tt, tu64.to_device(ph, "cpu"), tu64.to_device(pl, "cpu"),
                    3_500, probe_chunk=1_000, **static)
    stats = tht.walk_stats.read()
    assert stats["chunks"] == 4 and stats["probes"] == 3_500
    assert stats["groups"] == visits.sum()
    assert stats["longest"] == visits.max()
    assert stats["groups_per_probe"] == visits.sum() / 3_500


def test_walk_wrappers_refuse_cpu_tensors():
    bk = np.arange(10, dtype=np.uint64)
    cfg = JoinConfig()
    gbits = cfg.group_bits(10)
    _, tt = _tables(bk, bk, cfg, gbits, False, 0)
    ph = torch.zeros(4, dtype=torch.int32)
    static = _static(cfg, gbits, False, 0)
    for fn in (hw.global_walk_count, hw.global_walk_materialize):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(tt, ph, ph, 4, **static)
