"""The port's distributed tier (flash_hash_join_tpu_torch/parallel/) against
the JAX package's on the CPU.

The JAX tier runs on the conftest's 8 virtual CPU devices; the port on an
in-process mesh of ["cpu"] * n ranks (n = 1, 2, 4, 8) and, in one test,
on two processes over gloo (parallel/worker.py).  Inputs come from numpy
seeds and divide evenly into 8, so the port's shards (np.array_split)
are the JAX package's.  Tolerance: 0 — counts, received rows, hot sets
and materialized (key, value) rows are exact integers.

Designed differences, each checked here: the port's exchange is ragged
(overflow is always 0, where JAX drops past its quota); its winner among
duplicate build keys is the minimum build row (JAX's sort leaves it
open, so JAX's values are compared only on unique build keys); a rank
whose table drops build rows reruns on merge (JAX regrows its quota).
"""

import collections
import inspect
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import flash_hash_join_tpu as fj
import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu.parallel import hotkeys as jhk
from flash_hash_join_tpu.parallel import shuffle as jsh
from flash_hash_join_tpu.parallel.distributed_join import (
    build_distributed_join, shard_columns as jshard)
from flash_hash_join_tpu.parallel.mesh import data_mesh as jmesh
from flash_hash_join_tpu.utils import u64 as ju64
from flash_hash_join_tpu.utils.config import JoinConfig as JConfig
from flash_hash_join_tpu_torch.parallel import hotkeys as hk
from flash_hash_join_tpu_torch.parallel import shuffle as sh
from flash_hash_join_tpu_torch.parallel.distributed_join import (
    distributed_join_exact, shard_columns)
from flash_hash_join_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                       run_workers)
from flash_hash_join_tpu_torch.parallel.mesh import data_mesh
from flash_hash_join_tpu_torch.utils.config import JoinConfig
from flash_hash_join_tpu_torch.utils.u64 import device_planes
from tests.oracle import oracle_count

JCFG = JConfig(probe_chunk=1 << 12)
CFG = JoinConfig(probe_chunk=1 << 12)
M64 = 2**64 - 1


def _cols(rng, nb, npr, match=0.5, dup=False):
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    if dup:
        bk = np.concatenate([bk[: nb // 2]] * 2)[:nb]
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    nm = int(npr * match)
    pk = np.concatenate([rng.choice(bk, nm),
                         rng.integers(0, 2**64, npr - nm, dtype=np.uint64)])
    rng.shuffle(pk)
    return bk, bv, pk


def _zipf(rng, nb, npr):
    bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    return bk, bv, bk[np.minimum(rng.zipf(1.2, npr) - 1, nb - 1)]


def _max_skew(rng, nb, npr):
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    return bk, bv, np.full(npr, bk[0], dtype=np.uint64)


CASES = {  # name -> (make, nb, npr, use_bloom)
    "uniform": (lambda r, nb, npr: _cols(r, nb, npr), 4096, 16384, False),
    "uniform-bloom": (lambda r, nb, npr: _cols(r, nb, npr), 4096, 16384,
                      True),
    "duplicates": (lambda r, nb, npr: _cols(r, nb, npr, dup=True), 4096,
                   8192, False),
    "zipf-1.2": (_zipf, 2048, 16384, False),
    "max-skew": (_max_skew, 1024, 8192, False),
}


def _case(name, seed=10):
    make, nb, npr, use_bloom = CASES[name]
    return (*make(np.random.default_rng(seed), nb, npr), use_bloom)


def _jax_join(bk, bv, pk, *, ndev=8, **kw):
    """The JAX tier on `ndev` virtual devices (lengths divisible by it)."""
    mesh = jmesh(ndev)
    fn = build_distributed_join(mesh, len(bk) // ndev, len(pk) // ndev,
                                cfg=JCFG, **kw)
    planes = [*ju64.split_u64(bk), *ju64.split_u64(bv), *ju64.split_u64(pk)]
    return fn(*jshard(mesh, planes), jnp.int32(len(bk)), jnp.int32(len(pk)))


def _min_row_pairs(bk, bv, pk):
    """The numpy oracle's matched (key, value) rows, sorted, each value the
    key's minimum build row's."""
    uniq, first = np.unique(bk, return_index=True)
    pos = np.searchsorted(uniq, pk).clip(max=uniq.size - 1)
    hit = uniq[pos] == pk
    return _sorted(pk[hit], bv[first[pos[hit]]])


def _sorted(keys, vals):
    order = np.lexsort((vals, keys))
    return keys[order], vals[order]


def _per_shard(jax_out, ndev=8):
    return [np.asarray(x).reshape(ndev, -1) for x in jax_out]


# ---- shuffle and hot keys ---------------------------------------------------

@pytest.mark.parametrize("dbits", [0, 1, 2, 3])
def test_dest_device_matches_jax(dbits):
    rng = np.random.default_rng(dbits)
    keys = np.concatenate([rng.integers(0, 2**64, 5000, dtype=np.uint64),
                           np.array([0, 2**32 - 1, M64], dtype=np.uint64)])
    kh, kl = ju64.split_u64(keys)
    want = np.asarray(jsh.dest_device(jnp.asarray(kh), jnp.asarray(kl),
                                      dbits))
    got = sh.dest_device(*device_planes(keys, "cpu"), dbits)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert got.max() < 2**dbits


def _jax_shuffle(cols, ndev, quota, send=None):
    """JAX's hash_shuffle under shard_map: each shard's valid received
    rows, as a list of (m, ncols) uint32 arrays."""
    mesh = jmesh(ndev)
    dbits = ndev.bit_length() - 1

    def body(*c):
        valid = (jnp.ones(c[0].shape, jnp.bool_) if send is None
                 else c[-1] > 0)
        c = c[:4]
        recv, rvalid, ov = jsh.hash_shuffle(
            c, jsh.dest_device(c[0], c[1], dbits), valid, ndev=ndev,
            quota=quota, axis_name="x")
        return (*recv, rvalid, ov[None])

    args = list(cols) + ([] if send is None else [send.astype(np.uint32)])
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),) * len(args),
                           out_specs=(P("x"),) * 6, check_vma=False))
    out = fn(*jshard(mesh, args))
    assert int(np.asarray(out[5]).sum()) == 0, "quota overflow"
    cols_r = [np.asarray(x).reshape(ndev, -1) for x in out[:4]]
    valid = np.asarray(out[4]).reshape(ndev, -1)
    return [np.stack([c[d][valid[d]] for c in cols_r], 1)
            for d in range(ndev)]


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("with_mask", [False, True])
def test_shuffle_received_rows_match_jax(ndev, with_mask):
    rng = np.random.default_rng(ndev)
    n = 512 * ndev
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    keys[::7] = keys[0]                        # a duplicate run
    vals = rng.integers(0, 2**64, n, dtype=np.uint64)
    send = rng.random(n) < 0.7 if with_mask else None
    planes = [*ju64.split_u64(keys), *ju64.split_u64(vals)]
    want = _jax_shuffle(planes, ndev, quota=n, send=send)

    mesh = data_mesh(devices=["cpu"] * ndev)
    shards = shard_columns(mesh, (keys, vals))
    dbits = ndev.bit_length() - 1
    masks = (None if send is None else
             [torch.from_numpy(m) for m in np.array_split(send, ndev)])
    got, overflow = sh.hash_shuffle(
        mesh, [tuple(s) for s in shards],
        [sh.dest_device(s[0], s[1], dbits) for s in shards], masks)
    assert overflow == 0
    dest = np.asarray(jsh.dest_device(jnp.asarray(planes[0]),
                                      jnp.asarray(planes[1]), dbits))
    rows = np.stack(planes, 1)
    sent = np.ones(n, bool) if send is None else send
    for d in range(ndev):
        mine = np.stack([c.numpy().view(np.uint32) for c in got[d]], 1)
        # the JAX shuffle's valid rows, as a multiset
        assert sorted(map(tuple, mine)) == sorted(map(tuple, want[d]))
        # the port's order: source ranks in order, each source's rows in
        # their original order, i.e. global row order
        assert np.array_equal(mine, rows[(dest == d) & sent])


def _jax_hot_set(pk, ndev=8):
    mesh = jmesh(ndev)

    def body(ph, pl):
        hot = jhk.detect_hot_keys(ph, pl, jnp.ones(ph.shape, jnp.bool_),
                                  axis_name="x")
        return hot.kh, hot.kl, hot.used

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("x"),) * 2,
                           out_specs=(P(),) * 3, check_vma=False))
    return [np.asarray(x) for x in fn(*jshard(mesh, list(ju64.split_u64(pk))))]


@pytest.mark.parametrize("name", ["zipf-1.2", "max-skew", "uniform"])
def test_hot_set_matches_jax(name):
    bk, bv, pk, _ = _case(name)
    jkh, jkl, jused = _jax_hot_set(pk)
    mesh = data_mesh(devices=["cpu"] * 8)
    probe = [s[4:] for s in shard_columns(mesh, (bk, bv, pk))]
    hot = hk.detect_hot_keys(mesh, [p[0] for p in probe],
                             [p[1] for p in probe])
    for h in hot:
        assert np.array_equal(h.kh.numpy().view(np.uint32), jkh)
        assert np.array_equal(h.kl.numpy().view(np.uint32), jkl)
        assert np.array_equal(h.used.numpy(), jused)
    assert (hot[0].keys.numel() > 0) == (name != "uniform")


def test_membership_and_hot_build_rows():
    """is_member by a sorted search equals a set lookup; each rank's first
    row of each hot key is replicated in rank order."""
    rng = np.random.default_rng(5)
    bk = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    bk[100::300] = bk[5]                       # a hot key on several ranks
    bv = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    hot_keys = np.unique(bk[[5, 7, 4000]])
    pk = np.concatenate([np.repeat(hot_keys, 3000), bk[:1000]])
    mesh = data_mesh(devices=["cpu"] * 4)
    shards = shard_columns(mesh, (bk, bv, pk))
    hot = hk.detect_hot_keys(mesh, [s[4] for s in shards],
                             [s[5] for s in shards])
    got = ju64.join_u64(hot[0].kh.numpy().view(np.uint32),
                        hot[0].kl.numpy().view(np.uint32))
    assert np.array_equal(got[hot[0].used.numpy()], hot_keys)
    for s, h in zip(shards, hot):
        member = hk.is_member(s[0], s[1], h).numpy()
        keys = ju64.join_u64(s[0].numpy().view(np.uint32),
                             s[1].numpy().view(np.uint32))
        assert np.array_equal(member, np.isin(keys, hot_keys))
    rows = hk.gather_hot_build_rows(mesh, [tuple(s[:4]) for s in shards],
                                    hot)
    want = []
    for piece_k, piece_v in zip(np.array_split(bk, 4),
                                np.array_split(bv, 4)):
        for k in hot_keys:
            at = np.flatnonzero(piece_k == k)
            if at.size:
                want.append((k, piece_v[at[0]]))
    for r in rows:
        r = r.numpy().view(np.uint32)
        pairs = list(zip(ju64.join_u64(r[:, 0], r[:, 1]),
                         ju64.join_u64(r[:, 2], r[:, 3])))
        assert pairs == want


def test_zipf_case_in_threads_keeps_its_build_side_and_distribution():
    """zipf_probe_case(threads=4) (the smoke's 2.5e8-row draw): the same
    build side as threads=1, other probe draws from the same Zipf-1.2."""
    from flash_hash_join_tpu_torch.models.workload import zipf_probe_case
    one = zipf_probe_case(2000, 200_000, seed=2)
    four = zipf_probe_case(2000, 200_000, seed=2, threads=4)
    assert np.array_equal(one.build_keys, four.build_keys)
    assert np.array_equal(one.build_values, four.build_values)
    assert not np.array_equal(one.probe_keys, four.probe_keys)
    assert np.isin(four.probe_keys, four.build_keys).all()
    share = [np.bincount(np.searchsorted(c.build_keys, c.probe_keys),
                         minlength=2000)[:8] / 200_000 for c in (one, four)]
    # the top ranks' shares (18 % down to 2 %) agree within sampling error
    assert np.abs(share[0] - share[1]).max() < 0.005


# ---- the join ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_count_matches_jax_and_oracle(name):
    bk, bv, pk, use_bloom = _case(name)
    jcount, overflow = _jax_join(bk, bv, pk, use_bloom=use_bloom)
    assert int(overflow) == 0
    want = oracle_count(bk, pk)
    assert int(jcount) == want
    for ndev in (1, 2, 4, 8):
        mesh = data_mesh(devices=["cpu"] * ndev)
        res = distributed_join_exact(mesh, bk, bv, pk, cfg=CFG,
                                     use_bloom=use_bloom)
        assert res.count == want, ndev
        assert res.info["overflow"] == 0 and res.info["drops"] == 0
        assert sum(res.info["probe_rows"]) == len(pk)
        assert sum(res.info["build_rows"]) >= len(bk) - res.info["hot_keys"]


def test_hot_keys_off_jax_overflows_port_exact():
    bk, bv, pk, _ = _case("max-skew")
    _, overflow = _jax_join(bk, bv, pk, quota_factor=1.0, hot_cap=0)
    assert int(overflow) > 0
    res = distributed_join_exact(data_mesh(devices=["cpu"] * 8), bk, bv, pk,
                                 cfg=CFG, hot_cap=0)
    assert res.count == oracle_count(bk, pk)
    assert res.info["overflow"] == 0 and res.info["hot_keys"] == 0
    # every probe hashes to one rank, which receives them all
    assert sorted(res.info["probe_rows"])[-1] == len(pk)


@pytest.mark.parametrize("name", ["zipf-1.2", "duplicates", "uniform-bloom"])
def test_materialize_matches_jax_and_oracle(name):
    bk, bv, pk, use_bloom = _case(name, seed=12)
    gcount, overflow, counts, *planes = _jax_join(
        bk, bv, pk, use_bloom=use_bloom, materialize=True)
    assert int(overflow) == 0
    counts = np.asarray(counts)
    okh, okl, ovh, ovl = _per_shard(planes)
    jkeys = [ju64.join_u64(okh[d][:c], okl[d][:c])
             for d, c in enumerate(counts)]
    jvals = np.concatenate([ju64.join_u64(ovh[d][:c], ovl[d][:c])
                            for d, c in enumerate(counts)])

    res = distributed_join_exact(data_mesh(devices=["cpu"] * 8), bk, bv, pk,
                                 cfg=CFG, use_bloom=use_bloom,
                                 materialize=True)
    want_k, want_v = _min_row_pairs(bk, bv, pk)
    assert res.count == int(gcount) == len(want_k)
    assert res.info["rank_counts"] == counts.tolist()
    got_k, got_v = _sorted(res.keys, res.values)
    assert np.array_equal(got_k, want_k) and np.array_equal(got_v, want_v)
    assert np.array_equal(np.sort(np.concatenate(jkeys)), want_k)
    if np.unique(bk).size == bk.size:
        assert np.array_equal(_sorted(np.concatenate(jkeys), jvals)[1],
                              want_v)
    # rank order: rank d's rows, the d-th slice of the output, are the keys
    # JAX's shard d emits
    bounds = np.cumsum([0, *res.info["rank_counts"]])
    for d, k in enumerate(jkeys):
        assert np.array_equal(np.sort(res.keys[bounds[d]:bounds[d + 1]]),
                              np.sort(k))


def test_forced_build_drop_reruns_on_merge():
    """max_probe_iters=1 drops every build row past its home group: each
    such rank reruns its local join on merge, exactly."""
    rng = np.random.default_rng(30)
    bk, bv, pk = _cols(rng, 4096, 8192, match=0.7, dup=True)
    cfg = JoinConfig(probe_chunk=1 << 12, max_probe_iters=1, group_size=2)
    mesh = data_mesh(devices=["cpu"] * 4)
    res = distributed_join_exact(mesh, bk, bv, pk, cfg=cfg)
    assert res.count == oracle_count(bk, pk)
    assert res.info["drops"] > 0 and res.info["reruns"] > 0
    mat = distributed_join_exact(mesh, bk, bv, pk, cfg=cfg, materialize=True)
    assert mat.info["reruns"] == res.info["reruns"]
    want_k, want_v = _min_row_pairs(bk, bv, pk)
    got_k, got_v = _sorted(mat.keys, mat.values)
    assert np.array_equal(got_k, want_k) and np.array_equal(got_v, want_v)


@pytest.mark.parametrize("npr,requested", [(8 * 1024, 2), (8 * 1014, 4),
                                           (8 * 1021, 4)])
def test_overlap_chunks_stay_exact(npr, requested):
    """JAX's three (npr, requested) pairs: JAX degrades to a divisor of the
    shard; the port's chunks may be uneven and it runs the requested
    count."""
    rng = np.random.default_rng(npr)
    bk, bv, pk = _cols(rng, 8 * 512, npr)
    jcount, overflow = _jax_join(bk, bv, pk, overlap_chunks=requested)
    assert int(overflow) == 0
    for materialize in (False, True):
        res = distributed_join_exact(data_mesh(devices=["cpu"] * 8), bk, bv,
                                     pk, cfg=CFG, overlap_chunks=requested,
                                     materialize=materialize)
        assert res.count == int(jcount) == oracle_count(bk, pk)
        assert res.info["probe_chunks"] == requested


# ---- the public API ---------------------------------------------------------

def test_api_uneven_lengths_match_jax():
    rng = np.random.default_rng(17)
    bk = rng.integers(0, 2**63, 1000, dtype=np.uint64)   # 1000 % 8 != 0
    bv = rng.integers(0, 2**63, 1000, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 3000),
                         rng.integers(0, 2**63, 2001, dtype=np.uint64)])
    jcount, _ = fj.distributed_join_count(bk, bv, pk)
    for n in (1, 2, 4, 8):
        count, secs, info = ft.distributed_join_count(
            bk, bv, pk, n_devices=n, device="cpu", return_info=True)
        assert count == jcount == oracle_count(bk, pk)
        assert secs > 0.0 and info["ranks"] == n
        assert info["devices"] == ["cpu"] * n
        assert sum(info["build_rows"]) >= 1000 - info["hot_keys"]


def test_api_materialize_arrays_match_jax():
    rng = np.random.default_rng(21)
    bk = np.unique(rng.integers(0, 2**40, 3000, dtype=np.uint64))
    bv = rng.integers(0, 2**40, len(bk), dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 2000),
                         rng.integers(0, 2**40, 1000, dtype=np.uint64)])
    jcount, _, jk, jv = fj.distributed_join_materialize(
        bk, bv, pk, n_devices=8, return_arrays=True)
    count, secs, keys, vals, info = ft.distributed_join_materialize(
        bk, bv, pk, n_devices=8, device="cpu", return_arrays=True,
        return_info=True)
    assert count == jcount == len(keys)
    assert collections.Counter(keys.tolist()) == collections.Counter(
        jk.tolist())
    assert np.array_equal(_sorted(keys, vals)[1], _sorted(jk, jv)[1])
    plain = ft.distributed_join_materialize(bk, bv, pk, n_devices=8,
                                            device="cpu")
    assert len(plain) == 2 and plain[0] == count
    assert info["launches"]["compact"] == 0       # the CPU: K5's plain version


def test_api_empty_and_errors():
    empty = np.zeros(0, np.uint64)
    one = np.ones(5, np.uint64)
    assert ft.distributed_join_count(empty, empty, one, device="cpu") == (0,
                                                                          0.0)
    assert ft.distributed_join_count(one, one, empty, device="cpu") == (0,
                                                                        0.0)
    count, secs, k, v = ft.distributed_join_materialize(
        empty, empty, one, device="cpu", return_arrays=True)
    assert (count, secs, k.size, v.size) == (0, 0.0, 0, 0)
    with pytest.raises(ValueError, match="equal length"):
        ft.distributed_join_count(one, one[:3], one, device="cpu")
    for kw in (dict(n_devices=3), dict(devices=["cpu"] * 3)):
        with pytest.raises(ValueError, match="power of two"):
            ft.distributed_join_count(one, one, one, device="cpu", **kw)
    if not torch.cuda.is_available():
        # device="cuda" never runs on the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            ft.distributed_join_count(one, one, one)
        with pytest.raises(RuntimeError, match="CUDA"):
            data_mesh(2)


def test_dryrun_multichip_in_process():
    # half of the 2048 probe rows a rank are drawn from the build keys
    assert dryrun_multichip(8, device="cpu") == 8 * 1024
    assert dryrun_multichip(2, device="cpu") == 2 * 1024


def test_mesh_map_runs_a_thread_a_device_in_rank_order():
    """map gives fn(i) in rank order, in this thread; threaded, the ranks
    of one device run in turn in one thread, distinct devices in threads
    of their own (here the CPU and the meta device stand in for two
    cards)."""
    here = threading.current_thread()
    one = data_mesh(devices=["cpu"] * 4)
    two = data_mesh(devices=["cpu", "meta", "cpu", "meta"])
    for mesh, threaded in ((one, False), (one, True), (two, False)):
        assert mesh.map(lambda i: (i, threading.current_thread()),
                        threaded=threaded) == [(i, here) for i in range(4)]
    got = two.map(lambda i: (i, threading.current_thread()), threaded=True)
    assert [i for i, _ in got] == [0, 1, 2, 3]
    assert got[0][1] is got[2][1] and got[1][1] is got[3][1]
    assert len({id(here), id(got[0][1]), id(got[1][1])}) == 3
    with pytest.raises(ZeroDivisionError):
        two.map(lambda i: 1 // (i - 3), threaded=True)


def test_parallel_entry_points_default_to_the_card():
    """dryrun_multichip, run_workers and the worker module run on the card
    unless the caller asks for the CPU."""
    from flash_hash_join_tpu_torch.parallel import worker
    for fn in (dryrun_multichip, run_workers):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert worker.arg_parser().parse_args(["1", "0", "1"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dryrun_multichip(2)


def test_two_process_gloo_distributed_join():
    """Two worker processes, one rank each, over gloo on localhost (the
    twin of tests/test_multihost.py); both print the oracle's count."""
    outs = run_workers(2, "--timeout", 60, device="cpu", timeout=180)
    rng = np.random.default_rng(4242)          # the worker's data
    bk = rng.integers(0, 2**64, 2048, dtype=np.uint64)
    rng.integers(0, 2**64, 2048, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 4096),
                         rng.integers(0, 2**64, 4096, dtype=np.uint64)])
    want = oracle_count(bk, pk)
    counts = {line.split("count=")[1] for out in outs
              for line in out.splitlines() if "MHOK" in line}
    assert counts == {str(want)}
    assert all("world=2 device=cpu" in out for out in outs)
