"""Port parity for the partitioned count over resident probe chunks:
flash_hash_join_tpu_torch's range_join_count_chunked against the JAX
package's (ops/range_table.py, Pallas kernels in interpret mode, as
tests/test_chunked.py runs it), the numpy oracle and the port's single-shot
range_join_count.

Inputs are numpy arrays from a fixed seed, handed to both packages; the
port runs on CPU tensors, i.e. K3's plain version.  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_hash_join_tpu.ops import range_table as jrt
from flash_hash_join_tpu_torch.ops import range_table as trt
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.utils import u64 as tu64
from tests.oracle import oracle_count

M64 = np.uint64(2**64 - 1)
U32MAX = np.uint64(2**32 - 1)


def _planes(bk, pk):
    """(kh, kl, vh, vl, ph, pl) as numpy u32 planes; the values are zero,
    as in tests/test_chunked.py (a count reads none)."""
    kh, kl = tu64.split_u64(bk)
    ph, pl = tu64.split_u64(pk)
    zeros = np.zeros(bk.size, np.uint32)
    return kh, kl, zeros, zeros, ph, pl


def _port(bk, pk, nb, npr, n_chunks=None):
    args = [tu64.to_device(p, "cpu") for p in _planes(bk, pk)]
    if n_chunks is None:
        return trt.range_join_count(*args, nb, npr)
    return trt.range_join_count_chunked(*args, nb, npr, n_chunks=n_chunks)


def _jax(bk, pk, nb, npr, n_chunks, narrow):
    args = [jnp.asarray(p) for p in _planes(bk, pk)]
    return jrt.range_join_count_chunked(*args, nb, npr, n_chunks=n_chunks,
                                        narrow=narrow, interpret=True)


def _check(bk, pk, nb, npr, n_chunks, narrow=False, with_jax=True):
    count, special = _port(bk, pk, nb, npr, n_chunks)
    assert count.dtype == torch.int64 and count.dim() == 0
    assert special.dtype == torch.int64 and special.tolist() == [0, 0, 0, 0]
    want = oracle_count(bk[:nb], pk[:npr])
    assert int(count) == want
    assert int(_port(bk, pk, nb, npr)[0]) == want           # single shot
    if with_jax:
        jcount, jspecial = _jax(bk, pk, nb, npr, n_chunks, narrow)
        assert int(jspecial[3]) == 0
        assert int(jcount) == want


# the cases of tests/test_chunked.py:42-47, same seeds, sizes and sentinels
@pytest.mark.parametrize("nb,npr,n_chunks,narrow,seed", [
    (1000, 5000, 3, True, 0),
    (300, 4097, 4, True, 1),      # the chunk length does not divide npr
    (20000, 60000, 3, False, 2),  # wide keys
    (1000, 3000, 2, True, 3),     # u32-max sentinels on both sides
])
def test_chunked_count_matches_jax_and_oracle(nb, npr, n_chunks, narrow,
                                              seed):
    rng = np.random.default_rng(seed)
    hi = 2**32 if narrow else 2**63
    bk = rng.integers(0, min(hi, nb * 2), nb, dtype=np.uint64)
    pk = rng.integers(0, min(hi, nb * 2), npr, dtype=np.uint64)
    if seed == 3:
        bk[5] = U32MAX
        pk[7:20] = U32MAX
    _check(bk, pk, nb, npr, n_chunks, narrow)


def test_chunked_count_equals_single_shot():
    """tests/test_chunked.py:76-94: 5 chunks against the single shot, in
    both packages."""
    rng = np.random.default_rng(7)
    nb, npr = 5000, 20000
    bk = rng.integers(0, 8000, nb, dtype=np.uint32).astype(np.uint64)
    pk = rng.integers(0, 8000, npr, dtype=np.uint32).astype(np.uint64)
    count, special = _port(bk, pk, nb, npr, n_chunks=5)
    single, _ = _port(bk, pk, nb, npr)
    args = [jnp.asarray(p) for p in _planes(bk, pk)]
    j1, js1 = jrt.range_join_count(*args, nb, npr, narrow=True,
                                   interpret=True)
    j2, js2 = jrt.range_join_count_chunked(*args, nb, npr, n_chunks=5,
                                           narrow=True, interpret=True)
    assert int(js1[3]) == int(js2[3]) == int(special[3]) == 0
    assert int(count) == int(single) == int(j1) == int(j2) == oracle_count(
        bk, pk)


def _edge(name):
    """(bk, pk, nb_valid, np_valid, n_chunks, compare with JAX)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    nb, npr = 2_000, 9_000
    bk = rng.integers(0, 3_000, nb, dtype=np.uint64)
    pk = rng.integers(0, 3_000, npr, dtype=np.uint64)
    nbv, npv, n_chunks, with_jax = nb, npr, 4, True
    if name == "one_chunk":
        n_chunks = 1
    elif name == "more_chunks_than_rows":   # chunks of one row, most empty
        pk = pk[:50]
        npv, n_chunks, with_jax = 50, 64, False
    elif name == "np_valid_mid_chunk":      # chunks of 2250: cut inside #3
        npv = 5_000
        pk[npv:] = bk[0]                    # rows past np_valid would hit
    elif name == "nb_valid_short":
        nbv = 1_200
        bk[nbv:] = pk[:nb - nbv]            # rows past nb_valid would hit
    elif name == "u64_max_both":
        bk = rng.integers(0, 2**64 - 1, nb, dtype=np.uint64)
        pk = rng.choice(bk, npr)
        bk[[3, 700]] = M64
        bk[9] = M64 - np.uint64(1)
        pk[-20:] = M64
        pk[:5] = M64 - np.uint64(1)
        pk[5:10] = np.uint64(0)
    elif name == "nb_valid_zero":
        nbv = 0
    elif name == "np_valid_zero":
        npv = 0
    return bk, pk, nbv, npv, n_chunks, with_jax


EDGES = ["one_chunk", "more_chunks_than_rows", "np_valid_mid_chunk",
         "nb_valid_short", "u64_max_both", "nb_valid_zero", "np_valid_zero"]


@pytest.mark.parametrize("name", EDGES)
def test_chunked_count_edges(name):
    bk, pk, nbv, npv, n_chunks, with_jax = _edge(name)
    _check(bk, pk, nbv, npv, n_chunks, with_jax=with_jax)


def test_chunked_count_builds_once_and_probes_views(monkeypatch):
    """One table build and one directory a call, whatever n_chunks; K3
    once for each chunk that holds a valid row, on views of the probe
    planes (no copy) with the chunk's valid rows; the sum equals the
    single shot for every n_chunks."""
    rng = np.random.default_rng(5)
    nb, npr, npv = 3_000, 10_001, 9_500
    bk = rng.integers(0, 4_000, nb, dtype=np.uint64)
    pk = rng.integers(0, 4_000, npr, dtype=np.uint64)
    kh, kl, vh, vl, ph, pl = (tu64.to_device(p, "cpu")
                              for p in _planes(bk, pk))
    builds, calls = [], []
    real_build, real_probe = trt.build_range_table, rp.range_probe_count

    def build(*a, **kw):
        builds.append(kw)
        return real_build(*a, **kw)

    def probe(table, cph, cpl, valid):
        calls.append((cph.data_ptr() - ph.data_ptr(),
                      cpl.data_ptr() - pl.data_ptr(), cph.numel(), valid))
        return real_probe(table, cph, cpl, valid)

    monkeypatch.setattr(trt, "build_range_table", build)
    monkeypatch.setattr(rp, "range_probe_count", probe)
    want = int(trt.range_join_count(kh, kl, vh, vl, ph, pl, nb, npv)[0])
    assert want == oracle_count(bk, pk[:npv])
    for n_chunks in (1, 2, 3, 7, 16, 10_001, 20_000):
        builds.clear()
        calls.clear()
        count, _ = trt.range_join_count_chunked(kh, kl, vh, vl, ph, pl, nb,
                                                npv, n_chunks=n_chunks)
        assert int(count) == want, n_chunks
        assert builds == [{"with_values": False}]
        per = -(-npr // n_chunks)
        starts = range(0, npv, per)
        assert calls == [(4 * s, 4 * s, min(per, npr - s),
                          min(per, npv - s)) for s in starts], n_chunks


@pytest.mark.parametrize("n_chunks,np_valid", [(0, 10), (-2, 10),
                                               (3, 11), (3, -1)])
def test_chunked_count_refuses_bad_arguments(n_chunks, np_valid):
    bk = np.arange(20, dtype=np.uint64)
    pk = np.arange(10, dtype=np.uint64)
    with pytest.raises(ValueError):
        _port(bk, pk, 20, np_valid, n_chunks)
