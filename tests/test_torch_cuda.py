"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the count slice end to end against the numpy oracle.

Every test here needs an NVIDIA card and skips without one.  This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip tests/conftest.py (which imports jax):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality — every output is an integer count.
"""

import numpy as np
import pytest
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.utils.u64 import to_device

SENTINEL = 0xFFFFFFFF
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _idx(rng, n, n_bits, dev):
    idx = rng.integers(0, n_bits, n, dtype=np.uint32)
    idx[rng.random(n) < 0.05] = SENTINEL
    idx[:3] = n_bits + 7                                # out of the domain
    return to_device(idx, dev)


@pytest.mark.parametrize("d_rows", [8, 16, 128, 256])
def test_probe_count_bitmap_matches_plain(dev, d_rows):
    rng = np.random.default_rng(d_rows)
    bitmap = to_device(rng.integers(0, 2**32, (d_rows, 128), dtype=np.uint32),
                       dev)
    for n in (1, 3, 1_000_003):
        idx = _idx(rng, n, d_rows * 4096, dev)
        for view in (idx, idx[1:]):                     # ragged, misaligned
            before = bp.probe_count_bitmap.launches
            got = bp.probe_count_bitmap(bitmap, view, d_rows)
            want = bp.probe_count_bitmap_plain(bitmap, view, d_rows)
            torch.cuda.synchronize()
            assert int(got) == int(want), (d_rows, view.numel())
            assert bp.probe_count_bitmap.launches == before + (view.numel() > 0)


@pytest.mark.parametrize("d_rows", [512, 16384, 28672])
def test_fused_bitmap_join_matches_plain(dev, d_rows):
    rng = np.random.default_rng(d_rows)
    n_bits = d_rows * 4096
    for nb, npr in ((2_000_001, 3_000_005), (0, 1_000), (1_000, 0), (5, 7)):
        bidx = _idx(rng, nb, n_bits, dev)
        pidx = _idx(rng, npr, n_bits, dev)
        got = dbm.fused_bitmap_join(bidx, pidx, d_rows)[0]
        want = dbm.fused_bitmap_join_plain(bidx, pidx, d_rows)
        torch.cuda.synchronize()
        assert int(got) == int(want), (d_rows, nb, npr)


def test_wrappers_refuse_bad_inputs(dev):
    idx = torch.zeros(16, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        dbm.fused_bitmap_join(idx, idx, 512)
    bitmap = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        bp.probe_count_bitmap(bitmap, idx.to(torch.int32).cpu(), 8)


@pytest.mark.parametrize("span,expect", [(44_000, "bitmap_probe"),
                                         (3_000_000, "dense_bitmap")])
def test_adaptive_join_count_on_card(dev, span, expect):
    rng = np.random.default_rng(span)
    bk = rng.integers(10, 10 + span, 1_000_000, dtype=np.uint64)
    bv = rng.integers(0, 2**63, bk.size, dtype=np.uint64)
    pk = rng.integers(0, span + 20, 2_000_000, dtype=np.uint64)
    count, secs, info = ft.adaptive_join_count(bk, bv, pk, return_info=True)
    assert count == int(np.isin(pk, np.unique(bk)).sum())
    assert info["strategy"] == "direct" and not info["retried"]
    assert info["launches"][expect] == 1 and secs > 0.0


def test_merge_fallback_on_card(dev):
    rng = np.random.default_rng(1)
    bk = rng.integers(0, 2**64, 200_000, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, 100_000),
                         rng.integers(0, 2**64, 300_000, dtype=np.uint64)])
    bk[:3] = 2**64 - 1
    pk[:5] = 2**64 - 1
    count, _, info = ft.adaptive_join_count(bk, bk, pk, return_info=True)
    assert info["strategy"] == "merge"
    assert count == int(np.isin(pk, np.unique(bk)).sum())
