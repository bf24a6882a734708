"""The dense-domain mapping in plain int64 torch: key planes to lo-relative
domain indices, and the bitmap of a set of indices.

The JAX package's direct_join_count and direct_join_materialize run this
mapping around their Pallas kernels.  In the port, K1, K2, K7 and K8 map
the u32 key planes inside their CUDA kernels; these functions are the
mapping half of their plain versions (ops/cuda/dense_bitmap.py,
bitmap_probe.py, dense_values.py), and the mapping that
ops/direct_bitmap.py still runs in plain torch over the materialize's build
side (<= 2^20 rows).

Indices: 1-D int32 tensors of u32 bit patterns (utils/u64.py), sentinel
0xFFFFFFFF (= -1) for a row outside the domain.  Bitmap: (d_rows, 128)
int32 words, word w = idx >> 5 holding bit idx & 31.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen

LANES = 128
BITS_PER_ROW = 32 * LANES          # 4096 domain slots per bitmap row
SENTINEL = 0xFFFFFFFF


def masked_min(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """min(values[mask]) as a 0-d tensor, SENTINEL when nothing is masked
    in (jnp.min(..., initial=SENTINEL))."""
    if values.numel() == 0:
        return torch.tensor(SENTINEL, dtype=values.dtype, device=values.device)
    return torch.where(mask, values, SENTINEL).amin()


def build_domain_idx(kh, kl, bvalid, lo, d_bits: int):
    """(bad-row count, build domain indices as int32 bit patterns)."""
    diff = (widen(kl) - lo) & MASK32          # keys < lo wrap to huge
    bad = bvalid & ((kh != 0) | (diff >= d_bits))
    idx = torch.where(bvalid & ~bad, diff, SENTINEL)
    return bad.sum(), narrow(idx)


def probe_domain_idx(ph, pl, np_valid: int, lo, d_bits: int) -> torch.Tensor:
    pvalid = torch.arange(ph.shape[0], device=ph.device) < np_valid
    pdiff = (widen(pl) - lo) & MASK32
    pok = pvalid & (ph == 0) & (pdiff < d_bits)
    return narrow(torch.where(pok, pdiff, SENTINEL))


def pack_bitmap(idx: torch.Tensor, d_rows: int) -> torch.Tensor:
    """Plain build: bool scatter of the in-domain indices, then bit pack
    into a (d_rows, 128) int32 word bitmap."""
    n_bits = d_rows * BITS_PER_ROW
    v = widen(idx)
    # out-of-domain indices land on the extra slot n_bits, which is cut off
    # (a masked select would sync the card to size its result)
    bits = torch.zeros(n_bits + 1, dtype=torch.bool, device=idx.device)
    bits[torch.where(v < n_bits, v, n_bits)] = True
    shifts = torch.arange(32, device=idx.device)
    words = (bits[:n_bits].view(-1, 32).to(torch.int64) << shifts).sum(1)
    return narrow(words).view(d_rows, LANES)
