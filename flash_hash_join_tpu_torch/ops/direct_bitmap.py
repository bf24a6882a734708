"""Direct-address bitmap count join for dense narrow key domains (port of
the count half of flash_hash_join_tpu/ops/direct_bitmap.py).

When the build keys are dense integers (db-benchmark J1), a count join is
membership counting: count = |{p : p in domain bitmap}| under first-match
semantics (each probe row counts at most once, whatever the build-side
duplicates).

Split of work:
  host (api.py): detects the dense domain from the numpy inputs (max <
    2^32, span <= MAX_XL_DOMAIN_BITS) and picks the d_rows rung.
  this module (torch, on the device): lo = min valid build key, the
    lo-relative u32 domain indices of both sides, and the kernels:
      scan band  (d_rows <= 256): bitmap packed in plain torch, as the JAX
                 package packs it outside any kernel; K2 probe
                 (ops/cuda/bitmap_probe.py).
      large band (d_rows > 256): K1 build + probe (ops/cuda/dense_bitmap.py)
                 on UNSORTED indices.  The JAX band's blockwise sort, `rs`
                 windows and the density gates that size them
                 (sort_block_for, large_span_ok) exist only for the TPU
                 kernel's row window and are not ported.

Exactness: build rows that do not fit the declared domain (key hi-word
!= 0, or lo-relative index >= d_rows*4096) are counted into special[3],
and the caller reruns on the always-exact merge path.  K1 has no window,
so special[3] counts nothing else.  Probe keys outside the domain are
provably matchless and contribute zero.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen

SENTINEL = 0xFFFFFFFF

# Domain cap of the scan band: 2^20 slots = 256 bitmap rows.
MAX_DOMAIN_BITS = bp.MAX_D_ROWS * bp.BITS_PER_ROW   # 2^20

# The JAX package's large band: pow2 rungs up to 16384 rows = 2^26 slots
# (the 4e7 J1 Q5 universe of 4.4e7 slots) ...
MAX_LARGE_D_ROWS = 16384
MAX_LARGE_DOMAIN_BITS = MAX_LARGE_D_ROWS * bp.BITS_PER_ROW  # 2^26

# ... then XL rungs stepping by 4096 rows up to 28672 rows (14.7 MB),
# which covers the 1e8 J1 Q5 universe (1.1e8 slots).
MAX_XL_D_ROWS = 28672
MAX_XL_DOMAIN_BITS = MAX_XL_D_ROWS * bp.BITS_PER_ROW  # 117,440,512
XL_STEP_ROWS = 4096


def d_rows_for(span: int) -> int:
    """Bitmap rows for a key span: pow2 through MAX_LARGE_D_ROWS, then
    XL_STEP_ROWS steps (same rungs as the JAX package)."""
    need = -(-max(span, 1) // bp.BITS_PER_ROW)
    r = 8
    while r < need and r < MAX_LARGE_D_ROWS:
        r *= 2
    if need > r:
        r = -(-need // XL_STEP_ROWS) * XL_STEP_ROWS
    return r


def _masked_min(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """min(values[mask]) as a 0-d tensor, SENTINEL when nothing is masked
    in (jnp.min(..., initial=SENTINEL))."""
    if values.numel() == 0:
        return torch.tensor(SENTINEL, dtype=values.dtype, device=values.device)
    return torch.where(mask, values, SENTINEL).amin()


def _build_idx(kh, kl, bvalid, lo, d_bits: int):
    """(bad-row count, build domain indices as int32 bit patterns)."""
    diff = (widen(kl) - lo) & MASK32          # keys < lo wrap to huge
    bad = bvalid & ((kh != 0) | (diff >= d_bits))
    idx = torch.where(bvalid & ~bad, diff, SENTINEL)
    return bad.sum(), narrow(idx)


def _probe_idx(ph, pl, np_valid: int, lo, d_bits: int) -> torch.Tensor:
    pvalid = torch.arange(ph.shape[0], device=ph.device) < np_valid
    pdiff = (widen(pl) - lo) & MASK32
    pok = pvalid & (ph == 0) & (pdiff < d_bits)
    return narrow(torch.where(pok, pdiff, SENTINEL))


def _special(n_bad: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.int64, device=n_bad.device)
    return torch.stack([zero, zero, zero, n_bad.to(torch.int64)])


def direct_join_count(kh, kl, ph, pl, nb_valid: int, np_valid: int, *,
                      d_rows: int):
    """Dense-domain count.  Returns (count, special4), 0-d and (4,) int64
    tensors on the planes' device.

    kh/kl, ph/pl: int32 u32-pattern key planes (utils/u64.py).
    special[3] = build rows outside the declared domain (caller must fall
    back when nonzero).  Scan band up to bp.MAX_D_ROWS rows, K1 above.
    """
    if d_rows > bp.MAX_D_ROWS:
        return direct_join_count_large(kh, kl, ph, pl, nb_valid, np_valid,
                                       d_rows=d_rows)
    d_bits = d_rows * bp.BITS_PER_ROW
    bvalid = torch.arange(kh.shape[0], device=kh.device) < nb_valid
    # the scan band's lo is the min over EVERY valid row, hi-word rows too
    lo = _masked_min(widen(kl), bvalid)
    n_bad, bidx = _build_idx(kh, kl, bvalid, lo, d_bits)
    bitmap = dbm.pack_bitmap(bidx, d_rows)
    pidx = _probe_idx(ph, pl, np_valid, lo, d_bits)
    count = bp.probe_count_bitmap(bitmap, pidx, d_rows)
    return count, _special(n_bad)


def direct_join_count_large(kh, kl, ph, pl, nb_valid: int, np_valid: int, *,
                            d_rows: int):
    """Large-span dense-domain count via K1 (ops/cuda/dense_bitmap.py).
    Same (count, special4) contract as direct_join_count."""
    d_bits = d_rows * bp.BITS_PER_ROW
    bvalid = torch.arange(kh.shape[0], device=kh.device) < nb_valid
    # the large band's lo is the min over valid rows with a zero hi-word
    lo = _masked_min(widen(kl), bvalid & (kh == 0))
    n_bad, bidx = _build_idx(kh, kl, bvalid, lo, d_bits)
    pidx = _probe_idx(ph, pl, np_valid, lo, d_bits)
    count, _, _ = dbm.fused_bitmap_join(bidx, pidx, d_rows)  # never unresolved
    return count, _special(n_bad)
