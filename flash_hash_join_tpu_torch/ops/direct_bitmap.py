"""Direct-address joins for dense narrow key domains, count and
materialize (port of flash_hash_join_tpu/ops/direct_bitmap.py).

When the build keys are dense integers (db-benchmark J1), a count join is
membership counting: count = |{p : p in domain bitmap}| under first-match
semantics (each probe row counts at most once, whatever the build-side
duplicates), and a materialize reads each hit's value from a dense plane
indexed by the same domain slot.

Split of work:
  host (api.py): detects the dense domain from the numpy inputs (max <
    2^32; count: span <= MAX_XL_DOMAIN_BITS, materialize: at most
    MAX_BUILD_ROWS build rows and v_rows_for(span) <= MAT_MAX_V_ROWS) and
    picks the d_rows (count) or v_rows (materialize) rung.
  this module (torch, on the device).  Count, both bands straight from the
    UNSORTED key planes, so no int64 pass runs on the card:
      scan band  (d_rows <= 256): K2 (ops/cuda/bitmap_probe.py
                 scan_domain_count): lo over every valid build row, the
                 mapping, the bitmap build and the probe inside the kernel.
      large band (d_rows > 256): K1 (ops/cuda/dense_bitmap.py
                 fused_domain_bitmap_join): lo over the zero-hi-word rows,
                 the same steps.  The JAX band's blockwise sort, `rs`
                 windows and the density gates that size them
                 (sort_block_for, large_span_ok) exist only for the TPU
                 kernel's row window and are not ported.
    Materialize: lo, the build rows' domain indices and the value planes
    at slot granularity in plain torch over the build side (<= 2^20 rows),
    as the JAX package builds them outside any kernel; then both bands
    straight from the probe key planes, the mapping inside the kernel, so
    no int64 pass runs over the probe rows:
      scan band   (v_rows <= 128): K7 (ops/cuda/bitmap_probe.py), the
                  bitmap and the value planes in shared memory.
      staged band (v_rows <= 8192): K8 (ops/cuda/dense_values.py), the
                  bitmap in shared memory, the value planes read through
                  L2.  The JAX band's one-column probe sort, `sels` window
                  and `rs` starts, keys pass-through, density gate
                  (mat_span_ok) and fusion-barrier copy (K9) exist only for
                  the TPU kernel and XLA:TPU and are not ported.
    Both bands end in K5 (ops/compact.py) and emit probe order; the JAX
    staged band emits ascending domain order (same row multiset).

Exactness: build rows that do not fit the declared domain (key hi-word
!= 0, or lo-relative index past the rung's slots) are counted into
special[3], and the caller reruns on the always-exact merge path.  No
kernel here has a window, so special[3] counts nothing else.  Probe keys
outside the domain are provably matchless and contribute zero.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops import domain_map as dm
from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
from flash_hash_join_tpu_torch.utils.u64 import widen

LANES = bp.LANES

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

# Materialize: value planes of v_rows rows of 128 slots.  K7 stages its
# planes in shared memory up to 128 rows (2 x 64 KB); K8 reads them through
# L2 up to 8192 rows (2^20 slots, 4 MB per plane).  The build side is
# capped at 2^20 rows, as in the JAX package.
MAT_SCAN_MAX_V_ROWS = bp.MAX_V_ROWS
MAT_MAX_V_ROWS = dv.MAX_V_ROWS
MAX_BUILD_ROWS = 1 << 20


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


def v_rows_for(span: int) -> int:
    """Value-plane rows for a key span: pow2 rows of 128 slots, at least 8
    (same rungs as the JAX package)."""
    need = -(-max(span, 1) // LANES)
    r = 8
    while r < need:
        r *= 2
    return r


def _special(n_bad: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.int64, device=n_bad.device)
    return torch.stack([zero, zero, zero, n_bad.to(torch.int64)])


def direct_join_count(kh, kl, ph, pl, nb_valid: int, np_valid: int, *,
                      d_rows: int):
    """Dense-domain count.  Returns (count, special4), 0-d and (4,) int64
    tensors on the planes' device.

    kh/kl, ph/pl: int32 u32-pattern key planes (utils/u64.py).
    special[3] = build rows outside the declared domain (caller must fall
    back when nonzero).  Scan band (K2) up to bp.MAX_D_ROWS rows, K1 above.
    """
    if d_rows > bp.MAX_D_ROWS:
        return direct_join_count_large(kh, kl, ph, pl, nb_valid, np_valid,
                                       d_rows=d_rows)
    count, n_bad = bp.scan_domain_count(kh, kl, ph, pl, nb_valid, np_valid,
                                        d_rows)
    return count, _special(n_bad)


def direct_join_count_large(kh, kl, ph, pl, nb_valid: int, np_valid: int, *,
                            d_rows: int):
    """Large-span dense-domain count via K1 (ops/cuda/dense_bitmap.py),
    which maps the key planes to domain indices inside the kernel.  Same
    (count, special4) contract as direct_join_count; lo is the min over
    valid rows with a zero hi-word."""
    count, n_bad = dbm.fused_domain_bitmap_join(kh, kl, ph, pl, nb_valid,
                                                np_valid, d_rows)
    return count, _special(n_bad)


def _dense_value_planes(kh, kl, vh, vl, nb_valid: int, *, v_rows: int,
                        narrow_values: bool):
    """Scatter the build values into dense planes.  Returns (lo, n_bad,
    build domain indices as int32 bit patterns, value planes: (vl,) when
    narrow_values, else (vh, vl), each (v_rows, 128) int32; unoccupied
    slots hold 0).

    Winner on duplicate build keys: the MIN build-row index, as in the JAX
    package's .at[].min and the port's partitioned and merge tiers."""
    n = kh.shape[0]
    v_slots = v_rows * LANES
    bvalid = torch.arange(n, device=kh.device) < nb_valid
    # lo is the min over valid rows with a zero hi-word (both bands)
    lo = dm.masked_min(widen(kl), bvalid & (kh == 0))
    n_bad, bidx = dm.build_domain_idx(kh, kl, bvalid, lo, v_slots)
    # rows outside the domain land on the extra slot v_slots, which is cut
    # off (torch's scatter has no mode="drop")
    slot = widen(bidx).clamp_(max=v_slots)
    win = torch.full((v_slots + 1,), n, dtype=torch.int64, device=kh.device)
    win.scatter_reduce_(0, slot, torch.arange(n, device=kh.device), "amin")
    win = win[:v_slots]
    # each value column gets a zero row n, which every unoccupied slot reads
    cols = (vl,) if narrow_values else (vh, vl)
    planes = tuple(torch.cat([c, c.new_zeros(1)])[win].view(v_rows, LANES)
                   for c in cols)
    return lo, n_bad, bidx, planes


def direct_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid: int,
                            np_valid: int, *, v_rows: int,
                            narrow_values: bool = False):
    """Dense-domain materialize.  Returns the engine's materialize contract
    (count, out_kh, out_kl, out_vh, out_vl, special4): the matched probe
    rows first, in probe order, as int32 bit-pattern planes of the probe
    side's length (out_vh is zeros when narrow_values).

    v_rows: the value-plane rung (v_rows_for(span): a power of two from 8
    to MAT_MAX_V_ROWS); scan band (K7) up to MAT_SCAN_MAX_V_ROWS, staged
    band (K8) above.
    narrow_values: every value is below 2^32, so the hi plane is dropped.
    special[3] = build rows outside the domain (caller must fall back when
    nonzero).
    """
    if not 8 <= v_rows <= MAT_MAX_V_ROWS or v_rows & (v_rows - 1):
        raise ValueError(f"v_rows must be a power of two in [8, "
                         f"{MAT_MAX_V_ROWS}], got {v_rows}")
    lo, n_bad, bidx, planes = _dense_value_planes(
        kh, kl, vh, vl, nb_valid, v_rows=v_rows, narrow_values=narrow_values)
    # the occupied slots as a bitmap: K7's 8 rows, or K8's v_rows // 32
    d_rows = max(bp.GATHER_D_ROWS, v_rows // 32)
    bitmap = dm.pack_bitmap(bidx, d_rows)
    if v_rows <= MAT_SCAN_MAX_V_ROWS:
        hit, *vals = bp.probe_gather_bitmap(bitmap, planes, ph, pl, np_valid,
                                            lo, v_rows)
    else:
        hit, *vals = dv.probe_gather_staged(bitmap, planes, ph, pl, np_valid,
                                            lo, v_rows)
    if narrow_values:
        count, (okh, okl, ovl) = compact_by_mask(hit, (ph, pl, *vals))
        ovh = torch.zeros_like(ovl)
    else:
        count, (okh, okl, ovh, ovl) = compact_by_mask(hit, (ph, pl, *vals))
    return count, okh, okl, ovh, ovl, _special(n_bad)
