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
    picks the d_rows (count) or v_rows (materialize) rung; the adaptive
    plan then asks this module's gates (adaptive_wins) whether direct is
    the faster route for the shape.
  the gates (port of the JAX package's api.py:117-166 and
    direct_bitmap.py:50, 145-170, 428-434, its structure and names): a
    probe floor (ADAPTIVE_MIN_PROBE_ROWS), the scan band's cap
    (ADAPTIVE_SCAN_DOMAIN_BITS), the large band's large_span_wins
    (LARGE_MIN_PROBE_ROWS), and the materialize's mat_wins by value-plane
    rung and value width (MAT_MIN_PROBE_ROWS, MAT_STAGED_MIN_PROBE_ROWS,
    MAT_WIDE_MIN_PROBE_ROWS).  Their constants come from the crossover
    sweep (harness/crossover.py) on an NVIDIA H100 80GB HBM3 at 700.00 W,
    not from the v5e; beside each, the points that fix it.  On that card
    no count gate binds (direct won every count measured) and the
    materialize goes direct only at large probe sides.  The JAX package's
    window gates (large_span_ok, mat_span_ok, sort_block_for) are not
    ported: they size the TPU kernels' windows, and these kernels have
    none.
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


# --- the adaptive gates (port of flash_hash_join_tpu/api.py:117-166) ----
# Measured on an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi
# --query-gpu=name,power.limit), by the crossover sweep:
#     python3 -m flash_hash_join_tpu_torch.harness.crossover --mode count
#     python3 -m flash_hash_join_tpu_torch.harness.crossover --mode materialize
# plus the follow-up points named below.  Times are core ms, direct /
# partitioned, the best of 5 API calls after a warm-up.  Only adaptive
# consults the gates (api._route); an explicit strategy="direct" takes any
# domain _dense_rung accepts.  harness/gate_drift.py re-measures one
# sentinel on each side of every gate: run it after any change to a kernel
# or to the host work around one.

# Probe floor (JAX: 1 << 16 probe rows, inline).  Never binds on the H100:
# direct won every count of the sweep, 1 to 1e8 probe rows, by 34 % or
# more (J1 4e6 Q2: 0.377 / 0.507); at the small end (`--nb 1e3 2.5e6 1e8
# --npr 1 100 1000`) by 71-783 % (npr 1: nb 1000 0.183 / 0.454, nb 2.5e6
# 0.370 / 0.703, nb 1e8 1.720 / 15.015), and at npr 1e4-2.5e5 (nb 1e3,
# 1e5, 2.5e6) by 67-151 %.  A materialize's floor is mat_wins'.  A chunked
# count gates on the rows of one chunk.
ADAPTIVE_MIN_PROBE_ROWS = 0

# Scan cap (JAX: 2^19 slots, 128 bitmap rows, from a v5e row scan whose
# cost grew with d_rows).  Never binds: K2 finds a key's bit in shared
# memory whatever the rung, and direct won every span of the scan band,
# spans 2^19 +- 4096 and 2^20 - 4096 at 1e6 and 4e7 probe rows by 100-153 %
# (span 2^19 + 4096, npr 4e7: 0.512 / 1.258; span 2^20 - 4096, npr 1e6:
# 0.297 / 0.594).  So the cap is the scan band's own 2^20 slots.
ADAPTIVE_SCAN_DOMAIN_BITS = MAX_DOMAIN_BITS

# Large band (JAX: npr >= 3.2e7 and nb <= 1.25 npr, where the v5e's
# blockwise sort lost to the partitioned tier's below).  Never binds: K1
# won every large-band point, nb 4e4 (span 2^20 + 4096) to 1e8 by npr 1 to
# 1e8 (nb / npr up to 1e8), by 71-783 % (nb 2.5e6, npr 1000: 0.395 /
# 0.676; J1 1e8 Q5: 2.641 / 21.810; nb 4e7, npr 1e6: 0.880 / 6.207).
LARGE_MIN_PROBE_ROWS = 0


def large_span_wins(nb: int, npr: int) -> bool:
    """Should adaptive route an eligible span past the scan band (K1)
    direct?  True over the whole measured region (nb 4e4-1e8, npr
    1-1e8); nb has never decided it on the H100."""
    return npr >= LARGE_MIN_PROBE_ROWS


# Dense materialize.  Direct pays for its build side's small host-dispatched
# launches (its core is 0.9-1.5 ms at 6.5e4-2.5e5 probe rows, against
# partitioned's 0.4-0.9), and reads the probe side faster, so it wins only
# past a probe count that grows as its value planes shrink.  Narrow values (one plane), v_rows <= 64 (K7):
# partitioned wins to 1.5e8 probe rows (v8 at 1e8: 2.979 / 2.859, at 1.5e8
# 4.234 / 3.926; J1 1e8 Q1 2.718 / 2.458), direct from 2e8 (v8 4.926 /
# 5.142, v64 4.889 / 5.332) -- a near tie on both sides.
MAT_MIN_PROBE_ROWS = 200_000_000
# Narrow values, v_rows >= 128 (K7's top rung, then K8): partitioned wins
# to 4e7 probe rows (v128 1.914 / 1.820, v1024 2.282 / 2.092, J1 4e7 Q2
# 1.954 / 1.883) and at 6e7-8e7 on v128 (3.101 / 2.786); direct from 8e7
# (v256 3.090 / 3.202, v1024 2.986 / 3.675, v8192 3.375 / 3.711) and at
# 1e8 on every rung by 11-36 % (J1 1e8 Q2 3.133 / 4.032).  8e7 keeps every
# measured point within 13.6 % of the faster route (v1024 at 6e7: 2.664 /
# 3.028).
MAT_STAGED_MIN_PROBE_ROWS = 80_000_000
# u64 values (two planes): partitioned wins by up to 157 % over v_rows
# 8-8192 by npr 6.5e4-1e8 and v128-8192 at 1.5e8 and 2e8 (v8 at 1e8:
# 3.725 / 2.660; v256 at 1.5e8: 6.223 / 5.064), but for v1024 at 1e8-2e8,
# where direct leads by 0-5 % (2e8: 7.501 / 7.888).  So this floor lies
# past every probe count; unmeasured beyond 2e8 probe rows.
MAT_WIDE_MIN_PROBE_ROWS = 1 << 62


def mat_wins(v_rows: int, npr: int, narrow_values: bool = True) -> bool:
    """Should adaptive route an eligible dense materialize of value-plane
    rung v_rows and npr probe rows direct?  narrow_values: every build
    value below 2^32 (one value plane)."""
    if not narrow_values:
        return npr >= MAT_WIDE_MIN_PROBE_ROWS
    if v_rows <= 64:
        return npr >= MAT_MIN_PROBE_ROWS
    return npr >= MAT_STAGED_MIN_PROBE_ROWS


def adaptive_wins(mode: str, nb: int, npr: int, span: int,
                  narrow_values: bool = True) -> bool:
    """The gates together: should adaptive route an eligible dense build
    (api._dense_rung) of nb rows spanning `span` slots direct, for npr
    probe rows (a chunk's rows when the probe side streams)?  The
    constants are read at call time."""
    if npr < ADAPTIVE_MIN_PROBE_ROWS:
        return False
    if mode == "count":
        if span <= MAX_DOMAIN_BITS:
            return span <= ADAPTIVE_SCAN_DOMAIN_BITS
        return large_span_wins(nb, npr)
    return mat_wins(v_rows_for(span), npr, narrow_values)


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
