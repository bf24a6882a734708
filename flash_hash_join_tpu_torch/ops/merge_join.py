"""Sort-merge join on hash order — the always-exact fallback (port of
flash_hash_join_tpu/ops/merge_join.py).

  1. concat build and probe rows, tagged with a side flag,
  2. sort by (hash, key_hi, key_lo, flag) — build rows sort before probe
     rows within each equal-key run,
  3. a segmented doubling scan propagates "run contains a build row" and
     the FIRST build value through each run (ops/segmented.py),
  4. count = number of probe rows whose run has a build row;
     materialize = compact those rows (ops/compact.py).

torch has no multi-key sort: the lexicographic order is built from stable
argsort passes, least significant key first.  `cl` and `flag` share one
pass as the packed key (cl << 2) | flag, exact in int64.  The passes are
stable, so the first build row of a run is its minimum build row: that is
the duplicate-key winner (the JAX package's unstable sort leaves it open).
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.compact import compact_by_mask
from flash_hash_join_tpu_torch.ops.hashing import hash_u64
from flash_hash_join_tpu_torch.ops.segmented import segmented_scan
from flash_hash_join_tpu_torch.utils.u64 import MASK32, widen


def _sorted_runs(kh, kl, vh, vl, ph, pl, nb_valid: int, np_valid: int):
    """Sort both sides together; returns per-row run info
    (probe_match, sorted key hi, key lo, run's first build value hi, lo,
    original probe row).

    Validity: invalid rows get flag=2, keys 0xFFFFFFFF and hash 0xFFFFFFFF
    so they sort into a dead run at the end and never count.
    """
    dev = kh.device
    nb, npr = kh.shape[0], ph.shape[0]
    bvalid = torch.arange(nb, device=dev) < nb_valid
    pvalid = torch.arange(npr, device=dev) < np_valid

    valid_all = torch.cat([bvalid, pvalid])
    ch = torch.where(valid_all, widen(torch.cat([kh, ph])), MASK32)
    cl = torch.where(valid_all, widen(torch.cat([kl, pl])), MASK32)
    zeros_p = torch.zeros(npr, dtype=torch.int64, device=dev)
    cv_h = torch.cat([widen(vh), zeros_p])
    cv_l = torch.cat([widen(vl), zeros_p])
    # flag: 0 = build, 1 = probe, 2 = invalid (either side)
    flag = torch.cat([torch.where(bvalid, 0, 2), torch.where(pvalid, 1, 2)])
    orig = torch.cat([torch.zeros(nb, dtype=torch.int64, device=dev),
                      torch.arange(npr, device=dev)])

    h = torch.where(flag == 2, MASK32, hash_u64(ch, cl))

    order = torch.argsort((cl << 2) | flag, stable=True)
    for key in (ch, h):
        order = order[torch.argsort(key[order], stable=True)]
    hs, chs, cls, fs, vhs, vls, origs = (
        x[order] for x in (h, ch, cl, flag, cv_h, cv_l, orig))

    newk = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (chs[1:] != chs[:-1]) | (cls[1:] != cls[:-1]) | (hs[1:] != hs[:-1]),
    ])
    segid = torch.cumsum(newk, 0) - 1

    is_build = fs == 0

    # propagate (has_build, first build value) through each run; build
    # rows sort first within a run, so any probe row sees them.
    def comb(a, b):
        ha, vha, vla = a
        hb, vhb, vlb = b
        keep_a = ha > 0
        return (torch.maximum(ha, hb),
                torch.where(keep_a, vha, vhb),
                torch.where(keep_a, vla, vlb))

    hasb, bvh, bvl = segmented_scan(
        comb,
        (is_build.to(torch.int64),
         torch.where(is_build, vhs, 0),
         torch.where(is_build, vls, 0)),
        segid,
    )
    probe_match = (fs == 1) & (hasb > 0)
    return probe_match, chs, cls, bvh, bvl, origs


def merge_join_count(kh, kl, vh, vl, ph, pl, nb_valid: int,
                     np_valid: int) -> torch.Tensor:
    """Exact first-match count; a 0-d int64 tensor on the inputs' device."""
    probe_match, *_ = _sorted_runs(kh, kl, vh, vl, ph, pl, nb_valid,
                                   np_valid)
    return probe_match.sum()


def merge_join_materialize(kh, kl, vh, vl, ph, pl, nb_valid: int,
                           np_valid: int):
    """Returns (count, out_kh, out_kl, out_vh, out_vl): the matched rows
    compacted to the front (K5 on the card), in (hash, key) order, each
    with the value of its key's minimum build row; int32 bit-pattern planes
    of the probe side's length."""
    probe_match, chs, cls, bvh, bvl, _ = _sorted_runs(
        kh, kl, vh, vl, ph, pl, nb_valid, np_valid)
    count, outs = compact_by_mask(probe_match, (chs, cls, bvh, bvl),
                                  n_out=ph.shape[0])
    return (count, *outs)
