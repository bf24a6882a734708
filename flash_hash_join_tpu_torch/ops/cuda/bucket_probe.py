"""K10 / K11: probe of the `vmem` tier's bucket table, count and
materialize (csrc/bucket_probe.cu).

Replaces flash_hash_join_tpu/ops/pallas/bucket_probe.py:probe_count_vmem
and :probe_materialize_vmem.  The table (ops/bucket_table.py) is slot-major
(R, 128) int32 planes: column b holds bucket b's kept keys at rows
0 .. k-1, ascending by u64 key, and u64-max (empty) below them.  A probe's
bucket is the top 7 bits of hash_u64 of its key after pre_shift.  A probe
hits when its key sits in its bucket's column; a u64-max probe key never
hits (the caller answers it from the table's `special`).  Rows at or past
np_valid never hit.

The TPU kernels take the probes padded into (M, 128) tiles with a bucket
plane computed outside, and scan all R slot rows per tile because Mosaic
gathers only within a vreg.  The CUDA kernels take the probe planes as
they are, hash each key in-kernel and search its bucket's sorted column.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.hashing import hash_u64

LANES = 128
BUCKET_BITS = 7
MAX_R_SLOTS = 512


def probe_buckets(ph: torch.Tensor, pl: torch.Tensor,
                  pre_shift: int = 0) -> torch.Tensor:
    """Bucket of each probe key (int64 in [0, 128)): the top BUCKET_BITS of
    its hash after discarding the top pre_shift bits."""
    h = hash_u64(ph, pl)
    return ((h << pre_shift) & 0xFFFFFFFF) >> (32 - BUCKET_BITS)


def _check(tables: dict, ph, pl, np_valid: int, pre_shift: int):
    r_slots = tables["tk_hi"].shape[0]
    for name, t in tables.items():
        if (t.dtype != torch.int32 or t.shape != (r_slots, LANES)
                or not t.is_contiguous() or t.device != ph.device):
            raise ValueError(f"{name} must be a contiguous ({r_slots}, "
                             f"{LANES}) int32 tensor on the probes' device")
    if not 1 <= r_slots <= MAX_R_SLOTS:
        raise ValueError(f"1 to {MAX_R_SLOTS} slot rows, got {r_slots}")
    for name, p in (("ph", ph), ("pl", pl)):
        if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {p.dtype} of shape {tuple(p.shape)}")
    if pl.shape != ph.shape:
        raise ValueError("ph and pl must have equal length")
    if not 0 <= np_valid <= ph.numel():
        raise ValueError(f"np_valid must be in [0, {ph.numel()}], got "
                         f"{np_valid}")
    if not 0 <= pre_shift <= 32 - BUCKET_BITS:
        raise ValueError(f"pre_shift must be in [0, {32 - BUCKET_BITS}]")
    if ph.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ph.device}")
    return ph.device


def _slot_of(tk_hi, tk_lo, ph, pl, np_valid: int, pre_shift: int):
    """Plain search: (hit, slot row, bucket) per probe row, by a scan of
    all R slot rows of the probe's bucket (the TPU kernel's order)."""
    bkt = probe_buckets(ph, pl, pre_shift)
    hit = torch.zeros(ph.shape, dtype=torch.bool, device=ph.device)
    row = torch.zeros_like(bkt)
    for r in range(tk_hi.shape[0]):
        eq = (tk_hi[r][bkt] == ph) & (tk_lo[r][bkt] == pl)
        row = torch.where(eq, r, row)
        hit |= eq
    hit &= ~((ph == -1) & (pl == -1))          # u64-max: empty slots only
    hit &= torch.arange(ph.numel(), device=ph.device) < np_valid
    return hit, row, bkt


def probe_count_vmem_plain(tk_hi, tk_lo, ph, pl, np_valid: int,
                           pre_shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K10: the count as a 0-d int64."""
    return _slot_of(tk_hi, tk_lo, ph, pl, np_valid, pre_shift)[0].sum()


def probe_count_vmem(tk_hi: torch.Tensor, tk_lo: torch.Tensor,
                     ph: torch.Tensor, pl: torch.Tensor, np_valid: int,
                     pre_shift: int = 0) -> torch.Tensor:
    """Count the probe rows [0, np_valid) whose key is in its bucket's
    column of the table; a 0-d int64 tensor.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    dev = _check({"tk_hi": tk_hi, "tk_lo": tk_lo}, ph, pl, np_valid,
                 pre_shift)
    if dev.type == "cpu":
        return probe_count_vmem_plain(tk_hi, tk_lo, ph, pl, np_valid,
                                      pre_shift)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if np_valid == 0:
        return count[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_bucket_probe_count(
        tk_hi.data_ptr(), tk_lo.data_ptr(), tk_hi.shape[0], ph.data_ptr(),
        pl.data_ptr(), np_valid, pre_shift, count.data_ptr(), stream)
    probe_count_vmem.launches += 1
    _build.check(err, "probe_count_vmem")
    return count[0]


probe_count_vmem.launches = 0


def probe_materialize_vmem_plain(tk_hi, tk_lo, tv_hi, tv_lo, ph, pl,
                                 np_valid: int, pre_shift: int = 0):
    """Plain PyTorch version of K11: (hit bool, vh, vl int32) per probe
    row."""
    hit, row, bkt = _slot_of(tk_hi, tk_lo, ph, pl, np_valid, pre_shift)
    return (hit, torch.where(hit, tv_hi[row, bkt], 0),
            torch.where(hit, tv_lo[row, bkt], 0))


def probe_materialize_vmem(tk_hi: torch.Tensor, tk_lo: torch.Tensor,
                           tv_hi: torch.Tensor, tv_lo: torch.Tensor,
                           ph: torch.Tensor, pl: torch.Tensor, np_valid: int,
                           pre_shift: int = 0):
    """Per probe row: (hit, vh, vl) — a bool mask and the int32 value
    planes of the probe key's slot (0 on a miss and at or past np_valid).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check({"tk_hi": tk_hi, "tk_lo": tk_lo, "tv_hi": tv_hi,
                  "tv_lo": tv_lo}, ph, pl, np_valid, pre_shift)
    if dev.type == "cpu":
        return probe_materialize_vmem_plain(tk_hi, tk_lo, tv_hi, tv_lo, ph,
                                            pl, np_valid, pre_shift)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_bucket_probe_materialize(
        tk_hi.data_ptr(), tk_lo.data_ptr(), tv_hi.data_ptr(),
        tv_lo.data_ptr(), tk_hi.shape[0], ph.data_ptr(), pl.data_ptr(), n,
        np_valid, pre_shift, hit.data_ptr(), vh.data_ptr(), vl.data_ptr(),
        stream)
    probe_materialize_vmem.launches += 1
    _build.check(err, "probe_materialize_vmem")
    return hit, vh, vl


probe_materialize_vmem.launches = 0
