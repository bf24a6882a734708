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
they are and hash each key in-kernel, and both search fences in shared
memory: the key of every `fence_stride(R)`-th slot of every bucket
(`bucket_fences`).  Up to STAGED_MAX_R_SLOTS rows for K11 and
COUNT_STAGED_MAX_R_SLOTS for K10, whose table has no values, the stride is
1, so the whole table (with K11's values) sits in shared memory and the
search ends there.  Above, the stride is RUN_KEYS: the kernel first builds
a layout of its own from the planes in one launch (`bucket_major`: the
keys bucket-major as u64 and K11's values as interleaved (vh, vl) pairs;
`bucket_major_keys`: K10's, the keys alone), and a probe's run of RUN_KEYS
keys, one 64-byte line, is read by 4 lanes together and compared at once.
Both take R a power of two in [8, 512] (`_check_rung`, the rungs of
ops/bucket_table.r_slots_for).
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.hashing import hash_u64
from flash_hash_join_tpu_torch.utils.u64 import widen

LANES = 128
BUCKET_BITS = 7
MAX_R_SLOTS = 512
STAGED_MAX_R_SLOTS = 32            # K11: its whole table in shared memory
COUNT_STAGED_MAX_R_SLOTS = 128     # K10: its keys alone in shared memory
RUN_KEYS = 8                       # above: u64 keys a run, one 64-byte line


def probe_buckets(ph: torch.Tensor, pl: torch.Tensor,
                  pre_shift: int = 0) -> torch.Tensor:
    """Bucket of each probe key (int64 in [0, 128)): the top BUCKET_BITS of
    its hash after discarding the top pre_shift bits."""
    h = hash_u64(ph, pl)
    return ((h << pre_shift) & 0xFFFFFFFF) >> (32 - BUCKET_BITS)


def _check_tables(tables: dict, dev) -> None:
    r_slots = tables["tk_hi"].shape[0]
    for name, t in tables.items():
        if (t.dtype != torch.int32 or t.shape != (r_slots, LANES)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous ({r_slots}, "
                             f"{LANES}) int32 tensor on the probes' device")
    if not 1 <= r_slots <= MAX_R_SLOTS:
        raise ValueError(f"1 to {MAX_R_SLOTS} slot rows, got {r_slots}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check(tables: dict, ph, pl, np_valid: int, pre_shift: int):
    _check_tables(tables, ph.device)
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
    column of the table; a 0-d int64 tensor.  The table's R must be a
    power of two in [8, 512].  CPU tensors take the plain version; CUDA
    tensors launch the kernel (above COUNT_STAGED_MAX_R_SLOTS rows, the
    keys-only layout kernel first)."""
    dev = _check({"tk_hi": tk_hi, "tk_lo": tk_lo}, ph, pl, np_valid,
                 pre_shift)
    _check_rung(tk_hi.shape[0])
    if dev.type == "cpu":
        return probe_count_vmem_plain(tk_hi, tk_lo, ph, pl, np_valid,
                                      pre_shift)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if np_valid == 0:
        return count[0]
    keys = _keys_scratch(tk_hi)     # read above COUNT_STAGED_MAX_R_SLOTS only
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_bucket_probe_count(
        tk_hi.data_ptr(), tk_lo.data_ptr(), tk_hi.shape[0], keys.data_ptr(),
        ph.data_ptr(), pl.data_ptr(), np_valid, pre_shift, count.data_ptr(),
        stream)
    probe_count_vmem.launches += 1
    _build.check(err, "probe_count_vmem")
    return count[0]


probe_count_vmem.launches = 0


def _u64_words(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern planes -> int64 holding the u64 bit patterns."""
    return hi.to(torch.int64) << 32 | widen(lo)


def fence_stride(r_slots: int, staged_max: int = STAGED_MAX_R_SLOTS) -> int:
    """Slots between two fences: 1 (every slot) up to staged_max rows
    (K11's STAGED_MAX_R_SLOTS, K10's COUNT_STAGED_MAX_R_SLOTS), RUN_KEYS
    above."""
    return 1 if r_slots <= staged_max else RUN_KEYS


def bucket_fences(tk_hi: torch.Tensor, tk_lo: torch.Tensor,
                  staged_max: int = STAGED_MAX_R_SLOTS) -> torch.Tensor:
    """The fences the kernels' blocks stage in shared memory: (R // stride,
    128) int64, [j, b] = the u64 bit pattern of slot stride * j of bucket
    b, stride = fence_stride(R, staged_max)."""
    at = slice(None, None, fence_stride(tk_hi.shape[0], staged_max))
    return _u64_words(tk_hi[at], tk_lo[at])


def bucket_major_keys_plain(tk_hi, tk_lo):
    """Plain PyTorch version of K10's layout launch: keys (128, R) int64,
    [b, r] = the u64 bit pattern of slot r of bucket b."""
    return _u64_words(tk_hi, tk_lo).t().contiguous()


def bucket_major_plain(tk_hi, tk_lo, tv_hi, tv_lo):
    """Plain PyTorch version of K11's layout launch: (keys, values) with
    keys as bucket_major_keys_plain returns them and values (128, R, 2)
    int32, [b, r] = slot r of bucket b's (vh, vl)."""
    values = torch.stack([tv_hi, tv_lo], dim=-1).transpose(0, 1).contiguous()
    return bucket_major_keys_plain(tk_hi, tk_lo), values


def _check_rung(r_slots: int) -> None:
    if not 8 <= r_slots <= MAX_R_SLOTS or r_slots & (r_slots - 1):
        raise ValueError(f"K10 and K11 take a power of two in [8, "
                         f"{MAX_R_SLOTS}] slot rows, got {r_slots}")


def bucket_major_keys(tk_hi, tk_lo):
    """K10's copy of the table's keys above COUNT_STAGED_MAX_R_SLOTS rows,
    as bucket_major_keys_plain returns it (any rung).  CPU tensors take the
    plain version; CUDA tensors launch the layout kernel, the first of
    K10's two launches there (not counted on its own)."""
    tables = {"tk_hi": tk_hi, "tk_lo": tk_lo}
    _check_tables(tables, tk_hi.device)
    _check_rung(tk_hi.shape[0])
    if tk_hi.device.type == "cpu":
        return bucket_major_keys_plain(tk_hi, tk_lo)
    keys = _keys_scratch(tk_hi)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _build.lib().fhj_bucket_major(
        tk_hi.data_ptr(), tk_lo.data_ptr(), None, None, tk_hi.shape[0],
        keys.data_ptr(), None, stream)
    _build.check(err, "bucket_major_keys")
    return keys


def bucket_major(tk_hi, tk_lo, tv_hi, tv_lo):
    """K11's copy of the table above STAGED_MAX_R_SLOTS rows, as
    bucket_major_plain returns it (any rung).  CPU tensors take the plain
    version; CUDA tensors launch the layout kernel, the first of K11's two
    launches there (not counted on its own)."""
    tables = {"tk_hi": tk_hi, "tk_lo": tk_lo, "tv_hi": tv_hi, "tv_lo": tv_lo}
    _check_tables(tables, tk_hi.device)
    _check_rung(tk_hi.shape[0])
    if tk_hi.device.type == "cpu":
        return bucket_major_plain(tk_hi, tk_lo, tv_hi, tv_lo)
    keys, values = _bucket_major_scratch(tk_hi)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _build.lib().fhj_bucket_major(
        *(t.data_ptr() for t in tables.values()), tk_hi.shape[0],
        keys.data_ptr(), values.data_ptr(), stream)
    _build.check(err, "bucket_major")
    return keys, values


def _keys_scratch(tk_hi):
    return torch.empty((LANES, tk_hi.shape[0]), dtype=torch.int64,
                       device=tk_hi.device)


def _bucket_major_scratch(tk_hi):
    return (_keys_scratch(tk_hi),
            torch.empty((LANES, tk_hi.shape[0], 2), dtype=torch.int32,
                        device=tk_hi.device))


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
    The table's R must be a power of two in [8, 512] (r_slots_for's
    rungs).  CPU tensors take the plain version; CUDA tensors launch the
    kernel (above STAGED_MAX_R_SLOTS rows, the layout kernel first)."""
    tables = {"tk_hi": tk_hi, "tk_lo": tk_lo, "tv_hi": tv_hi, "tv_lo": tv_lo}
    dev = _check(tables, ph, pl, np_valid, pre_shift)
    _check_rung(tk_hi.shape[0])
    if dev.type == "cpu":
        return probe_materialize_vmem_plain(tk_hi, tk_lo, tv_hi, tv_lo, ph,
                                            pl, np_valid, pre_shift)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    keys, values = _bucket_major_scratch(tk_hi)    # read above R 32 only
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_bucket_probe_materialize(
        tk_hi.data_ptr(), tk_lo.data_ptr(), tv_hi.data_ptr(),
        tv_lo.data_ptr(), tk_hi.shape[0], keys.data_ptr(), values.data_ptr(),
        ph.data_ptr(), pl.data_ptr(), n, np_valid, pre_shift, hit.data_ptr(),
        vh.data_ptr(), vl.data_ptr(), stream)
    probe_materialize_vmem.launches += 1
    _build.check(err, "probe_materialize_vmem")
    return hit, vh, vl


probe_materialize_vmem.launches = 0
