"""The partitioned tier's table build on the card (csrc/range_build.cu).

Replaces no TPU kernel: the JAX package sorts the build side with a plain
lax.sort (flash_hash_join_tpu/ops/range_table.py:build_range_table), which
the port first ran as torch's stable sort of the int64 sortable keys, a
stack of the value planes and a gather of it by the sort's order.  That is
now `range_build_plain`, which the CPU takes.  Both give

  keys    the first nb_valid rows' keys as sortable int64
          (utils/u64.py:sortable), ascending, equal keys in row order;
  values  their (vh, vl) value planes in the same order, interleaved as one
          (nb_valid, 2) int32 tensor, or None without values,

bit for bit.  On the card the build is a stable LSD radix sort of 9-bit
digits that sorts only the digit positions whose digit differs between
keys, each record carrying the value words with the key: one counting
pass over the key planes, then one scatter pass a varying digit (`plan`
says which, and how wide the records are).  The card decides the plan from
the counts, with no host sync: a pass kernel is launched for every digit
position and both record widths, and one whose digit is the same in every
key, or whose width is not the plan's, returns at once.  One memset and
seventeen launches a build.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import sortable

DIGIT_BITS = 9
DIGITS = 8                  # digit positions of a u64 key: bits 0-71
PLAN_OFFSET = 4 * DIGITS * 2**DIGIT_BITS  # the plan word's byte in the scratch
MAX_ROWS = 2**31 - 1


class Plan(NamedTuple):
    """The card's sort of one build: the digit positions it sorts by,
    lowest first (a stable pass each), and the bytes a record carries
    through them (the key's low word alone while the high word is shared,
    then the value words where the build keeps values)."""
    digits: tuple
    passes: int
    record_bytes: int


def plan(varying: int, with_values: bool) -> Plan:
    """The plan for keys whose bits differ where `varying` (the OR of the
    keys XOR their AND, a u64) has a one: each 9-bit digit position with a
    varying bit; with no varying bit, digit 0 alone (a stable pass of equal
    digits is the copy into the output).  The key travels as its low word
    while no bit of the high word varies."""
    mask = (1 << DIGIT_BITS) - 1
    digits = tuple(k for k in range(DIGITS)
                   if varying >> (DIGIT_BITS * k) & mask) or (0,)
    words = (1 if varying >> 32 == 0 else 2) + (2 if with_values else 0)
    return Plan(digits, len(digits), 4 * words)


def range_build_plain(kh, kl, vh, vl, nb_valid: int, *, with_values: bool):
    """Plain PyTorch version: torch's stable sort of the sortable keys, then
    the stacked value planes gathered by its order."""
    keys, order = torch.sort(sortable(kh[:nb_valid], kl[:nb_valid]),
                             stable=True)
    values = (torch.stack((vh[:nb_valid], vl[:nb_valid]), 1)[order]
              if with_values else None)
    return keys, values


def _check(planes, nb_valid: int) -> torch.device:
    dev = planes[0].device
    n = planes[0].numel()
    for name, p in zip(("kh", "kl", "vh", "vl"), planes):
        if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {p.dtype} of shape {tuple(p.shape)}")
        if p.numel() != n:
            raise ValueError(f"{name} must have kh's {n} rows, got "
                             f"{p.numel()}")
        if p.device != dev:
            raise ValueError(f"{name} and kh must be on one device, got "
                             f"{p.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not 0 <= nb_valid <= n:
        raise ValueError(f"nb_valid must be in [0, {n}], got {nb_valid}")
    if dev.type == "cuda" and nb_valid > MAX_ROWS:
        raise ValueError(f"the build kernel takes at most {MAX_ROWS} rows, "
                         f"got {nb_valid}")
    return dev


def _launch(planes, n: int, with_values: bool):
    """(keys, values, scratch) of the kernels' build of n >= 1 rows: out
    holds the keys, then the values; one allocation holds the passes'
    other buffer, as large, then the scratch (at a 256-byte boundary: the
    kernels read its tile states 16 bytes at a time)."""
    dev = planes[0].device
    buf_bytes = n * (16 if with_values else 8)
    out = torch.empty(buf_bytes // 4, dtype=torch.int32, device=dev)
    at = -(-buf_bytes // 256) * 256
    with torch.cuda.device(dev):
        lib = _build.lib()
        work = torch.empty(at + lib.fhj_range_build_scratch_bytes(n),
                           dtype=torch.uint8, device=dev)
        scratch = work[at:]
        with spans.span(spans.K_RANGE_BUILD):
            err = lib.fhj_range_build(
                *(p.data_ptr() for p in planes), n, int(with_values),
                out.data_ptr(), work.data_ptr(), scratch.data_ptr(),
                scratch.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "range_build")
    keys = out[:2 * n].view(torch.int64)
    values = out[2 * n:].view(n, 2) if with_values else None
    return keys, values, scratch


def range_build(kh: torch.Tensor, kl: torch.Tensor, vh: torch.Tensor,
                vl: torch.Tensor, nb_valid: int, *, with_values: bool):
    """(keys, values) of the rows [0, nb_valid) of the int32 build planes:
    the sortable int64 keys ascending, equal keys in row order, and their
    (nb_valid, 2) int32 (vh, vl) pairs in the same order, or None without
    values.  CPU tensors take the plain version; CUDA tensors launch the
    kernels on the current stream, with no host sync."""
    planes = (kh, kl, vh, vl)
    dev = _check(planes, nb_valid)
    if dev.type == "cpu":
        return range_build_plain(kh, kl, vh, vl, nb_valid,
                                 with_values=with_values)
    if nb_valid == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty((0, 2), dtype=torch.int32, device=dev)
                if with_values else None)
    keys, values, _ = _launch(planes, nb_valid, with_values)
    return keys, values


def device_plan(kh, kl, vh, vl, nb_valid: int, *, with_values: bool) -> Plan:
    """The plan the card took for a build of these planes (CUDA tensors,
    nb_valid >= 1): the build, then a read of its plan word, which syncs.
    For tests and chip_smoke.py."""
    planes = (kh, kl, vh, vl)
    if _check(planes, nb_valid).type != "cuda" or nb_valid < 1:
        raise ValueError("device_plan needs CUDA planes and a valid row")
    _, _, scratch = _launch(planes, nb_valid, with_values)
    word = int(scratch[PLAN_OFFSET:PLAN_OFFSET + 4].view(torch.int32))
    digits = tuple(k for k in range(DIGITS) if word >> k & 1)
    words = (1 if word >> 8 & 1 else 2) + (2 if with_values else 0)
    return Plan(digits, len(digits), 4 * words)
