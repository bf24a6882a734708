"""K1: dense-domain bitmap count join (csrc/dense_bitmap.cu).

Replaces flash_hash_join_tpu/ops/pallas/dense_bitmap.py:fused_bitmap_join
and, in `fused_domain_bitmap_join`, the domain mapping that the JAX
package's direct_join_count_large does around it: the kernel reads the u32
key planes and maps them to lo-relative domain indices in registers, so the
card runs no int64 pass over the rows.  The CUDA kernel addresses every
bitmap word directly, so the TPU kernel's block sort, `rs` row windows and
`sels` staging have no job here, and nothing is ever unresolved.

`fused_bitmap_join` keeps the TPU kernel's index form: UNSORTED domain
indices, 1-D int32 tensors of u32 bit patterns (utils/u64.py), sentinel
0xFFFFFFFF (= -1).  The bitmap is (d_rows, 128) int32 words, word w =
idx >> 5 holding bit idx & 31.

The int64 mapping (masked_min, build_domain_idx, probe_domain_idx) serves
the plain version here and the plain torch paths of ops/direct_bitmap.py.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.bitmap_probe import (
    BITS_PER_ROW, LANES, check_idx, member)
from flash_hash_join_tpu_torch.utils.u64 import MASK32, narrow, widen

MAX_D_ROWS = 28672          # the XL rung of ops/direct_bitmap.py (14.7 MB)
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


def _check_d_rows(d_rows: int) -> None:
    if not 8 <= d_rows <= MAX_D_ROWS:
        raise ValueError(f"d_rows must be in [8, {MAX_D_ROWS}], got {d_rows}")


def fused_bitmap_join_plain(build_idx: torch.Tensor, probe_idx: torch.Tensor,
                            d_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the count as a 0-d int64."""
    bitmap = pack_bitmap(build_idx, d_rows)
    return member(bitmap, probe_idx, d_rows).sum()


def fused_bitmap_join(build_idx: torch.Tensor, probe_idx: torch.Tensor,
                      d_rows: int):
    """Build a bitmap from build_idx, count probe_idx members.

    Returns (count, unres_build, unres_probe) like the TPU kernel; count is
    a 0-d int64 tensor on the inputs' device, the unresolved counts are 0.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_d_rows(d_rows)
    check_idx(build_idx, "build_idx")
    check_idx(probe_idx, "probe_idx")
    dev = build_idx.device
    if probe_idx.device != dev:
        raise ValueError("build_idx and probe_idx must be on one device")
    if dev.type == "cpu":
        return fused_bitmap_join_plain(build_idx, probe_idx, d_rows), 0, 0
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if probe_idx.numel() == 0:
        return count[0], 0, 0
    bitmap = torch.zeros((d_rows, LANES), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_fused_bitmap_join(
        build_idx.data_ptr(), build_idx.numel(), probe_idx.data_ptr(),
        probe_idx.numel(), bitmap.data_ptr(), d_rows, count.data_ptr(), stream)
    fused_bitmap_join.launches += 1
    _build.check(err, "fused_bitmap_join")
    return count[0], 0, 0


fused_bitmap_join.launches = 0


def fused_domain_bitmap_join_plain(kh, kl, ph, pl, nb_valid: int,
                                   np_valid: int, d_rows: int):
    """Plain PyTorch version of the domain entry: the int64 mapping, then
    the index form's plain version.  Returns (count, n_bad), 0-d int64."""
    d_bits = d_rows * BITS_PER_ROW
    bvalid = torch.arange(kh.shape[0], device=kh.device) < nb_valid
    # lo is the min over valid rows with a zero hi-word
    lo = masked_min(widen(kl), bvalid & (kh == 0))
    n_bad, bidx = build_domain_idx(kh, kl, bvalid, lo, d_bits)
    pidx = probe_domain_idx(ph, pl, np_valid, lo, d_bits)
    return fused_bitmap_join_plain(bidx, pidx, d_rows), n_bad


def fused_domain_bitmap_join(kh, kl, ph, pl, nb_valid: int, np_valid: int,
                             d_rows: int):
    """Dense-domain count straight from the key planes.

    kh/kl, ph/pl: the u32 (hi, lo) planes of the build and probe keys as
    1-D int32 tensors, rows [0, nb_valid) and [0, np_valid) valid.  lo is
    the least low word of the valid build rows with a zero high word
    (0xFFFFFFFF when there is none); a valid build row outside the
    d_rows * 4096 slots from lo (high word != 0, or (kl - lo) mod 2^32 past
    the domain) is bad, every other one sets its bit; the count is the
    number of valid probe rows in the domain whose bit is set.

    Returns (count, n_bad), 0-d int64 tensors on the planes' device, with
    no host sync.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    _check_d_rows(d_rows)
    for name, t in (("kh", kh), ("kl", kl), ("ph", ph), ("pl", pl)):
        check_idx(t, name)
    if kh.shape != kl.shape or ph.shape != pl.shape:
        raise ValueError("the two planes of a side must have one length")
    if not (0 <= nb_valid <= kh.numel() and 0 <= np_valid <= ph.numel()):
        raise ValueError(f"nb_valid {nb_valid} / np_valid {np_valid} outside "
                         f"the planes ({kh.numel()} / {ph.numel()} rows)")
    dev = kh.device
    if any(t.device != dev for t in (kl, ph, pl)):
        raise ValueError("the key planes must be on one device")
    if dev.type == "cpu":
        return fused_domain_bitmap_join_plain(kh, kl, ph, pl, nb_valid,
                                              np_valid, d_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bitmap = torch.empty((d_rows, LANES), dtype=torch.int32, device=dev)
    scratch = torch.empty(3, dtype=torch.int64, device=dev)  # count, n_bad, lo
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_fused_domain_bitmap_join(
        kh.data_ptr(), kl.data_ptr(), nb_valid, ph.data_ptr(), pl.data_ptr(),
        np_valid, bitmap.data_ptr(), d_rows, scratch.data_ptr(), stream)
    if nb_valid > 0:
        fused_domain_bitmap_join.launches += 1
    _build.check(err, "fused_domain_bitmap_join")
    return scratch[0], scratch[1]


fused_domain_bitmap_join.launches = 0
