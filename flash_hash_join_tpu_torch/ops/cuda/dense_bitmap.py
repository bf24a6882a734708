"""K1: dense-domain bitmap count join (csrc/dense_bitmap.cu).

Replaces flash_hash_join_tpu/ops/pallas/dense_bitmap.py:fused_bitmap_join
together with the domain mapping that the JAX package's
direct_join_count_large does around it: `fused_domain_bitmap_join` reads
the u32 key planes and maps them to lo-relative domain indices in
registers, so the card runs no int64 pass over the rows.  The CUDA kernel
addresses every bitmap word directly, so the TPU kernel's block sort, `rs`
row windows and `sels` staging have no job here, and nothing is ever
unresolved.

The TPU kernel's index form (UNSORTED domain indices, 1-D int32 tensors of
u32 bit patterns, utils/u64.py, sentinel 0xFFFFFFFF = -1, into a
(d_rows, 128) int32 word bitmap, word w = idx >> 5 holding bit idx & 31)
has no CUDA entry; its plain version, `fused_bitmap_join_plain`, is held
against the Pallas kernel in the CPU tests and is half of the domain
entry's plain version.  The int64 mapping it takes its indices from lives
in ops/domain_map.py.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.bitmap_probe import (
    check_key_planes, member)
from flash_hash_join_tpu_torch.ops.domain_map import (
    BITS_PER_ROW, LANES, build_domain_idx, masked_min, pack_bitmap,
    probe_domain_idx)
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import widen

MAX_D_ROWS = 28672          # the XL rung of ops/direct_bitmap.py (14.7 MB)


def fused_bitmap_join_plain(build_idx: torch.Tensor, probe_idx: torch.Tensor,
                            d_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's index form: build a bitmap
    from build_idx, count the probe_idx members; a 0-d int64."""
    bitmap = pack_bitmap(build_idx, d_rows)
    return member(bitmap, probe_idx, d_rows).sum()


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
    if not 8 <= d_rows <= MAX_D_ROWS:
        raise ValueError(f"d_rows must be in [8, {MAX_D_ROWS}], got {d_rows}")
    dev = kh.device
    check_key_planes(kh, kl, nb_valid, "build", dev)
    check_key_planes(ph, pl, np_valid, "probe", dev)
    if dev.type == "cpu":
        return fused_domain_bitmap_join_plain(kh, kl, ph, pl, nb_valid,
                                              np_valid, d_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bitmap = torch.empty((d_rows, LANES), dtype=torch.int32, device=dev)
    scratch = torch.empty(3, dtype=torch.int64, device=dev)  # count, n_bad, lo
    stream = torch.cuda.current_stream(dev).cuda_stream
    # no kernel runs on an empty build side: memsets only
    with spans.span(spans.K_DENSE_BITMAP) if nb_valid > 0 else spans.NONE:
        err = _build.lib().fhj_fused_domain_bitmap_join(
            kh.data_ptr(), kl.data_ptr(), nb_valid, ph.data_ptr(),
            pl.data_ptr(), np_valid, bitmap.data_ptr(), d_rows,
            scratch.data_ptr(), stream)
    _build.check(err, "fused_domain_bitmap_join")
    return scratch[0], scratch[1]
