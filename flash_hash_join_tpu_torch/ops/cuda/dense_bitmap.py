"""K1: dense-domain bitmap count join (csrc/dense_bitmap.cu).

Replaces flash_hash_join_tpu/ops/pallas/dense_bitmap.py:fused_bitmap_join.
Takes UNSORTED build and probe domain indices: the CUDA kernel addresses
every bitmap word directly, so the TPU kernel's block sort, `rs` row
windows and `sels` staging have no job here, and its unresolved counts are
always 0.

Domain indices are 1-D int32 tensors of u32 bit patterns (utils/u64.py),
sentinel 0xFFFFFFFF (= -1); the bitmap is (d_rows, 128) int32 words, word
w = idx >> 5 holding bit idx & 31.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.bitmap_probe import (
    BITS_PER_ROW, LANES, check_idx, member)
from flash_hash_join_tpu_torch.utils.u64 import narrow, widen

MAX_D_ROWS = 28672          # the XL rung of ops/direct_bitmap.py (14.7 MB)


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
    if not 8 <= d_rows <= MAX_D_ROWS:
        raise ValueError(f"d_rows must be in [8, {MAX_D_ROWS}], got {d_rows}")
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
