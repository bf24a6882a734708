"""K2: membership count in a small bitmap (csrc/bitmap_probe.cu).

Replaces flash_hash_join_tpu/ops/pallas/bitmap_probe.py:probe_count_bitmap,
the scan band of the dense-domain count (d_rows <= 256, spans <= 2^20).
The TPU kernel scans every bitmap row per tile; the CUDA kernel stages the
bitmap in shared memory and reads each probe's word directly.

Bitmap: (d_rows, 128) int32 words, word w = idx >> 5 holds bit idx & 31.
Indices: 1-D int32 tensor of u32 bit patterns, sentinel 0xFFFFFFFF (= -1);
any index >= d_rows * 4096 counts nothing.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils.u64 import widen

LANES = 128
BITS_PER_ROW = 32 * LANES          # 4096 domain slots per bitmap row
MAX_D_ROWS = 256                   # 2^20-slot domain cap (128 KB of shared memory)


def check_idx(idx: torch.Tensor, name: str) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")


def member(bitmap: torch.Tensor, idx: torch.Tensor, d_rows: int) -> torch.Tensor:
    """Plain bit test: bool mask of the indices whose bit is set."""
    n_bits = d_rows * BITS_PER_ROW
    v = widen(idx)
    ok = v < n_bits
    words = widen(bitmap.reshape(-1))[torch.where(ok, v >> 5, 0)]
    return ok & (((words >> (v & 31)) & 1) == 1)


def probe_count_bitmap_plain(bitmap: torch.Tensor, idx: torch.Tensor,
                             d_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the count as a 0-d int64."""
    return member(bitmap, idx, d_rows).sum()


def probe_count_bitmap(bitmap: torch.Tensor, idx: torch.Tensor,
                       d_rows: int) -> torch.Tensor:
    """Count the indices whose bit is set; a 0-d int64 tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if not 8 <= d_rows <= MAX_D_ROWS:
        raise ValueError(f"d_rows must be in [8, {MAX_D_ROWS}], got {d_rows}")
    if (bitmap.dtype != torch.int32 or tuple(bitmap.shape) != (d_rows, LANES)
            or not bitmap.is_contiguous()):
        raise ValueError(f"bitmap must be a contiguous ({d_rows}, {LANES}) "
                         f"int32 tensor, got {bitmap.dtype} "
                         f"{tuple(bitmap.shape)}")
    check_idx(idx, "idx")
    dev = idx.device
    if bitmap.device != dev:
        raise ValueError("bitmap and idx must be on one device")
    if dev.type == "cpu":
        return probe_count_bitmap_plain(bitmap, idx, d_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if bitmap.data_ptr() % 16:
        raise ValueError("bitmap must be 16-byte aligned")
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if idx.numel() == 0:
        return count[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_bitmap_probe_count(
        bitmap.data_ptr(), d_rows, idx.data_ptr(), idx.numel(),
        count.data_ptr(), stream)
    probe_count_bitmap.launches += 1
    _build.check(err, "probe_count_bitmap")
    return count[0]


probe_count_bitmap.launches = 0
