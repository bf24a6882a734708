"""K5: stable, sort-free stream compaction (csrc/stream_compact.cu).

Replaces flash_hash_join_tpu/ops/pallas/stream_compact.py:
pack_concat_blocks, through its wrapper compact_by_mask_pack: the rows of
V int32 planes whose mask is set come first, in input order.  The TPU
kernel's lane-major count layout, lane rotations and MXU permutation
matmul are not ported: the CUDA kernel writes each hit to its own address.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build

MAX_PLANES = 4


def _check(mask: torch.Tensor, cols, n_out: int) -> torch.device:
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D bool tensor, got "
                         f"{mask.dtype} of shape {tuple(mask.shape)}")
    if not 1 <= len(cols) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, got {len(cols)}")
    for c in cols:
        if (c.dtype != torch.int32 or c.shape != mask.shape
                or not c.is_contiguous() or c.device != mask.device):
            raise ValueError("each plane must be a contiguous int32 tensor "
                             "shaped and placed like the mask")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {mask.device}")
    return mask.device


def compact_by_mask_plain(mask: torch.Tensor, cols, n_out: int):
    """Plain PyTorch version of the kernel: boolean indexing."""
    outs = []
    for c in cols:
        hits = c[mask][:n_out]
        out = torch.zeros(n_out, dtype=torch.int32, device=c.device)
        out[:hits.numel()] = hits
        outs.append(out)
    return mask.sum(), tuple(outs)


def compact_by_mask(mask: torch.Tensor, cols, n_out: int):
    """(count, cols'): each of the 1-4 int32 planes with its masked rows
    moved to the front in input order, n_out rows long (hits past n_out
    are dropped; rows past count are unspecified).  count is a 0-d int64
    tensor.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    cols = tuple(cols)
    dev = _check(mask, cols, n_out)
    if dev.type == "cpu":
        return compact_by_mask_plain(mask, cols, n_out)
    outs = tuple(torch.empty(n_out, dtype=torch.int32, device=dev)
                 for _ in cols)
    n = mask.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), outs
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tile_counts = torch.empty(-(-n // lib.fhj_compact_tile_rows()),
                              dtype=torch.int32, device=dev)
    _build.check(lib.fhj_compact_count(mask.data_ptr(), n,
                                       tile_counts.data_ptr(), stream),
                 "compact_by_mask (count)")
    ends = torch.cumsum(tile_counts, 0, dtype=torch.int64)
    offsets = ends - tile_counts
    ptrs = [c.data_ptr() for c in cols] + [None] * (MAX_PLANES - len(cols))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_PLANES - len(cols))
    err = lib.fhj_compact_scatter(mask.data_ptr(), n, offsets.data_ptr(),
                                  len(cols), *ptrs, *out_ptrs, n_out, stream)
    compact_by_mask.launches += 1
    _build.check(err, "compact_by_mask (scatter)")
    return ends[-1], outs


compact_by_mask.launches = 0
