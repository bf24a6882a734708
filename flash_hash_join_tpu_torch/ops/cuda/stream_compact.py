"""K5 and K6: stream compaction kernels (csrc/stream_compact.cu).

K5 replaces flash_hash_join_tpu/ops/pallas/stream_compact.py:
pack_concat_blocks, through its wrapper compact_by_mask_pack: the rows of
V int32 planes whose mask is set come first, in input order, sort-free.
The TPU kernel carries a running total across its sequential grid; the
CUDA kernel does the same in one launch by a single-pass scan with a
decoupled look-back over tiles of TILE_ROWS mask rows, and writes the total
to the card.  The TPU kernel's lane-major count layout, lane rotations and
MXU permutation matmul are not ported: the CUDA kernel writes each hit to
its own address.

K6 replaces :concat_ragged_blocks, the second half of the FHJ_COMPACT=
stream route (ops/compact.py:compact_by_mask_stream): blocks whose valid
elements are already at their front are concatenated at exact offsets.
The TPU kernel's running total becomes K5's decoupled look-back over the
blocks, in the same launch as the copy, which also leaves the total on the
card.  Its carried partial row, lane rotation, ordered DMA writes and 8
rows of output slack are not ported: each block is copied to its own
offset, in whole 16-byte stores.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils import spans

MAX_PLANES = 4
TILE_ROWS = 8192        # mask rows a K5 tile: fhj_compact_tile_rows()


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
    tensor on the mask's device, with no host sync.  CPU tensors take the
    plain version; CUDA tensors launch the kernel: one memset of its
    scratch and one launch."""
    cols = tuple(cols)
    dev = _check(mask, cols, n_out)
    if dev.type == "cpu":
        return compact_by_mask_plain(mask, cols, n_out)
    outs = tuple(torch.empty(n_out, dtype=torch.int32, device=dev)
                 for _ in cols)
    n = mask.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), outs
    # [0] the count, [1] the tile counter, then one look-back state a tile
    # (a misaligned view's first tile holds fewer rows: 2 tiles of slack)
    scratch = torch.empty(n // TILE_ROWS + 4, dtype=torch.int64, device=dev)
    ptrs = [c.data_ptr() for c in cols] + [None] * (MAX_PLANES - len(cols))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_PLANES - len(cols))
    with spans.span(spans.K_COMPACT):
        err = _build.lib().fhj_compact_by_mask(
            mask.data_ptr(), n, len(cols), *ptrs, *out_ptrs, n_out,
            scratch.data_ptr(), scratch.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "compact_by_mask")
    return scratch[0], outs


def _check_blocks(planes, counts) -> torch.device:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, got {len(planes)}")
    shape = planes[0].shape
    for p in planes:
        if (p.dtype != torch.int32 or p.dim() != 2 or p.shape != shape
                or not p.is_contiguous() or p.device != counts.device):
            raise ValueError("each plane must be a contiguous 2-D int32 "
                             "tensor (nblocks, block_elems), all alike, on "
                             "the counts' device")
    if counts.dim() != 1 or counts.numel() != shape[0] or (
            counts.dtype not in (torch.int32, torch.int64)):
        raise ValueError("counts must be one int32 or int64 per block")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {counts.device}")
    return counts.device


def concat_ragged_blocks_plain(planes, counts):
    """Plain PyTorch version of K6: the same concatenation by index
    arithmetic (the output position's block by a search of the running
    ends, its source at that block's start plus its rank in the block)."""
    nblocks, block_elems = planes[0].shape
    counts = counts.clamp(0, block_elems).to(torch.int64)
    ends = torch.cumsum(counts, 0)
    total = int(ends[-1]) if nblocks else 0
    at = torch.arange(total, device=counts.device)
    block = torch.searchsorted(ends, at, right=True)
    src = block * block_elems + at - (ends - counts)[block]
    outs = []
    for p in planes:
        out = torch.zeros(p.numel(), dtype=torch.int32, device=p.device)
        out[:total] = p.view(-1)[src]
        outs.append(out)
    return tuple(outs)


def concat_ragged_blocks(planes, counts: torch.Tensor, *,
                         with_total: bool = False):
    """Concatenate the blocks' valid prefixes: planes are 1-4 int32
    tensors (nblocks, block_elems) whose row b holds its valid elements in
    its first counts[b] words (counts are clamped to [0, block_elems]).
    Returns flat int32 planes of nblocks * block_elems words whose prefix of
    sum(counts) words is the concatenation, in block order; words past it
    are unspecified.  With with_total, returns (total, planes), total the
    sum of the clamped counts as a 0-d int64 tensor on the counts' device.
    CPU tensors take the plain version; CUDA tensors launch the kernel: one
    memset of its scratch and one launch, which also computes the blocks'
    offsets and the total."""
    planes = tuple(planes)
    dev = _check_blocks(planes, counts)
    nblocks, block_elems = planes[0].shape
    if dev.type == "cpu":
        outs = concat_ragged_blocks_plain(planes, counts)
        total = counts.clamp(0, block_elems).sum(dtype=torch.int64)
        return (total, outs) if with_total else outs
    outs = tuple(torch.empty(p.numel(), dtype=torch.int32, device=dev)
                 for p in planes)
    if nblocks == 0:
        total = torch.zeros((), dtype=torch.int64, device=dev)
        return (total, outs) if with_total else outs
    counts = counts.contiguous()
    # [0] the total, [1] the block counter, then one look-back state a block
    scratch = torch.empty(nblocks + 2, dtype=torch.int64, device=dev)
    ptrs = [p.data_ptr() for p in planes] + [None] * (MAX_PLANES - len(planes))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_PLANES - len(outs))
    with spans.span(spans.K_CONCAT_RAGGED_BLOCKS):
        err = _build.lib().fhj_concat_ragged_blocks(
            counts.data_ptr(), counts.element_size(), nblocks, block_elems,
            len(planes), *ptrs, *out_ptrs, scratch.data_ptr(),
            scratch.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "concat_ragged_blocks")
    return (scratch[0], outs) if with_total else outs
