"""Stream compaction of matched rows — shared by every materialize path
(port of flash_hash_join_tpu/ops/compact.py, whose callers reach the
compaction kernels through stream_compact.compact_by_mask_fast).

Both routes are stable: the hits keep their input order.  FHJ_COMPACT,
read at each call as in the JAX package, picks one:
  "pack" (the default)  K5 (ops/cuda/stream_compact.py), sort-free;
  anything else         compact_by_mask_stream: a blockwise sort, then K6.
This entry point takes what the join code holds — a bool mask and planes
as int32 bit patterns or widened int64 (utils/u64.py) — and hands the
kernels contiguous int32 planes.
"""

from __future__ import annotations

import os

import torch

from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import narrow

LANES = 128
DEFAULT_BLOCK_ROWS = 512     # 64K-element blocks, as in the JAX package


def stream_blocks(mask: torch.Tensor, cols, n_out: int, *,
                  block_rows: int = DEFAULT_BLOCK_ROWS):
    """K6's inputs: (planes, counts).  The mask and the int32 planes,
    padded to whole blocks of block_rows * 128 rows (at least n_out rows),
    each block sorted by (miss, position) so that its hits come first in
    input order; counts: hits per block, int32."""
    n = mask.numel()
    block = block_rows * LANES
    nblocks = max(1, -(-max(n, n_out) // block))
    pad = nblocks * block - n
    miss = torch.cat([~mask, mask.new_ones(pad)]).view(nblocks, block)
    counts = block - miss.sum(1, dtype=torch.int32)
    # keys are unique (miss * block + position < 2^31), so any sort order
    # is the stable partition
    key = miss.to(torch.int32) * block + torch.arange(
        block, dtype=torch.int32, device=mask.device)
    perm = torch.sort(key, dim=1).indices
    planes = tuple(torch.gather(torch.cat([c, c.new_zeros(pad)]).view(
        nblocks, block), 1, perm) for c in cols)
    return planes, counts


def compact_by_mask_stream(mask: torch.Tensor, cols, n_out: int | None = None,
                           *, block_rows: int = DEFAULT_BLOCK_ROWS):
    """Stable compaction by blocks (port of flash_hash_join_tpu/ops/pallas/
    stream_compact.py:compact_by_mask_stream): stream_blocks moves each
    block's hits to its front, then K6 concatenates the blocks' prefixes;
    the count is K6's total.  mask: bool; cols: int32 planes of the mask's
    length.  Same result as compact_by_mask, which spans it."""
    n_out = mask.numel() if n_out is None else n_out
    planes, counts = stream_blocks(mask, cols, n_out, block_rows=block_rows)
    total, outs = sc.concat_ragged_blocks(planes, counts, with_total=True)
    return total, tuple(o[:n_out] for o in outs)


def compact_by_mask(mask: torch.Tensor, cols, n_out: int | None = None):
    """Return (count, cols') with the rows where mask is True moved to the
    front of each column, in input order; cols' are int32 planes of n_out
    rows (default: the mask's length), unspecified past count.  count is a
    0-d int64 tensor.  One fhj.compact span (utils/spans.py)."""
    with spans.span(spans.COMPACT):
        planes = tuple((narrow(c) if c.dtype == torch.int64 else c)
                       .contiguous() for c in cols)
        mask = mask.contiguous()
        n_out = mask.numel() if n_out is None else n_out
        if os.environ.get("FHJ_COMPACT", "pack") == "pack":
            return sc.compact_by_mask(mask, planes, n_out)
        return compact_by_mask_stream(mask, planes, n_out)
