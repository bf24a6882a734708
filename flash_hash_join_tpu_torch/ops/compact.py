"""Stream compaction of matched rows — shared by every materialize path
(port of flash_hash_join_tpu/ops/compact.py, whose callers now reach the
pack kernel through compact_by_mask_fast).

On the card it runs K5 (ops/cuda/stream_compact.py), which is stable: the
hits keep their input order.  This entry point takes what the join code
holds — a bool mask and planes as int32 bit patterns or widened int64
(utils/u64.py) — and hands K5 contiguous int32 planes.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
from flash_hash_join_tpu_torch.utils.u64 import narrow


def compact_by_mask(mask: torch.Tensor, cols, n_out: int | None = None):
    """Return (count, cols') with the rows where mask is True moved to the
    front of each column, in input order; cols' are int32 planes of n_out
    rows (default: the mask's length), unspecified past count.  count is a
    0-d int64 tensor."""
    planes = tuple((narrow(c) if c.dtype == torch.int64 else c).contiguous()
                   for c in cols)
    return sc.compact_by_mask(mask.contiguous(), planes,
                              mask.numel() if n_out is None else n_out)
