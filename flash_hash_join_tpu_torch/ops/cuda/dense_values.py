"""K8 and K9: the staged band of the dense-domain materialize
(csrc/dense_values.cu).

K8 replaces flash_hash_join_tpu/ops/pallas/dense_values.py:
probe_gather_staged: per probe domain index, the hit (the presence plane is
nonzero at its slot) and the value planes there.  The TPU kernel takes
block-sorted indices and a `sels`-row window per tile row, passes the
indices through as keys and counts the probes its window misses as
unresolved.  The CUDA kernel takes UNSORTED indices and reads the planes
(<= 4 MB each, resident in L2) at each probe's slot: output in probe order,
nothing unresolved, no keys pass-through.

K9 replaces dense_values.py:materialize_copy, the identity copy the JAX
package puts in front of the staged band's consumers as an XLA:TPU fusion
barrier.  PyTorch fuses nothing, so the copy changes no result; the staged
band keeps it where the JAX package has it (ops/direct_bitmap.py).

Planes: (v_rows, 128) int32 words, slot s at word s (plane 0 of K8 is the
0/1 presence).  Indices: 1-D int32 tensors of u32 bit patterns, sentinel
0xFFFFFFFF (= -1); any index >= v_rows * 128 misses.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.bitmap_probe import (
    LANES, check_idx, check_plane, gather_slots)
from flash_hash_join_tpu_torch.utils.u64 import widen

MAX_V_ROWS = 8192                  # 2^20 slots, 4 MB per plane


def probe_gather_staged_plain(planes, idx: torch.Tensor, v_rows: int):
    """Plain PyTorch version of K8: (hit bool, *values int32)."""
    presence, *vplanes = planes
    inside = widen(idx) < v_rows * LANES
    (present,) = gather_slots((presence,), idx, inside)
    hit = present != 0
    return (hit, *gather_slots(vplanes, idx, hit))


def probe_gather_staged(planes, idx: torch.Tensor, v_rows: int):
    """Per index: (hit, *values) — a bool mask of the indices whose
    presence word (plane 0) is nonzero, and each of the 1 or 2 value planes
    (planes 1..) at the index where it hits (0 on a miss), as int32 tensors
    shaped like idx.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    planes = tuple(planes)
    check_idx(idx, "idx")
    dev = idx.device
    if not 2 <= len(planes) <= 3:
        raise ValueError(f"presence plus 1 or 2 value planes, got "
                         f"{len(planes)} planes")
    if not 1 <= v_rows <= MAX_V_ROWS:
        raise ValueError(f"v_rows must be in [1, {MAX_V_ROWS}], got {v_rows}")
    for i, p in enumerate(planes):
        check_plane(p, v_rows, f"planes[{i}]", dev)
    if dev.type == "cpu":
        return probe_gather_staged_plain(planes, idx, v_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = idx.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in planes[1:])
    if n == 0:
        return (hit, *outs)
    ptrs = [p.data_ptr() for p in planes] + [None]
    out_ptrs = [o.data_ptr() for o in outs] + [None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_staged_gather(
        ptrs[0], ptrs[1], ptrs[2], v_rows, idx.data_ptr(), n, hit.data_ptr(),
        out_ptrs[0], out_ptrs[1], stream)
    probe_gather_staged.launches += 1
    _build.check(err, "probe_gather_staged")
    return (hit, *outs)


probe_gather_staged.launches = 0


def materialize_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9."""
    return x.clone()


def materialize_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of the contiguous int32 tensor x, in new memory.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous int32 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    dev = x.device
    if dev.type == "cpu":
        return materialize_copy_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_materialize_copy(x.data_ptr(), out.data_ptr(),
                                            x.numel(), stream)
    materialize_copy.launches += 1
    _build.check(err, "materialize_copy")
    return out


materialize_copy.launches = 0
