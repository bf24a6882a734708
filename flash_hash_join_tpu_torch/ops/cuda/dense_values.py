"""K8 and K9: the staged band of the dense-domain materialize
(csrc/dense_values.cu).

K8 replaces flash_hash_join_tpu/ops/pallas/dense_values.py:
probe_gather_staged together with the probe-side domain mapping that the
JAX package's direct_join_materialize runs in front of it:
`probe_gather_staged` reads the u32 probe key planes and maps each row to
its domain slot in registers, so the card runs no int64 pass over the
probe rows.  Per row: the hit (the row is valid and in the domain and its
slot is occupied) and the value planes there, in probe order, 0 on a miss.
The TPU kernel takes block-sorted indices and a `sels`-row window per tile
row, passes the indices through as keys and counts the probes its window
misses as unresolved; the CUDA kernel reads the planes (<= 4 MB each,
resident in L2) at each row's slot: nothing unresolved, no keys
pass-through.  The TPU kernel's index form keeps its plain version,
`probe_gather_staged_plain`, held against it in the CPU tests.

K9 replaces dense_values.py:materialize_copy, the identity copy the JAX
package puts in front of the staged band's consumers as an XLA:TPU fusion
barrier.  K8 reads the key planes, so the port has no index array to copy:
K9 is on no path, and stays as the TPU kernel's only counterpart.

Planes: (v_rows, 128) int32 words, slot s at word s.  K8 takes presence
as the bitmap of the occupied slots, (v_rows // 32, 128) words, word w
holding slots 32w..32w+31, which it stages in shared memory; the index
form's plane 0 is the 0/1 presence plane.  Indices: 1-D int32 tensors of
u32 bit patterns, sentinel 0xFFFFFFFF (= -1); any index >= v_rows * 128
misses.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.bitmap_probe import (
    check_key_planes, check_lo, check_plane, gather_slots)
from flash_hash_join_tpu_torch.ops.domain_map import LANES, probe_domain_idx
from flash_hash_join_tpu_torch.utils.u64 import widen

MAX_V_ROWS = 8192                  # 2^20 slots, 4 MB per plane


def probe_gather_staged_plain(planes, idx: torch.Tensor, v_rows: int):
    """Plain PyTorch version of the TPU kernel's index form: per index, the
    hit (the presence plane, plane 0, is nonzero there) and each value
    plane (planes 1..) where it hits, 0 on a miss.  (hit bool,
    *values int32)."""
    presence, *vplanes = planes
    inside = widen(idx) < v_rows * LANES
    (present,) = gather_slots((presence,), idx, inside)
    hit = present != 0
    return (hit, *gather_slots(vplanes, idx, hit))


def presence_plane(bitmap: torch.Tensor) -> torch.Tensor:
    """The 0/1 presence plane, (32 * rows, 128) int32, of a (rows, 128)
    bitmap of occupied slots."""
    shifts = torch.arange(32, device=bitmap.device)
    bits = (widen(bitmap.reshape(-1, 1)) >> shifts) & 1
    return bits.to(torch.int32).view(-1, LANES)


def probe_gather_staged_domain_plain(bitmap, vplanes, ph, pl, np_valid: int,
                                     lo, v_rows: int):
    """Plain PyTorch version of K8's entry: the int64 probe mapping, then
    the index form's plain version on the bitmap's presence plane.
    (hit bool, *values int32)."""
    idx = probe_domain_idx(ph, pl, np_valid, lo, v_rows * LANES)
    return probe_gather_staged_plain((presence_plane(bitmap), *vplanes), idx,
                                     v_rows)


def probe_gather_staged(bitmap, vplanes, ph, pl, np_valid: int, lo,
                        v_rows: int):
    """Per probe row, straight from the key planes: (hit, *values).

    bitmap: the occupied slots, (v_rows // 32, 128); vplanes: 1 or 2 value
    planes, (v_rows, 128); all contiguous int32.  ph/pl: the probe key
    planes, rows [0, np_valid) valid.  lo: the domain base, a one-element
    int64 tensor on the planes' device (no host sync).  Row i hits when
    i < np_valid, its high word is 0, its slot s = (pl[i] - lo) mod 2^32 is
    below v_rows * 128 and s is occupied; hit is a bool mask shaped like
    ph, and each value output the plane's word at s where it hits, 0
    elsewhere.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    vplanes = tuple(vplanes)
    if not 1 <= len(vplanes) <= 2:
        raise ValueError(f"1 or 2 value planes, got {len(vplanes)}")
    if not 256 <= v_rows <= MAX_V_ROWS or v_rows % 32:
        raise ValueError(f"v_rows must be a multiple of 32 in [256, "
                         f"{MAX_V_ROWS}], got {v_rows}")
    dev = ph.device
    check_key_planes(ph, pl, np_valid, "probe", dev)
    check_plane(bitmap, v_rows // 32, "bitmap", dev)
    for i, p in enumerate(vplanes):
        check_plane(p, v_rows, f"vplanes[{i}]", dev)
    check_lo(lo, dev)
    if dev.type == "cpu":
        return probe_gather_staged_domain_plain(bitmap, vplanes, ph, pl,
                                                np_valid, lo, v_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in vplanes)
    if n == 0:
        return (hit, *outs)
    out_ptrs = [o.data_ptr() for o in outs] + [None]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_staged_domain_gather(
        bitmap.data_ptr(), vplanes[0].data_ptr(),
        vplanes[1].data_ptr() if len(vplanes) > 1 else None, v_rows,
        ph.data_ptr(), pl.data_ptr(), n, np_valid, lo.data_ptr(),
        hit.data_ptr(), out_ptrs[0], out_ptrs[1], stream)
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
