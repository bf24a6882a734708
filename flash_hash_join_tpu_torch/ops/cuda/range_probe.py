"""K3 / K4: probe of the partitioned tier, count and materialize
(csrc/range_probe.cu).

Replaces flash_hash_join_tpu/ops/pallas/range_probe.py:range_probe_count
and :range_probe_materialize.  The table is the valid build keys as
sortable int64 (utils/u64.py:sortable), sorted ascending (stably, so the
first key of a run is the minimum build row with that key); value planes,
when given, are in the same order.  Probes are the int32 bit-pattern key
planes in input order; rows at or past np_valid never hit.

The TPU kernels' window, transposed table, boundaries and probe sort are
layout for Mosaic and are not ported (ops/range_table.py), so these never
report unresolved probes.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils.u64 import sortable


def _check(keys, planes: dict, np_valid: int) -> torch.device:
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")
    n = planes["ph"].numel()
    for name, p in planes.items():
        if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {p.dtype} of shape {tuple(p.shape)}")
        if p.device != keys.device:
            raise ValueError(f"{name} and keys must be on one device")
    if planes["pl"].numel() != n:
        raise ValueError("ph and pl must have equal length")
    if not 0 <= np_valid <= n:
        raise ValueError(f"np_valid must be in [0, {n}], got {np_valid}")
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def lookup(keys: torch.Tensor, x: torch.Tensor):
    """Plain search: (found, position of x's run, clamped into range) for
    sortable keys x in the sorted keys."""
    if keys.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool), torch.zeros_like(x)
    pos = torch.searchsorted(keys, x).clamp_(max=keys.numel() - 1)
    return keys[pos] == x, pos


def range_probe_count_plain(keys, ph, pl, np_valid: int) -> torch.Tensor:
    """Plain PyTorch version of K3: the count as a 0-d int64."""
    found, _ = lookup(keys, sortable(ph[:np_valid], pl[:np_valid]))
    return found.sum()


def range_probe_count(keys: torch.Tensor, ph: torch.Tensor, pl: torch.Tensor,
                      np_valid: int) -> torch.Tensor:
    """Count the probes (ph, pl)[:np_valid] whose key is in `keys`; a 0-d
    int64 tensor.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    dev = _check(keys, {"ph": ph, "pl": pl}, np_valid)
    if dev.type == "cpu":
        return range_probe_count_plain(keys, ph, pl, np_valid)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if keys.numel() == 0 or np_valid == 0:
        return count[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_range_probe_count(
        keys.data_ptr(), keys.numel(), ph.data_ptr(), pl.data_ptr(), np_valid,
        count.data_ptr(), stream)
    range_probe_count.launches += 1
    _build.check(err, "range_probe_count")
    return count[0]


range_probe_count.launches = 0


def range_probe_materialize_plain(keys, tvh, tvl, ph, pl, np_valid: int):
    """Plain PyTorch version of K4: (hit bool, vh, vl int32), one row per
    probe row."""
    found, pos = lookup(keys, sortable(ph, pl))
    hit = found & (torch.arange(ph.numel(), device=ph.device) < np_valid)
    if keys.numel() == 0:
        return hit, torch.zeros_like(ph), torch.zeros_like(pl)
    return hit, torch.where(hit, tvh[pos], 0), torch.where(hit, tvl[pos], 0)


def range_probe_materialize(keys: torch.Tensor, tvh: torch.Tensor,
                            tvl: torch.Tensor, ph: torch.Tensor,
                            pl: torch.Tensor, np_valid: int):
    """Per probe row: (hit, vh, vl) — a bool mask and the int32 value planes
    of the first table row with the probe's key (0 on a miss and at or past
    np_valid).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    dev = _check(keys, {"ph": ph, "pl": pl, "tvh": tvh, "tvl": tvl}, np_valid)
    if tvh.numel() != keys.numel() or tvl.numel() != keys.numel():
        raise ValueError("tvh and tvl must have one row per key")
    if dev.type == "cpu":
        return range_probe_materialize_plain(keys, tvh, tvl, ph, pl, np_valid)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_range_probe_materialize(
        keys.data_ptr(), keys.numel(), tvh.data_ptr(), tvl.data_ptr(),
        ph.data_ptr(), pl.data_ptr(), n, np_valid, hit.data_ptr(),
        vh.data_ptr(), vl.data_ptr(), stream)
    range_probe_materialize.launches += 1
    _build.check(err, "range_probe_materialize")
    return hit, vh, vl


range_probe_materialize.launches = 0
