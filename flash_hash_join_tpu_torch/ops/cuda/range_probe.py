"""K3 / K4: probe of the partitioned tier, count and materialize
(csrc/range_probe.cu), and the bucket directory they search through.

Replaces flash_hash_join_tpu/ops/pallas/range_probe.py:range_probe_count
and :range_probe_materialize.  The table (ops/range_table.py:RangeTable) is
  keys     the valid build keys as sortable int64 (utils/u64.py:sortable),
           sorted ascending, stably, so the first key of a run is the
           minimum build row with that key;
  values   their (vh, vl) value planes in the same order, interleaved as
           one (nb, 2) int32 tensor (materialize only);
  dir      above SMALL_TABLE keys, the bucket directory: 2^p + 1 offsets
           into keys (int32, int64 from 2^31 keys on), bucket b holding the
           keys whose (u64)(key - keys[0]) >> shift is b, and dir[b] the
           first index at or past bucket b; None for a smaller table, which
           is searched whole;
  shift    that shift, a 0-d int64 tensor (None with no directory).
The directory is the Hopper form of the TPU kernel's first search level
(its column boundaries, range_probe.py:_search); the second level searches
the bucket's few keys (the kernels first read the sector an interpolation
guess points at, csrc/range_probe.cu).  Probes are the int32 bit-pattern
key planes in input order; rows at or past np_valid never hit.

The TPU kernels' window, transposed table, probe sort and tile padding are
layout for Mosaic and are not ported (ops/range_table.py), so these never
report unresolved probes.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.utils.u64 import sortable

# Tables of at most this many keys (2 KB, in L1) have no directory: a
# search of all of them beat the directory at 100 keys, the directory won
# from 300 keys on (PERF.md, chip_smoke.py's layout timings).
SMALL_TABLE = 256
MAX_DIR_BITS = 23        # 2^23 + 1 int32 offsets: 32 MB


def directory_bits(nb: int) -> int:
    """p for a table of nb keys: 0 (no directory) up to SMALL_TABLE keys,
    else ceil(log2 nb) - 2 up to MAX_DIR_BITS, about 4-8 keys a bucket on
    uniform keys."""
    if nb <= SMALL_TABLE:
        return 0
    return min((nb - 1).bit_length() - 2, MAX_DIR_BITS)


def dir_dtype(nb: int) -> torch.dtype:
    """The directory's offsets, and so K3/K4's positions: 32-bit below 2^31
    keys."""
    return torch.int32 if nb < 2**31 else torch.int64


def _offset_halves(x: torch.Tensor, lo: torch.Tensor):
    """((u64)(x - lo) >> 1, (x - lo) & 1) for sortable keys x >= lo, with
    no int64 overflow: the first from the halves of x and lo."""
    half = (x >> 1) - (lo >> 1) - ((x & 1) < (lo & 1)).to(torch.int64)
    return half, (x ^ lo) & 1


def _shift_right(half, odd, shift):
    """(u64)(x - lo) >> shift from _offset_halves, for 0 <= shift < 64 (an
    int or a 0-d tensor); with shift 0 the offset must be below 2^62."""
    zero = (shift == 0)
    zero = zero.to(torch.int64) if isinstance(zero, torch.Tensor) else int(zero)
    return ((half >> (shift - 1 + zero)) << zero) + (odd & zero)


def range_directory_plain(keys: torch.Tensor, p: int, dtype=None):
    """Plain PyTorch version of the directory build, with no host sync: the
    bucket start keys, then one torch.searchsorted."""
    nb, dev = keys.numel(), keys.device
    lo, hi = keys[0], keys[-1]
    half, odd = _offset_halves(hi, lo)
    # span >> s >= 2^p exactly when s < bit_length(span) - p
    shift = ((half >> torch.arange(63, device=dev)) >= 2**(p - 1)).sum()
    b = torch.arange(2**p + 1, device=dev)
    last = _shift_right(half, odd, shift)          # the last key's bucket
    # start of bucket min(b, last): lo + (b << shift) in halves, so that no
    # step passes hi
    zero = (shift == 0).to(torch.int64)
    bb = torch.minimum(b, last)
    step = (bb << (shift - 1 + zero)) >> zero
    starts = (lo + step) + step + (bb & zero)
    dir_ = torch.where(b <= last, torch.searchsorted(keys, starts), nb)
    return dir_.to(dtype or dir_dtype(nb)), shift


def range_directory(keys: torch.Tensor, p: int, dtype=None):
    """The bucket directory of nb >= 1 sorted sortable keys, with 2^p
    buckets (1 <= p <= 30): (dir, shift), dir the 2^p + 1 offsets (of
    `dtype`, by default dir_dtype(nb)) and shift a 0-d int64 tensor,
    max(0, bit_length(span) - p).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (one thread a bucket)."""
    nb = keys.numel()
    if nb == 0 or not 1 <= p <= 30:
        raise ValueError("a directory needs keys and 1 <= p <= 30")
    if (keys.dtype != torch.int64 or keys.dim() != 1
            or not keys.is_contiguous()):
        raise ValueError("keys must be a contiguous 1-D int64 tensor")
    dtype = dtype or dir_dtype(nb)
    if dtype not in (torch.int32, torch.int64) or (
            dtype.itemsize < dir_dtype(nb).itemsize):
        raise ValueError(f"no directory of {dtype} for {nb} keys")
    if keys.device.type == "cpu":
        return range_directory_plain(keys, p, dtype)
    dir_ = torch.empty(2**p + 1, dtype=dtype, device=keys.device)
    shift = torch.empty((), dtype=torch.int64, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _build.lib().fhj_range_directory(
        keys.data_ptr(), nb, p, dir_.data_ptr(), dir_.element_size(),
        shift.data_ptr(), stream)
    range_directory.launches += 1
    _build.check(err, "range_directory")
    return dir_, shift


range_directory.launches = 0


def _check(table, planes: dict, np_valid: int) -> torch.device:
    keys = table.keys
    if keys.dtype != torch.int64 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor, got "
                         f"{keys.dtype} of shape {tuple(keys.shape)}")
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if table.dir is not None:
        d, s = table.dir, table.shift
        if (d.dtype not in (torch.int32, torch.int64) or d.dim() != 1
                or d.numel() < 3 or (d.numel() - 1) & (d.numel() - 2)
                or not d.is_contiguous()
                or d.dtype.itemsize < dir_dtype(keys.numel()).itemsize
                or s is None or s.dtype != torch.int64 or s.dim() != 0):
            raise ValueError("dir must be a contiguous 1-D int32 or int64 "
                             "tensor of 2^p + 1 offsets (int64 from 2^31 "
                             "keys on) and shift a 0-d int64 tensor")
        if d.device != dev or s.device != dev:
            raise ValueError("table.dir, table.shift and keys must be on one "
                             "device")
    n = planes["ph"].numel()
    for name, p in planes.items():
        if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, "
                             f"got {p.dtype} of shape {tuple(p.shape)}")
        if p.device != dev:
            raise ValueError(f"{name} and keys must be on one device")
    if planes["pl"].numel() != n:
        raise ValueError("ph and pl must have equal length")
    if not 0 <= np_valid <= n:
        raise ValueError(f"np_valid must be in [0, {n}], got {np_valid}")
    return dev


def _table_ptrs(table) -> tuple:
    """keys, nb, dir, dir_bytes, shift as the kernels' first arguments."""
    d, nb = table.dir, table.keys.numel()
    if d is None:
        return (table.keys.data_ptr(), nb, None,
                dir_dtype(nb).itemsize, None)
    return (table.keys.data_ptr(), nb, d.data_ptr(), d.element_size(),
            table.shift.data_ptr())


def lookup(table, x: torch.Tensor):
    """Plain search: (found, position of x's run) for sortable keys x; the
    position is only meaningful where found.  With a directory, gathers
    dir[b] and dir[b + 1]; then the lower bound over the candidates in
    bit_length(largest bucket, or nb) torch.where halving steps."""
    keys = table.keys
    nb = keys.numel()
    if nb == 0:
        return torch.zeros_like(x, dtype=torch.bool), torch.zeros_like(x)
    lo = keys[0]
    inside = (x >= lo) & (x <= keys[-1])
    if table.dir is None:
        base = torch.zeros_like(x)
        end = torch.where(inside, nb, 0)
        steps = nb.bit_length()
    else:
        b = _shift_right(*_offset_halves(torch.where(inside, x, lo), lo),
                         int(table.shift))
        dir_ = table.dir.to(torch.int64)
        base = torch.where(inside, dir_[b], 0)
        end = torch.where(inside, dir_[b + 1], 0)
        steps = int((dir_[1:] - dir_[:-1]).max()).bit_length()
    n = end - base + 1                       # candidate positions [base, end]
    for _ in range(steps):
        half = n >> 1
        past = keys[(base + half - 1).clamp_(min=0)] < x
        base = torch.where(past, base + half, base)
        n = n - half
    found = (base < end) & (keys[base.clamp(max=nb - 1)] == x)
    return found, base


def range_probe_count_plain(table, ph, pl, np_valid: int) -> torch.Tensor:
    """Plain PyTorch version of K3: the count as a 0-d int64."""
    found, _ = lookup(table, sortable(ph[:np_valid], pl[:np_valid]))
    return found.sum()


def range_probe_count(table, ph: torch.Tensor, pl: torch.Tensor,
                      np_valid: int) -> torch.Tensor:
    """Count the probes (ph, pl)[:np_valid] whose key is in table.keys; a
    0-d int64 tensor.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    dev = _check(table, {"ph": ph, "pl": pl}, np_valid)
    if dev.type == "cpu":
        return range_probe_count_plain(table, ph, pl, np_valid)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    if table.keys.numel() == 0 or np_valid == 0:
        return count[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_range_probe_count(
        *_table_ptrs(table), ph.data_ptr(), pl.data_ptr(), np_valid,
        count.data_ptr(), stream)
    range_probe_count.launches += 1
    _build.check(err, "range_probe_count")
    return count[0]


range_probe_count.launches = 0


def range_probe_materialize_plain(table, ph, pl, np_valid: int):
    """Plain PyTorch version of K4: (hit bool, vh, vl int32), one row per
    probe row."""
    found, pos = lookup(table, sortable(ph, pl))
    hit = found & (torch.arange(ph.numel(), device=ph.device) < np_valid)
    nb = table.keys.numel()
    if nb == 0:
        return hit, torch.zeros_like(ph), torch.zeros_like(pl)
    v = table.values[pos.clamp(max=nb - 1)]
    return hit, torch.where(hit, v[:, 0], 0), torch.where(hit, v[:, 1], 0)


def range_probe_materialize(table, ph: torch.Tensor, pl: torch.Tensor,
                            np_valid: int):
    """Per probe row: (hit, vh, vl) — a bool mask and the int32 value planes
    of the first table row with the probe's key (0 on a miss and at or past
    np_valid).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    dev = _check(table, {"ph": ph, "pl": pl}, np_valid)
    values = table.values
    if (values is None or values.dtype != torch.int32
            or values.shape != (table.keys.numel(), 2)
            or not values.is_contiguous() or values.device != dev):
        raise ValueError("table.values must be a contiguous (nb, 2) int32 "
                         "tensor beside keys")
    if dev.type == "cpu":
        return range_probe_materialize_plain(table, ph, pl, np_valid)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _build.lib().fhj_range_probe_materialize(
        *_table_ptrs(table), values.data_ptr(), ph.data_ptr(), pl.data_ptr(),
        n, np_valid, hit.data_ptr(), vh.data_ptr(), vl.data_ptr(), stream)
    range_probe_materialize.launches += 1
    _build.check(err, "range_probe_materialize")
    return hit, vh, vl


range_probe_materialize.launches = 0
