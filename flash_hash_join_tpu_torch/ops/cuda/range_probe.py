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
key planes; rows at or past np_valid never hit.

K3 reads the probes in input order.  K4 takes the route `plan` picks by
shape: 0 levels, one kernel over the probes in input order, where the
table it reads is at most four times L2 or too few probes share it; else
passes of at most PASS_ROWS valid rows, each partitioned by the top bits
of the probe's directory bucket (the partition of the `global` walk,
csrc/partition.cuh) into slices of at most SLICE_BYTES of the table,
probed slice by slice so that each slice comes from device memory once,
and the answers put back in probe order: both routes give the same (hit,
vh, vl) in probe order, which compaction and the join's contract need.
The CPU takes the plain version of the route the plan picks
(range_probe_sliced_plain at 1 level).

The TPU kernels' window, transposed table, full probe sort and tile
padding are layout for Mosaic and are not ported (ops/range_table.py), so
these never report unresolved probes.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda.hash_walk import (
    CHUNK_ROWS, L2_BYTES, MAX_PBITS, PASS_ROWS, SLICE_BYTES)
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import sortable

# Tables of at most this many keys (2 KB, in L1) have no directory: a
# search of all of them beat the directory at 100 keys, the directory won
# from 300 keys on (PERF.md, chip_smoke.py's layout timings).
SMALL_TABLE = 256
MAX_DIR_BITS = 23        # 2^23 + 1 int32 offsets: 32 MB
# K4's plan: the 1-level route where the table K4 reads is more than
# MIN_TABLE_L2 times L2 and at least MIN_PROBES valid probe rows share it.
# From chip_smoke.py's sweep on an H100 (PERF.md §6), on J1's dense keys
# (half the probes hits) and on uniform u64 keys (a tenth): the 0-level K4
# won on every table at 2^18 to 2^22 probes (the 1-level route at best tied)
# and on tables of 17 to 68 MiB at every probe side; on 136 MiB it won on
# u64 keys at every side (by 22-35 %) and on J1 keys up to 2^24 probes, lost
# by 4.5 % at 1e8; the 1-level route won on tables of 272 MiB to 1.5 GiB
# from 2^23 probes on (by 1-39 %).  The slices, passes and partition blocks
# are the walk's (ops/cuda/hash_walk.py).
MIN_TABLE_L2 = 4
MIN_PROBES = 2**23
SLICED_SCRATCH_BYTES = 15   # a row of a pass: record, stage maps, hit flag
_forced: dict = {}


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


class Plan(NamedTuple):
    """K4's route: the digit bits of the one partition level (0: K4 over
    the probe planes in input order), the valid rows a pass, and the
    partition's blocks."""
    pbits: int
    pass_rows: int
    blocks: int


def table_bytes(table) -> int:
    """Bytes of the table K4 reads: a key and its (vh, vl) pair, 16 B a
    row, and the directory's offsets."""
    d = table.dir
    return 16 * table.keys.numel() + (0 if d is None
                                      else d.numel() * d.element_size())


def built_table_bytes(nb: int) -> int:
    """table_bytes of the table ops/range_table.build_range_table makes of
    nb keys: its directory has directory_bits(nb) bits, of dir_dtype(nb)."""
    p = directory_bits(nb)
    return 16 * nb + (((1 << p) + 1) * dir_dtype(nb).itemsize if p else 0)


def table_dir_bits(table) -> int:
    """p of the table's directory: 0 where it has none or fewer than 4
    keys, which the kernels search whole."""
    if table.dir is None or table.keys.numel() < 4:
        return 0
    return (table.dir.numel() - 1).bit_length() - 1


def slice_bits(nbytes: int, p: int) -> int:
    """The fewest digit bits, at least 1 and at most MAX_PBITS and p, that
    cut nbytes of table into slices of at most SLICE_BYTES."""
    return min(MAX_PBITS, p, max(1, math.ceil(math.log2(nbytes /
                                                        SLICE_BYTES))))


def plan(np_valid: int, nbytes: int, p: int, *, l2_bytes: int = L2_BYTES,
         sms: int = 132, pbits: int | None = None,
         pass_rows: int | None = None) -> Plan:
    """K4's plan for np_valid valid probe rows on a table of nbytes (as
    table_bytes counts them) with a directory of 2^p buckets (p = 0: none),
    on a card with `l2_bytes` of L2 and `sms` multiprocessors: 0 levels
    where the table is at most MIN_TABLE_L2 times L2, or where fewer than
    MIN_PROBES probe rows would share it; else one level of slice_bits.
    pbits and pass_rows, when given, replace the plan's own (pbits still at
    most p); a table with no directory and an empty probe side take 0
    levels."""
    if pbits is None:
        pbits = slice_bits(nbytes, p) if (
            p and nbytes > MIN_TABLE_L2 * l2_bytes
            and np_valid >= MIN_PROBES) else 0
    pbits = 0 if np_valid <= 0 else min(pbits, p)
    rows = max(1, min(PASS_ROWS if pass_rows is None else pass_rows,
                      np_valid))
    blocks = max(1, min(-(-rows // CHUNK_ROWS), 4 * sms))
    return Plan(pbits, rows, blocks)


@contextlib.contextmanager
def forced(**overrides):
    """Within the block, K4's wrapper plans with these overrides of `plan`
    (pbits, pass_rows): how the tests and chip_smoke.py hold both routes and
    the pass loop to each other at any size."""
    global _forced
    before = _forced
    _forced = dict(before, **overrides)
    try:
        yield
    finally:
        _forced = before


def _plan(table, np_valid: int, dev: torch.device) -> Plan:
    """K4's plan for this table and probe side on dev (the defaults of
    `plan` for the CPU), with any forced overrides."""
    l2, sms = L2_BYTES, 132
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        l2 = getattr(props, "L2_cache_size", L2_BYTES)
        sms = props.multi_processor_count
    return plan(np_valid, table_bytes(table), table_dir_bits(table),
                l2_bytes=l2, sms=sms, **_forced)


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
    with spans.span(spans.K_RANGE_DIRECTORY):
        err = _build.lib().fhj_range_directory(
            keys.data_ptr(), nb, p, dir_.data_ptr(), dir_.element_size(),
            shift.data_ptr(), stream)
    _build.check(err, "range_directory")
    return dir_, shift


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
    with spans.span(spans.K_RANGE_PROBE_COUNT):
        err = _build.lib().fhj_range_probe_count(
            *_table_ptrs(table), ph.data_ptr(), pl.data_ptr(), np_valid,
            count.data_ptr(), stream)
    _build.check(err, "range_probe_count")
    return count[0]


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


def range_probe_sliced_plain(table, ph, pl, np_valid: int, p: Plan):
    """Plain PyTorch version of K4's 1-level route under plan p: for each
    pass, its rows inside [keys[0], keys[-1]] ordered by their digit (the
    top p.pbits bits of the directory bucket) with a stable argsort, looked
    up in that order, and the answers put back in probe order by the
    inverse permutation; every other row, and the rows at or past np_valid,
    get (False, 0, 0).  The same outputs as range_probe_materialize_plain."""
    n = ph.numel()
    hit = torch.zeros(n, dtype=torch.bool, device=ph.device)
    vh, vl = torch.zeros_like(ph), torch.zeros_like(pl)
    keys, nb = table.keys, table.keys.numel()
    below = table_dir_bits(table) - p.pbits
    for p0 in range(0, np_valid, p.pass_rows):
        x = sortable(ph[p0:p0 + p.pass_rows], pl[p0:p0 + p.pass_rows])
        x = x[:np_valid - p0]
        rows = torch.nonzero((x >= keys[0]) & (x <= keys[-1])).squeeze(1)
        bucket = _shift_right(*_offset_halves(x[rows], keys[0]), table.shift)
        perm = torch.argsort(bucket >> below, stable=True)
        found, pos = lookup(table, x[rows[perm]])
        order = p0 + rows[perm]
        v = table.values[pos.clamp(max=nb - 1)]
        hit[order] = found
        vh[order] = torch.where(found, v[:, 0], 0)
        vl[order] = torch.where(found, v[:, 1], 0)
    return hit, vh, vl


def range_probe_materialize(table, ph: torch.Tensor, pl: torch.Tensor,
                            np_valid: int):
    """Per probe row: (hit, vh, vl) — a bool mask and the int32 value planes
    of the first table row with the probe's key (0 on a miss and at or past
    np_valid), in probe order, by the route `plan` picks.  CPU tensors take
    the plain version of that route; CUDA tensors launch K4 (0 levels) or
    the partition, slice probe and restore of each pass (1 level)."""
    dev = _check(table, {"ph": ph, "pl": pl}, np_valid)
    values = table.values
    if (values is None or values.dtype != torch.int32
            or values.shape != (table.keys.numel(), 2)
            or not values.is_contiguous() or values.device != dev):
        raise ValueError("table.values must be a contiguous (nb, 2) int32 "
                         "tensor beside keys")
    p = _plan(table, np_valid, dev)
    if dev.type == "cpu":
        if p.pbits:
            return range_probe_sliced_plain(table, ph, pl, np_valid, p)
        return range_probe_materialize_plain(table, ph, pl, np_valid)
    n = ph.numel()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    vh = torch.empty(n, dtype=torch.int32, device=dev)
    vl = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, vh, vl
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = (ph.data_ptr(), pl.data_ptr(), n, np_valid, hit.data_ptr(),
            vh.data_ptr(), vl.data_ptr(), stream)
    if p.pbits:
        _materialize_sliced(table, p, outs)
        return hit, vh, vl
    with spans.span(spans.K_RANGE_PROBE_MATERIALIZE):
        err = _build.lib().fhj_range_probe_materialize(
            *_table_ptrs(table), values.data_ptr(), *outs)
    _build.check(err, "range_probe_materialize")
    return hit, vh, vl


def _materialize_sliced(table, p: Plan, outs: tuple) -> None:
    """K4's 1-level route on the card under plan p: its scratch, then one
    launch (in the span fhj.k.range_probe_sliced) of each pass's partition,
    slice probe and restore.  outs: the probe planes and outputs as
    fhj_range_probe_materialize takes them, the stream last."""
    lib = _build.lib()
    keys, nb, dir_, dir_bytes, shift = _table_ptrs(table)
    dbits = table_dir_bits(table)
    nbytes = lib.fhj_range_probe_sliced_scratch_bytes(dbits, *p)
    if nbytes < 0:
        raise ValueError(f"the sliced probe does not take the plan {p}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=table.keys.device)
    with spans.span(spans.K_RANGE_PROBE_SLICED):
        err = lib.fhj_range_probe_sliced(
            keys, nb, dir_, dir_bytes, shift, dbits, table.values.data_ptr(),
            *outs[:-1], *p, scratch.data_ptr(), nbytes, outs[-1])
    _build.check(err, "range_probe_sliced")
