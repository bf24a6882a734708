"""K2 and K7: probes of a small bitmap (csrc/bitmap_probe.cu).

K2 replaces flash_hash_join_tpu/ops/pallas/bitmap_probe.py:
probe_count_bitmap together with the mapping and the bitmap pack that the
JAX package's direct_join_count runs around it: `scan_domain_count`, the
scan band of the dense-domain count (d_rows <= 256, spans <= 2^20), reads
the u32 key planes of both sides, so the card runs no int64 pass over the
rows.  K7 replaces probe_gather_bitmap together with the probe-side
mapping in front of it: `probe_gather_bitmap`, the scan band of the
dense-domain materialize (v_rows <= 128), reads the u32 probe key planes
and the domain base from device memory and writes the hit flag plus the
dense value planes at each probe row's slot.  The TPU kernels scan every
bitmap (and value) row per tile; the CUDA kernels stage the bitmap (and
the planes) in shared memory and read each row's word directly.  The TPU
kernels' index forms keep their plain versions, `probe_count_bitmap_plain`
and `probe_gather_bitmap_plain`, held against them in the CPU tests.

Bitmap: (d_rows, 128) int32 words, word w = idx >> 5 holds bit idx & 31.
Value planes: (v_rows, 128) int32 words, slot s at word s.
Indices (the index forms): 1-D int32 tensor of u32 bit patterns, sentinel
0xFFFFFFFF (= -1); any index >= d_rows * 4096 counts nothing, any index
>= v_rows * 128 reads value 0.

The plain versions of the key-plane entries map the key planes to those
indices with the int64 mapping of ops/domain_map.py.
"""

from __future__ import annotations

import torch

from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.domain_map import (
    BITS_PER_ROW, LANES, build_domain_idx, masked_min, pack_bitmap,
    probe_domain_idx)
from flash_hash_join_tpu_torch.utils import spans
from flash_hash_join_tpu_torch.utils.u64 import widen

MAX_D_ROWS = 256                   # 2^20-slot domain cap (128 KB of shared memory)
# K7's planes: 2 x 64 KB of shared memory at 128 rows; its bitmap has the
# TPU kernel's least rung of rows, which covers 2^15 slots
MAX_V_ROWS = 128
GATHER_D_ROWS = 8


def check_idx(idx: torch.Tensor, name: str) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got "
                         f"{idx.dtype} of shape {tuple(idx.shape)}")


def check_key_planes(hi, lo, n_valid: int, side: str, dev) -> None:
    """The (hi, lo) key planes of one side of a domain entry: contiguous 1-D
    int32 of one length on `dev`, with n_valid rows inside them."""
    check_idx(hi, f"{side} hi plane")
    check_idx(lo, f"{side} lo plane")
    if hi.shape != lo.shape:
        raise ValueError(f"the two {side} planes must have one length")
    if not 0 <= n_valid <= hi.numel():
        raise ValueError(f"{side}: {n_valid} valid rows outside its "
                         f"{hi.numel()}-row planes")
    if hi.device != dev or lo.device != dev:
        raise ValueError("the key planes must be on one device")


def check_plane(plane: torch.Tensor, rows: int, name: str,
                dev: torch.device) -> None:
    """A (rows, 128) contiguous int32 tensor on dev, 16-byte aligned on a
    card (the kernels read it with 16-byte loads)."""
    if (plane.dtype != torch.int32 or tuple(plane.shape) != (rows, LANES)
            or not plane.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({rows}, {LANES}) "
                         f"int32 tensor, got {plane.dtype} "
                         f"{tuple(plane.shape)}")
    if plane.device != dev:
        raise ValueError(f"{name} must be on the probes' device")
    if dev.type == "cuda" and plane.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_lo(lo: torch.Tensor, dev: torch.device) -> None:
    """The domain base of a key-plane gather entry (K7, K8): a one-element
    int64 tensor on the planes' device, read by the kernel (no host
    sync)."""
    if lo.dtype != torch.int64 or lo.numel() != 1 or lo.device != dev:
        raise ValueError("lo must be a one-element int64 tensor on the "
                         "planes' device")


def gather_slots(planes, idx: torch.Tensor, take: torch.Tensor):
    """Plain gather: each plane's word at every index where `take` holds, 0
    elsewhere (the value half of K7's and K8's plain versions)."""
    pos = torch.where(take, widen(idx), 0)
    return tuple(torch.where(take, p.reshape(-1)[pos], 0) for p in planes)


def member(bitmap: torch.Tensor, idx: torch.Tensor, d_rows: int) -> torch.Tensor:
    """Plain bit test: bool mask of the indices whose bit is set."""
    n_bits = d_rows * BITS_PER_ROW
    v = widen(idx)
    ok = v < n_bits
    words = widen(bitmap.reshape(-1))[torch.where(ok, v >> 5, 0)]
    return ok & (((words >> (v & 31)) & 1) == 1)


def probe_count_bitmap_plain(bitmap: torch.Tensor, idx: torch.Tensor,
                             d_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's index form: the count of
    the indices whose bit is set, as a 0-d int64."""
    return member(bitmap, idx, d_rows).sum()


def scan_domain_count_plain(kh, kl, ph, pl, nb_valid: int, np_valid: int,
                            d_rows: int):
    """Plain PyTorch version of K2's entry: the int64 mapping, the bitmap
    pack, then the index form's plain version.  Returns (count, n_bad),
    0-d int64."""
    d_bits = d_rows * BITS_PER_ROW
    bvalid = torch.arange(kh.shape[0], device=kh.device) < nb_valid
    # the scan band's lo is the min over EVERY valid row, hi-word rows too
    lo = masked_min(widen(kl), bvalid)
    n_bad, bidx = build_domain_idx(kh, kl, bvalid, lo, d_bits)
    bitmap = pack_bitmap(bidx, d_rows)
    pidx = probe_domain_idx(ph, pl, np_valid, lo, d_bits)
    return probe_count_bitmap_plain(bitmap, pidx, d_rows), n_bad


def scan_domain_count(kh, kl, ph, pl, nb_valid: int, np_valid: int,
                      d_rows: int):
    """The scan band's dense-domain count straight from the key planes.

    kh/kl, ph/pl: the u32 (hi, lo) planes of the build and probe keys as
    1-D int32 tensors, rows [0, nb_valid) and [0, np_valid) valid.  lo is
    the least low word of EVERY valid build row, high-word rows included
    (0xFFFFFFFF when there is none); a valid build row outside the
    d_rows * 4096 slots from lo (high word != 0, or (kl - lo) mod 2^32 past
    the domain) is bad, every other one sets its bit; the count is the
    number of valid probe rows in the domain whose bit is set.

    Returns (count, n_bad), 0-d int64 tensors on the planes' device, with
    no host sync.  CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    if not 8 <= d_rows <= MAX_D_ROWS:
        raise ValueError(f"d_rows must be in [8, {MAX_D_ROWS}], got {d_rows}")
    dev = kh.device
    check_key_planes(kh, kl, nb_valid, "build", dev)
    check_key_planes(ph, pl, np_valid, "probe", dev)
    if dev.type == "cpu":
        return scan_domain_count_plain(kh, kl, ph, pl, nb_valid, np_valid,
                                       d_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bitmap = torch.empty((d_rows, LANES), dtype=torch.int32, device=dev)
    scratch = torch.empty(3, dtype=torch.int64, device=dev)  # count, n_bad, lo
    stream = torch.cuda.current_stream(dev).cuda_stream
    # no kernel runs on an empty build side: memsets only
    with spans.span(spans.K_SCAN_DOMAIN_COUNT) if nb_valid > 0 \
            else spans.NONE:
        err = _build.lib().fhj_scan_domain_count(
            kh.data_ptr(), kl.data_ptr(), nb_valid, ph.data_ptr(),
            pl.data_ptr(), np_valid, bitmap.data_ptr(), d_rows,
            scratch.data_ptr(), stream)
    _build.check(err, "scan_domain_count")
    return scratch[0], scratch[1]


def probe_gather_bitmap_plain(bitmap: torch.Tensor, vplanes, idx: torch.Tensor,
                              d_rows: int, v_rows: int):
    """Plain PyTorch version of the TPU kernel's index form: per index, the
    hit (its bit is set) and each value plane's word there (0 at or past
    v_rows * 128).  (hit bool, *values int32)."""
    inside = widen(idx) < v_rows * LANES
    return (member(bitmap, idx, d_rows), *gather_slots(vplanes, idx, inside))


def probe_gather_bitmap_domain_plain(bitmap, vplanes, ph, pl, np_valid: int,
                                     lo, v_rows: int):
    """Plain PyTorch version of K7's entry: the int64 probe mapping, then
    the index form's plain version.  (hit bool, *values int32)."""
    idx = probe_domain_idx(ph, pl, np_valid, lo, v_rows * LANES)
    return probe_gather_bitmap_plain(bitmap, vplanes, idx, GATHER_D_ROWS,
                                     v_rows)


def probe_gather_bitmap(bitmap, vplanes, ph, pl, np_valid: int, lo,
                        v_rows: int):
    """Per probe row, straight from the key planes: (hit, *values).

    bitmap: the occupied slots, (8, 128) words (slot s at bit s & 31 of
    word s >> 5); vplanes: 1 or 2 value planes, (v_rows, 128), v_rows in
    [8, 128]; all contiguous int32.  ph/pl: the probe key planes, rows
    [0, np_valid) valid.  lo: the domain base, a one-element int64 tensor
    on the planes' device (no host sync).  Row i is inside when
    i < np_valid, its high word is 0 and its slot s = (pl[i] - lo) mod 2^32
    is below v_rows * 128; it hits when it is inside and s is occupied.
    hit is a bool mask shaped like ph, and each value output the plane's
    word at s where the row is inside, 0 elsewhere.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    vplanes = tuple(vplanes)
    if not 1 <= len(vplanes) <= 2:
        raise ValueError(f"1 or 2 value planes, got {len(vplanes)}")
    if not 8 <= v_rows <= MAX_V_ROWS:
        raise ValueError(f"v_rows must be in [8, {MAX_V_ROWS}], got {v_rows}")
    dev = ph.device
    check_key_planes(ph, pl, np_valid, "probe", dev)
    check_plane(bitmap, GATHER_D_ROWS, "bitmap", dev)
    for i, p in enumerate(vplanes):
        check_plane(p, v_rows, f"vplanes[{i}]", dev)
    check_lo(lo, dev)
    if dev.type == "cpu":
        return probe_gather_bitmap_domain_plain(bitmap, vplanes, ph, pl,
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
    with spans.span(spans.K_PROBE_GATHER_BITMAP):
        err = _build.lib().fhj_scan_domain_gather(
            bitmap.data_ptr(), vplanes[0].data_ptr(),
            vplanes[1].data_ptr() if len(vplanes) > 1 else None, v_rows,
            ph.data_ptr(), pl.data_ptr(), n, np_valid, lo.data_ptr(),
            hit.data_ptr(), out_ptrs[0], out_ptrs[1], stream)
    _build.check(err, "probe_gather_bitmap")
    return (hit, *outs)
