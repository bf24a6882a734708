"""uint64 <-> (hi, lo) uint32-pair packing, and the key representation on
the device.

Host side (numpy) is bit-identical to flash_hash_join_tpu/utils/u64.py:
every u64 column travels as two u32 planes, SoA.

Device side (torch) — the one place this is decided:

  * A u32 plane is a ``torch.int32`` tensor holding the u32 BIT PATTERN
    (``torch.from_numpy(plane.view(np.int32))``).  The CUDA kernels read it
    as ``uint32_t*``; the sentinel 0xFFFFFFFF is int32 -1.
  * Plain torch code never compares, mins or subtracts int32 planes
    directly (a signed compare is wrong for values >= 2^31, and
    ``torch.uint32`` has only partial operator support).  It first calls
    ``widen``: int64 in [0, 2^32), where every u32 operation is exact; a
    u32 wrap-around (``kl - lo``) is ``(a - b) & MASK32``.  ``narrow``
    turns such int64 values back into int32 bit patterns for a kernel.
  * A whole u64 key that has to be ordered is ONE int64, ``sortable``:
    the key with its top bit flipped, so that signed int64 order is u64
    order (the CUDA kernels build the same value from the two words).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
INT32_MIN = torch.iinfo(torch.int32).min


def split_into(arr: np.ndarray, out):
    """Split a numpy u64 array into `out`, a pair of int32 host tensors of
    arr.size rows (the two rows of a (2, n) tensor, pinned or not, or two
    tensors): out[0] the hi words' bit patterns, out[1] the lo words'.
    The one split of the package: torch's copy runs on every host core,
    numpy's strided copy on one, 5-10x slower."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    # little-endian: word 0 of each key is its low half
    pairs = torch.from_numpy(arr.reshape(-1).view(np.int32)).view(-1, 2)
    out[0].copy_(pairs[:, 1])
    out[1].copy_(pairs[:, 0])
    return out


def split_u64(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split a numpy uint64 array into (hi, lo) uint32 arrays."""
    planes = split_into(arr, torch.empty((2, np.size(arr)),
                                         dtype=torch.int32))
    return tuple(planes.numpy().view(np.uint32))


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Combine (hi, lo) uint32 arrays back into a numpy uint64 array."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    out = np.empty(hi.shape + (2,), dtype=np.uint32)
    out[..., 0] = lo
    out[..., 1] = hi
    return out.view(np.uint64).reshape(hi.shape)


def to_device(plane: np.ndarray, device) -> torch.Tensor:
    """A numpy uint32 plane as an int32 bit-pattern tensor on `device`."""
    plane = np.ascontiguousarray(plane, dtype=np.uint32)
    return torch.from_numpy(plane.view(np.int32)).to(device)


def device_planes(arr: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """numpy u64 column -> (hi, lo) int32 bit-pattern planes on `device`
    (the counterpart of flash_hash_join_tpu/api.py's split + device_put),
    each plane an allocation of its own."""
    n = np.size(arr)
    hi, lo = split_into(arr, (torch.empty(n, dtype=torch.int32),
                              torch.empty(n, dtype=torch.int32)))
    return hi.to(device), lo.to(device)


def widen(t: torch.Tensor) -> torch.Tensor:
    """u32 bit patterns (int32) -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """Any u32-valued tensor (int32 pattern or widened int64) -> numpy u32."""
    return widen(t).cpu().numpy().astype(np.uint32)


def to_numpy_u64(hi: torch.Tensor, lo: torch.Tensor, count: int) -> np.ndarray:
    """The first `count` rows of two int32 bit-pattern planes as a numpy
    uint64 array (the read-back of flash_hash_join_tpu/api.py:287-291)."""
    return join_u64(hi[:count].cpu().numpy().view(np.uint32),
                    lo[:count].cpu().numpy().view(np.uint32))


def sortable(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern planes -> int64 keys whose signed order is the
    u64 order: key - 2^63, i.e. the u64 key with its top bit flipped.
    Exact: (hi ^ 2^31) as a signed word times 2^32, plus lo, never
    overflows."""
    return (hi ^ INT32_MIN).to(torch.int64) * 2**32 + widen(lo)
