"""The plain reference: exact first-match inner equi-join on uint64 keys.

Plain PyTorch (on the card, or the CPU in tests); it imports nothing of the
program and works only from the numpy columns the benchmark made.  A
count is the number of probe rows whose key is in the build table; a
materialize is, in probe order, each such row's key with the value of its
key's minimum build row.  The build side is sorted once by (key, row)
with a stable sort; the probe side is searched in blocks of rows, so the
reference fits beside the program's outputs.

`fingerprint=True` is the control: keys are matched by a 32-bit
fingerprint (the top half of splitmix64's finalizer) in place of the
64-bit key, as a table that stores fingerprints would.  It breaks the
exact key equality that the configurations state.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

SIGN = np.uint64(1 << 63)


def fingerprint(keys: np.ndarray) -> np.ndarray:
    """The top 32 bits of splitmix64's finalizer of each uint64 key."""
    z = keys.astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z >> np.uint64(32)


def _ordered(keys: np.ndarray, device) -> torch.Tensor:
    """uint64 keys as int64 whose signed order is the unsigned one."""
    return torch.from_numpy((keys ^ SIGN).view(np.int64)).to(device)


class Table(NamedTuple):
    keys: torch.Tensor       # distinct build keys, ascending (ordered int64)
    values: torch.Tensor     # the minimum build row's value of each, int64 bits


def build(bk: np.ndarray, bv: np.ndarray, device, *,
          fingerprint_keys: bool = False) -> Table:
    """The distinct build keys with the value of each one's minimum row."""
    keys = _ordered(fingerprint(bk) if fingerprint_keys else bk, device)
    skeys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    values = torch.from_numpy(bv.view(np.int64)).to(device)
    return Table(skeys[first], values[order[first]])


class Block(NamedTuple):
    start: int               # the block's first probe row
    keys: torch.Tensor       # the matched rows' probe keys (uint64 bits as int64)
    values: torch.Tensor     # their values (uint64 bits as int64)


def probe(table: Table, pk: np.ndarray, device, *, block_rows: int,
          fingerprint_keys: bool = False) -> Iterator[Block]:
    """The matched rows of each block of `block_rows` probe rows, in probe
    order."""
    for start in range(0, pk.size, block_rows):
        part = pk[start:start + block_rows]
        want = _ordered(fingerprint(part) if fingerprint_keys else part,
                        device)
        pos = torch.searchsorted(table.keys, want)
        pos.clamp_(max=max(table.keys.numel() - 1, 0))
        hit = (table.keys[pos] == want) if table.keys.numel() else \
            torch.zeros_like(want, dtype=torch.bool)
        raw = torch.from_numpy(part.view(np.int64)).to(device)
        yield Block(start, raw[hit], table.values[pos[hit]])

