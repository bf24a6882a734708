"""The process's one copy stream a card, shared by the probe-chunk stream
(api.py) and the distributed tier's exchanges (parallel/mesh.py)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def copy_stream(index: int) -> torch.cuda.Stream:
    """Card `index`'s copy stream.  One a card for the process: the caching
    allocator keeps a pool of blocks a stream, so a new stream a call would
    strand the blocks of the calls before it."""
    return torch.cuda.Stream(index)
