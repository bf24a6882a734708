"""Compaction K5 a join, in ms (ops/compact.py, csrc/stream_compact.cu):
its kernel and the memset of its scratch before it."""

PATTERNS = (r"compact_kernel",)
ABSORB = (r"Memset",)


def read(t):
    return t.ms_per_join(PATTERNS, ABSORB)
