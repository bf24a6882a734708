"""Compaction a join, in ms: the device ops launched inside the
fhj.compact span (ops/compact.compact_by_mask: K5 and its scratch's
memset, or the blockwise sort and K6)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.compact")
