"""The global tier's walk a join, in ms: the device ops launched inside
the fhj.global.walk span (ops/hash_table.probe_count / probe_rows: the
probe partition, the walk kernels, the restore, their memsets)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.global.walk")
