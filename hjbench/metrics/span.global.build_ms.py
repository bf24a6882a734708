"""The global tier's table build a join, in ms: the device ops launched
inside the fhj.global.build span (ops/hash_table.build_table: the build
kernels and their memsets)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.global.build")
