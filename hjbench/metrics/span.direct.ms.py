"""The direct tier a join, in ms: the device ops launched inside the
fhj.direct span (ops/direct_bitmap.py: K1 / K2 with their memsets, the
count's special stack)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.direct")
