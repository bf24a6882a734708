"""The partitioned tier's probe a join, in ms: the device ops launched
inside the fhj.partitioned.probe span (K3 / K4, ops/cuda/range_probe.py)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.partitioned.probe")
