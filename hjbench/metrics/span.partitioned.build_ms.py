"""The partitioned tier's table build a join, in ms: the device ops
launched inside the fhj.partitioned.build span (ops/range_table.py:
the sortable keys, torch's stable sort, the value gather and interleave,
the bucket directory)."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.partitioned.build")
