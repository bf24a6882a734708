"""The global tier's bloom prune a join, in ms: the device ops launched
inside the fhj.global.prune span (ops/cuda/hash_walk.py: a memset and
prune_kernel a pass of a count with bloom on the walk's 1-level route),
which nests in fhj.global.walk, so span.global.walk_ms holds it too."""

from hjbench.spans import layer_ms


def read(t):
    return layer_ms(t, "fhj.global.prune")
