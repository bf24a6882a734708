"""The `global` tier's probe walk a join, in ms (ops/cuda/hash_walk.py,
csrc/hash_walk.cu, partition.cuh): the probe partition (ProbeRecords), the
walk kernels and the materialize's restore; the untemplated look-back scan
and the memsets count with the walk kernel that follows them."""

PATTERNS = (r"ProbeRecords", r"walk_kernel", r"restore_kernel")
ABSORB = (r"scan_kernel", r"Memset")


def read(t):
    return t.ms_per_join(PATTERNS, ABSORB)
