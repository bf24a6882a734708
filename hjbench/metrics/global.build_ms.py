"""The `global` tier's table build a join, in ms (ops/hash_table.py,
csrc/hash_build.cu, partition.cuh): the partition levels instantiated for
BuildRecords and the finish kernel; the untemplated look-back scan and the
memsets count with the build kernel that follows them."""

PATTERNS = (r"BuildRecords", r"finish_kernel")
ABSORB = (r"scan_kernel", r"Memset")


def read(t):
    return t.ms_per_join(PATTERNS, ABSORB)
