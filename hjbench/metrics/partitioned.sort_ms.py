"""The `partitioned` tier's table sort a join, in ms (ops/range_table.py,
ops/cuda/range_build.py, csrc/range_build.cu: the stable LSD radix sort,
its count_kernel and every pass_kernel<W>, with the memset of its scratch
before them).  The names are anchored so that range_probe_count_kernel
(K3) does not match."""

PATTERNS = (r"(?<!\w)count_kernel\(", r"(?<!\w)pass_kernel<")
ABSORB = (r"Memset",)


def read(t):
    return t.ms_per_join(PATTERNS, ABSORB)
