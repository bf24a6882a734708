"""flash_hash_join_tpu_torch — the PyTorch/CUDA port of flash_hash_join_tpu.

This package runs on an NVIDIA H100 (sm_90a) through hand-written CUDA
kernels (csrc/):
  * the reference module's 13 functions: adaptive_join[_count][_bloom],
    hash_join[_bloom], hash_join_count[_bloom], hash_join_radix[_bloom],
    hash_join_count_radix[_bloom] and initialize;
  * `join_count` and `join_materialize` with strategy "adaptive",
    "direct", "partitioned", "merge", "global" or "vmem";
  * `plan_strategy`, `adaptive_strategy`, `bloom_is_distinct`, `launch_counts` and
    `measure_device_seconds`;
  * the distributed tier, `distributed_join_count` and
    `distributed_join_materialize` (parallel/): a ragged hash shuffle and
    hot-key replication over a mesh of ranks, in one process
    (parallel.mesh.data_mesh, ranks on several cards or several ranks on
    one) or one rank a process (parallel.multihost);
  * a probe side past the device's memory streams from the host in
    chunks (api._run_chunked);
  * the query primitives in `ops`: hash_aggregate, filter_columns and the
    u64 predicates, sort_u64, radix_partition_by_hash, compact_by_mask.
It imports neither jax nor the JAX package, which stays in the repository
as the reference the tests hold this package against.

All functions take numpy uint64 (build_keys, build_values, probe_keys)
and return (count, core_seconds); `device` defaults to "cuda".
"""

from flash_hash_join_tpu_torch.api import (  # noqa: F401
    adaptive_join,
    adaptive_join_bloom,
    adaptive_join_count,
    adaptive_join_count_bloom,
    adaptive_strategy,
    bloom_is_distinct,
    distributed_join_count,
    distributed_join_materialize,
    hash_join,
    hash_join_bloom,
    hash_join_count,
    hash_join_count_bloom,
    hash_join_count_radix,
    hash_join_count_radix_bloom,
    hash_join_radix,
    hash_join_radix_bloom,
    initialize,
    join_count,
    join_materialize,
    launch_counts,
    measure_device_seconds,
    plan_strategy,
)

__version__ = "0.5.0"
