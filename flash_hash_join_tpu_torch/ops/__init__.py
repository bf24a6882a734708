"""Column ops of the port: hashing, segmented scans, the joins' tiers, and
the query primitives the joins decompose into (hash aggregate, filter,
sort and partition, compaction)."""

from flash_hash_join_tpu_torch.ops.aggregate import hash_aggregate  # noqa: F401
from flash_hash_join_tpu_torch.ops.compact import compact_by_mask  # noqa: F401
from flash_hash_join_tpu_torch.ops.filter import filter_columns  # noqa: F401
from flash_hash_join_tpu_torch.ops.sort import (  # noqa: F401
    radix_partition_by_hash,
    sort_u64,
)
