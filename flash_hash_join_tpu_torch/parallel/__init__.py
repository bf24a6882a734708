"""Distributed join tier: mesh, shuffle, hot keys, the join, multi-process
(port of flash_hash_join_tpu/parallel/)."""

from flash_hash_join_tpu_torch.parallel.distributed_join import (  # noqa: F401
    distributed_join_exact,
    shard_columns,
)
from flash_hash_join_tpu_torch.parallel.mesh import data_mesh  # noqa: F401
from flash_hash_join_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_multihost,
    pod_mesh,
)
