"""flash_hash_join_tpu_torch — the PyTorch/CUDA port of flash_hash_join_tpu.

This slice runs the dense-domain count path on an NVIDIA H100 (sm_90a):
`adaptive_join_count` and `join_count` with strategy "adaptive", "direct"
or "merge", through two hand-written CUDA kernels (csrc/).  It imports
neither jax nor the JAX package, which stays in the repository as the
reference the tests hold this package against.

All functions take numpy uint64 (build_keys, build_values, probe_keys)
and return (count, core_seconds); `device` defaults to "cuda".
"""

from flash_hash_join_tpu_torch.api import (  # noqa: F401
    adaptive_join_count,
    adaptive_join_count_bloom,
    initialize,
    join_count,
    launch_counts,
    plan_strategy,
)

__version__ = "0.1.0"
