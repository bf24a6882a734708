"""The port's harness: the benchmark (harness/benchmark.py) and the
differential fuzzer (harness/fuzz_join.py), twins of the JAX package's
benchmark.py and scripts/fuzz_join.py, checked against the port's own C++
host oracle (utils/native.py); the adaptive gates' crossover sweep
(harness/crossover.py, the twin of scripts/profile_crossover.py,
profile_direct.py and profile_dense_mat.py) and gate-drift check
(harness/gate_drift.py, the twin of scripts/check_gate_drift.py).  Each
runs as a module:

    python3 -m flash_hash_join_tpu_torch.harness.benchmark --gen 1e6
    python3 -m flash_hash_join_tpu_torch.harness.fuzz_join --iters 200
    python3 -m flash_hash_join_tpu_torch.harness.crossover --mode count
    python3 -m flash_hash_join_tpu_torch.harness.gate_drift
"""
