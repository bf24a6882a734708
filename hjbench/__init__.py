"""hjbench: the benchmark of flash_hash_join_tpu_torch on an NVIDIA card.

One run measures one cell of BENCHMARK.json: `python3 -m hjbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`.  Everything a
cell uses is found by name: its configuration in configs/<config>.json
(whose generator is datagen/<generator>.py), its traffic mix in
traffic/<traffic>.json (whose driver is drivers/<driver>.py), and each
per-layer metric's reader in metrics/<metric>.py.  The yardstick (generators, reference, peaks, the
reduction of traces) lives here, apart from the program it measures.
"""
