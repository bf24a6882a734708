#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flash_hash_join_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each on stdout:
  1. env      torch/CUDA versions, the card, the host's RAM, nvcc, and the
              kernels' build from the checkout's csrc/ (seconds, ptxas
              register report).
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card (exact): K1 and K2, which read the key planes, at every
              bitmap rung of their bands (K2: 8-256 rows; K1: 512, 16384,
              28672) with a nonzero lo, high-word, out-of-domain, below-lo
              and u32-max keys, views misaligned alike and each its own
              way, validity tails, empty sides, a build of bad rows only,
              and a high-word build row under every other row's low word,
              where each must also differ from the other's plain version
              (K2 takes lo over every row, K1 over the zero-high-word
              rows);
              K3/K4/K5 at build sizes 0, 1, 5, 2e6 and probe sizes 0, 7,
              3e7+5, and on builds that stress the range table's bucket
              directory (the keys {0, 2^64-1}; 2e6 keys: all equal,
              spanning all of u64, 99 % in one bucket, a 1e5-row duplicate
              run) at probe sizes 0, 7, 3e6+5, each table as built and with
              its other layouts forced (no directory, one of 2^6 buckets,
              64-bit offsets), the directory build against its plain
              version and numpy at both offset widths; misaligned
              views, np_valid < npr, the u64-max key on both sides, K5
              with 2, 3 and 4 planes, and alone around its 8192-row tile
              (the first tiles empty, the last full), each call made twice
              back to back; K7, which reads the probe key
              planes, at v_rows 8, 16, 64, 128 (lo 0, inside u32, at its
              top and 0xFFFFFFFF) with the domain's edge keys (lo, its
              last slot, past it, below lo, a high word, u32-max,
              u64-max), views misaligned each plane its own way and
              np_valid < npr, at sizes 0, 7 and 3e7+5; K8, which reads the
              probe key planes, at every rung 256-8192 with the count's
              edge keys,
              lo inside u32, 0, at its top and 0xFFFFFFFF, views misaligned
              each plane its own way and np_valid < npr, at sizes 0, 7 and
              3e6+5; K7 and K8 with 1 and 2 value planes; K9 (on no path:
              the TPU kernel's counterpart) at sizes 0, 7, 3e7+5 and around
              its 4096-word block, on misaligned, odd-length views; K10/K11
              at every vmem rung (R 8-512) with a bucket full to its last
              slot, probe sizes 0, 7, 3e7+5, misaligned views, np_valid <
              npr and the u64-max key on both sides, the layout launches
              alone at each rung (K11's bucket-major copy of keys and
              values, K10's of the keys alone), and K6 with 1-4 planes
              over 1 block, 520 blocks of 64K words and 5000 of 1001
              words (look-backs over many windows; each block's source at
              another 16-byte offset), planes viewed at word offsets 0-3,
              counts all empty, all full, random, of every residue mod 4,
              empty and full alternating and out of range, int32 and
              int64, its total checked too; the global tier's walk (count
              and materialize, csrc/hash_walk.cu) on every case of
              models/workload.global_walk_cases (crowded chains to the
              last group, max_probe_iters 2, u64-max probes, duplicates,
              n_valid cut, pre_shift 2, an empty probe side, group sizes 1
              and 32, and the slice edges: chains across a slice, every
              probe in one slice, Zipf-1.2 probes, u64-max probes among
              partitioned rows, n_valid cut inside a pass; bloom off and
              on), by the plan's route on aligned probe planes and with
              each route forced (0 levels; 1 level in passes of 1000
              rows) on misaligned ones, and on J1 1e8 Q5 and config #2,
              bloom off and on: counts, hit masks, value planes and walk
              statistics equal to the plain walk's, both routes timed; the
              global tier's build (csrc/hash_build.cu,
              phase build_kernels) against the plain build, planes equal by
              torch.equal, on every case of
              models/workload.global_build_cases (random keys, duplicates,
              all keys equal, one large group, u64-max keys repeated and
              alone, n_valid cut and 0, an empty side, the crowded table,
              max_probe_iters 2, pre_shift 1-3, group sizes 1, 2, 8, 32,
              and the kernel's tile edges; bloom off and on), three on
              misaligned planes, 1e6 equal keys and 1e5 keys homed to one
              group (oversize tiles, timed), then J1 1e8 Q5 and config
              #2, bloom off and on, timed beside its bound, the plain build
              and one stable torch.sort of the sortable build keys, with
              its peak device bytes; the partitioned tier's table build
              (csrc/range_build.cu, phase range_build) against the plain
              build (the torch.sort build), bit for bit, with values and
              without, on models/workload.range_build_cases and J1 4e7 and
              1e8 Q5's build sides, printing the passes each build ran,
              then timed at J1 1e8 Q5.  Then each kernel and its plain version timed (CUDA
              events: a lone call, median of 5 after a warm-up; the kernel
              also over runs of 5 calls back to back) on its path's own
              inputs, beside its bound and, where one PyTorch call computes
              the same function, that call's time (K1, K2: torch.isin of
              the domain indices; K9: clone, timed in turns with it, on 1e8
              words; the walk's count: torch.isin of the sortable keys, at
              J1 1e8 Q5 and config #2); K3/K4 at J1 1e8 Q5 with
              the directory's offsets as int32 (as built) and as int64; and
              K3/K4 on both table layouts (searched whole, or through a
              directory) at build sizes 100 to 1e5.  K4's 1-level route
              (range_probe_sliced) is held to its plain version on every
              table with a directory above (forced, 3 digit bits, and in
              passes of 1000 rows on the edge builds), timed at J1 1e8 Q5
              beside the 0-level K4 (forced), and held there, bit for bit,
              to its plain version and to the 0-level K4 as the plan routes
              it (k4_routes_vs_plain); both routes are timed over tables of
              2^20 to 1e8 J1 keys and of 2^22 to 2^24 uniform u64 keys, and
              2^18 to 1e8 probe rows, the sweep from which
              ops/cuda/range_probe.plan's threshold was taken (k4_routes).  K7 is timed on each of
              its path's cells (J1 1e7 Q2, 4e7 Q1, 1e8 Q1), K8 on its own,
              K10 and K11 at R 16 (J1 1e8 Q1) and R 512 (J1 4e7 Q2), K6 at
              1e8 rows with 4 planes at 60 and 5 % hits and 2 planes at 60 %
              (each beside one boolean-mask index of the stacked planes); the
              kernels line gives one cell a kernel and the rest under
              other_cells.
  3. main     adaptive_join_count(device="cuda") on the db-benchmark J1
              cells: 4e7 Q1, Q2, Q5 (j1_suite seed 0), bench.py's 4e7 case
              (default_rng(2026)) and 1e8 Q5.  Each count must equal the
              numpy oracle and take the route the adaptive gates decide
              (ops/direct_bitmap.py; "direct" on these cells) with no
              retry; K1 (Q5) or K2 (Q1, Q2) must launch (through
              strategy="direct" where the gate routes elsewhere).
  4. radix    BASELINE.json config #4: J1 1e8 Q1, Q2, Q5 through
              hash_join_radix, and Q5 through hash_join_count_radix.
  5. adaptive BASELINE.json config #2: uniform 1e7 x 1e8, 50 % match,
              64-bit keys, through adaptive_join_count and adaptive_join.
              Phases 4 and 5: count == oracle; the materialized rows equal
              the oracle's in probe order (hence also as sorted pairs), with
              the minimum build row as the duplicate-key winner; route
              "partitioned" with no retry; K3 (count), K4 by either route
              and K5 launched, and in each phase the directory build (the
              J1 Q1 table, 100 keys, has none); in phase 4 both K4 routes
              (the 1-level one at Q5).
  6. direct_vs_partitioned  J1 4e7 Q1, Q2, Q5 count through
              join_count(strategy="partitioned"), beside phase 3's direct.
  7. fallback a sparse 64-bit case through the exact merge join, count and
              materialize, beside the partitioned tier on the same input.
  8. dense_mat  dense-domain materialize: J1 1e7 Q2 (K7 at v_rows 128),
              4e7 Q1 and Q2, 1e8 Q1 and Q2 (4e7 Q2 and 1e8 Q2: K8 at
              v_rows 512 and 1024) through adaptive_join, which must take
              the route its gate decides (direct on 1e8 Q2 only), then
              through join_materialize(strategy="direct"), timed, and with
              return_arrays=True: count and probe-order rows equal the
              oracle, no retry, K7 or K8, and K5 launched, and K9 and the
              plain int64 probe mapping not (both bands map the key planes
              in-kernel); the same cell through strategy="partitioned"
              beside it.  Then a wide-value cell (u64 values, 2 value
              planes) at the 4e7 Q2 shape, where direct, partitioned and
              merge must agree with the oracle.
  9. vmem     join_count / join_materialize(strategy="vmem") on J1 1e8 Q1
              (R 16) and 4e7 Q2 (R 512): exact rows in probe order, no
              retry, K10 or K11 + K5 launched; then uniform 1e6 x 1e7, past
              the tier's 64K slots, which must rerun on merge, exact.
 10. global   hash_join_count[_bloom] and hash_join[_bloom] (the global
              tier) on J1 1e8 Q5 and config #2: exact, no retry, bloom and
              no bloom agreeing, the build kernel and the walk kernel
              launched once a call; each
              function's walk statistics (groups a probe, the longest
              walk), and the count's build and walk device times.
 11. stream_compact  with FHJ_COMPACT=stream: hash_join_radix on J1 1e8 Q2
              and join_materialize(strategy="direct") on J1 1e8 Q1, rows
              equal to the
              oracle's in probe order (as in phases 4 and 8), K6 launched
              and K5 not.
 12. config3  BASELINE.json config #3, uniform 1e7 x 1e9 at 5 % match
              (64-bit keys, partitioned), made in the phase and freed
              after: adaptive_join_count and join_materialize(return_arrays=
              True) at the card's own budget (one chunk) and with the
              planner's budget patched to 4 chunks, streamed by the depth-2
              pipeline and serially (FHJ_CHUNK_OVERLAP=0): count and rows
              equal to the oracle (the probe keys below 2^62, in probe
              order), probe_chunks 1 or 4, no merge retry; core, wall and
              peak allocated and reserved bytes a probe row.  Then the
              planes put on the card once, and
              ops.range_table.range_join_count_chunked (the table built
              once) at 1, 4 and 16 chunks of the resident probe planes:
              count equal to the oracle, K3 launched once a chunk and the
              directory once a call; core (best of 3 CUDA-event timings
              after a warm-up), probe rows/s, peak bytes a probe row, and
              the table build alone (config3_resident lines).  Then
              hash_join_count_bloom (the global tier, its count pruned by
              the bloom a pass at 1 level): count equal to the oracle,
              routed global with bloom, the prune launched; core, wall,
              peak and the walk statistics (groups visited, the longest
              walk, the rows the bloom passed; config3_bloom line).
 13. stream_direct  J1 1e8 Q5 adaptive_join_count planned in 4 chunks: the
              main phase's count, the gates' route for a chunk's rows
              (direct), K1 launched once a chunk.
 14. measure  measure_device_seconds on bench.py's 4e7 cell and J1 1e8 Q5:
              the oracle's count, chained False, 0 < device_seconds <=
              single_call_seconds, beside the main phase's best core.
 15. primitives  db-benchmark groupby G1 (1e8 rows, id6 over [1, 1e6], v1
              over [1, 5]): hash_aggregate, filter_columns on between_u64,
              sort_u64, radix_partition_by_hash(pbits=8), each exact
              against numpy and timed.
 16. harness  the harness twins (flash_hash_join_tpu_torch/harness/), their
              RESULT and fuzz lines on stderr: run_suites on the generated
              1e6 suite (J1 Q1, Q2, Q5 and QB5 at 5 % match; BASELINE.json
              config #1's size) with all six impl labels, count and
              materialize, the (key, value) rows of merge, global and
              partitioned checked; run_suites on J1 1e8 Q1, Q2, Q5 (config
              #4) with adaptive_join and flash_join_radix; the fuzzer twin,
              40 fixed-shape iterations (seed 0) and 12 streamed in 2-4
              probe chunks (seed 40).  0 parity failures, the C++ host
              oracle on every case, 0 fuzz failures; K1-K5, K7, K8, K10 and
              K11 launched.  One line: runs, failures, oracles, fuzz
              summaries, the best core of each case, impl and task, seconds.
 17. gates    harness/gate_drift.py's sentinels, one on each side of every
              adaptive gate (the J1 cells above where the shape matches),
              each timed direct against partitioned: every count equal to
              the C++ host oracle's, every adaptive call on the route its
              gate decides, every gate PASS (the faster route is the
              gate's, or within 15 %); K1-K5, K7 and K8 launched.
 18. distributed  the distributed tier through the in-process mesh, one
              card a rank when the machine has them, else every rank on
              cuda:0 (each line says which): dist-zipf-c5, BASELINE.json
              config #5's share of a chip (6.25e7 build and probe rows a
              rank, 4 ranks: 16 chips cut to 4), Zipf-1.2 probes over
              unique build keys, distributed_join_count (a warm-up call,
              then one) and distributed_join_materialize(return_arrays=
              True) against an oracle on the card (the count, the sorted
              output keys, each value its key's build row's), then the
              count with its probe exchange not overlapped; dist-scale-1e8,
              uniform 1e8 x 1e8 at 50 %, count at 1, 2 and 4 ranks;
              dist-pg, dist-scale-1e8's data (and, on 4 cards,
              dist-zipf-c5's) over NCCL through the worker processes of
              parallel/worker.py, one a card (world the largest power of
              two <= min(4, cards)), each holding its count and rows to
              an oracle on its card.  Each line: core, wall, stage
              seconds, rows each rank received, the hot set, drops and
              reruns, each card's peak allocated and reserved bytes.  K5,
              both walk kernels and the build kernel launched.
Kernel times, two readings: "ms", each call alone between two CUDA events
(cuda_ms, whose window holds the wrapper's host work); "ms_b2b", runs of
calls back to back (cuda_ms_b2b, where that work overlaps the card's).
Phases 3-5 and 8-11 time a warm-up and then the best of the following
runs: core_seconds (device time), wall seconds, probe rows/s, peak device
bytes.  The kernel counts are set to 0 just before each of phases 3, 4, 5
and 8-18 and read just after (the kernels line's launches: phases 3, 4, 8,
9, 10, 11, 16, 17 and, for K5, the walk and the build, 18).  Then the
seconds of each phase, the kernels summary (the 11 TPU kernels'
counterparts, the range table's directory build, the global walk's two
kernels, the global build and the range table's build: each one's
launches on its path, error against its plain
version, times, bound and library time), the card's name and power
limit as nvidia-smi prints them, and last {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and the last line is
not printed.  Without a CUDA card, or outside a checkout, it exits 1
before doing anything.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SENTINEL = 0xFFFFFFFF
M64 = 2**64 - 1
PALLAS = "flash_hash_join_tpu/ops/pallas/"
REPLACES = {"dense_bitmap": PALLAS + "dense_bitmap.py:159",
            "scan_domain_count": PALLAS + "bitmap_probe.py:149",
            "range_probe_count": PALLAS + "range_probe.py:330",
            "range_probe_materialize": PALLAS + "range_probe.py:368",
            # the column boundaries of the TPU range table (plain XLA)
            "range_directory": "flash_hash_join_tpu/ops/range_table.py:265",
            "compact": PALLAS + "stream_compact.py:337",
            "probe_gather_bitmap": PALLAS + "bitmap_probe.py:96",
            "probe_gather_staged": PALLAS + "dense_values.py:135",
            "materialize_copy": PALLAS + "dense_values.py:48",
            "concat_ragged_blocks": PALLAS + "stream_compact.py:123",
            "probe_count_vmem": PALLAS + "bucket_probe.py:116",
            "probe_materialize_vmem": PALLAS + "bucket_probe.py:138",
            # the global tier's walk and the scans around it (plain XLA)
            "global_walk_count": "flash_hash_join_tpu/ops/hash_table.py:212",
            "global_walk_materialize":
                "flash_hash_join_tpu/ops/hash_table.py:212",
            # the global tier's table build (plain XLA)
            "global_build": "flash_hash_join_tpu/ops/hash_table.py:74",
            # the partitioned tier's table sort (a plain lax.sort)
            "range_build": "flash_hash_join_tpu/ops/range_table.py",
            # the bloom test inside the JAX walk (plain XLA)
            "global_prune": "flash_hash_join_tpu/ops/hash_table.py:241",
            # K4's 1-level route: the same TPU kernel
            "range_probe_sliced": PALLAS + "range_probe.py:368"}
KERNELS = {  # launch-count key -> (wrapper name, source under csrc/)
    "dense_bitmap": ("fused_domain_bitmap_join", "dense_bitmap.cu"),
    "scan_domain_count": ("scan_domain_count", "bitmap_probe.cu"),
    "range_probe_count": ("range_probe_count", "range_probe.cu"),
    "range_probe_materialize": ("range_probe_materialize", "range_probe.cu"),
    "range_directory": ("range_directory", "range_probe.cu"),
    "compact": ("compact_by_mask", "stream_compact.cu"),
    "probe_gather_bitmap": ("probe_gather_bitmap", "bitmap_probe.cu"),
    "probe_gather_staged": ("probe_gather_staged", "dense_values.cu"),
    "materialize_copy": ("materialize_copy", "dense_values.cu"),
    "concat_ragged_blocks": ("concat_ragged_blocks", "stream_compact.cu"),
    "probe_count_vmem": ("probe_count_vmem", "bucket_probe.cu"),
    "probe_materialize_vmem": ("probe_materialize_vmem", "bucket_probe.cu"),
    "global_walk_count": ("global_walk_count", "hash_walk.cu"),
    "global_walk_materialize": ("global_walk_materialize", "hash_walk.cu"),
    "global_build": ("global_build_table", "hash_build.cu"),
    "range_build": ("range_build", "range_build.cu"),
    "global_prune": ("global_prune", "hash_walk.cu"),
    "range_probe_sliced": ("range_probe_materialize", "range_probe.cu")}
# K4 by either route (ops/cuda/range_probe.plan): a path's check takes one
K4 = ("range_probe_materialize", "range_probe_sliced")
# The card's peaks for a kernel's bound (H100 SXM at 700 W): device
# memory, and the float32 rate outside the tensor cores, taken for
# integer operations.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return dict(bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() on the card, after one warm-up call:
    each call alone between two CUDA events, so the window also holds the
    call's host work (a Python wrapper's checks and launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_b2b(fn, reps: int = 5, runs: int = 3) -> float:
    """Milliseconds of one call of fn() when calls run back to back: after
    a warm-up call, `runs` runs of `reps` calls between two CUDA events, the
    median of the runs' means.  A call's host work then overlaps the card's
    work on the call before, as on the path."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def paired_ms(kernel, plain, plain_b2b: bool = False) -> dict:
    """A kernel and its plain version timed in turns, plain, kernel, kernel,
    plain (the first and last bracket any drift of the card's clock within
    the call), two readings each: "ms" and "plain_ms" by cuda_ms, "ms_b2b"
    by cuda_ms_b2b, and "plain_ms_b2b" too when plain_b2b."""
    t = {"plain_ms": [], "ms": [], "ms_b2b": []}
    if plain_b2b:
        t["plain_ms_b2b"] = []
    for key, fn in (("plain_ms", plain), ("ms", kernel), ("ms", kernel),
                    ("plain_ms", plain)):
        t[key].append(cuda_ms(fn))
        if key + "_b2b" in t:
            t[key + "_b2b"].append(cuda_ms_b2b(fn))
    return t


def best(t: dict) -> dict:
    """The least of each reading of paired_ms."""
    return {k: min(v) for k, v in t.items()}


def launched(launches: dict, kernel) -> bool:
    """Whether `kernel` launched: a launch key, or a tuple of keys of
    which any."""
    keys = (kernel,) if isinstance(kernel, str) else kernel
    return any(launches[k] > 0 for k in keys)


def zero_launches() -> None:
    from flash_hash_join_tpu_torch.utils import spans
    spans.reset()


def require_launched(phase: str, kernels) -> dict:
    import flash_hash_join_tpu_torch as ft
    launches = ft.launch_counts()
    require(all(launched(launches, k) for k in kernels),
            f"{phase}: a kernel of the path never launched: {launches}")
    return launches


_ORACLE: dict = {}


def oracle(name: str, c):
    """numpy first-match oracle of a cell, memoised: (hit mask over the
    probe rows, matched values in probe order).  The minimum build row
    wins among duplicate keys (np.unique's stable return_index)."""
    if name not in _ORACLE:
        uniq, first = np.unique(c.build_keys, return_index=True)
        # search the probes in sorted order, then put the positions back in
        # probe order: 5x faster than random searches at 1e7 build keys
        order = np.argsort(c.probe_keys)
        found = np.searchsorted(uniq, c.probe_keys[order])
        np.minimum(found, uniq.size - 1, out=found)
        pos = np.empty_like(found)
        pos[order] = found
        hit = uniq[pos] == c.probe_keys
        _ORACLE[name] = (hit, c.build_values[first[pos[hit]]])
    return _ORACLE[name]


def domain_indices(bk: np.ndarray, pk: np.ndarray):
    """A J1 count cell's lo-relative u32 domain indices of both sides and
    its bitmap rung, computed independently in numpy (the input of K1's
    and K2's library yardstick, torch.isin).  J1 keys are below 2^32, so
    K1's lo and K2's are both the build side's least key."""
    from flash_hash_join_tpu_torch.ops import direct_bitmap as db
    lo = bk.min()
    d_rows = db.d_rows_for(int(bk.max() - lo) + 1)
    d_bits = np.uint64(d_rows * 4096)
    bidx = (bk - lo).astype(np.uint32)
    pd = pk - lo                                       # wraps below lo
    pidx = np.where((pk >= lo) & (pd < d_bits), pd, SENTINEL)
    return bidx, pidx.astype(np.uint32), d_rows


def phase_env():
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    report = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         nvidia_smi=run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]),
         host_ram_bytes=os.sysconf("SC_PAGE_SIZE") * os.sysconf(
             "SC_PHYS_PAGES"),
         nvcc=run([_build._nvcc(), "--version"]).splitlines()[-1],
         build_seconds=build_s, ptxas=ptxas_usage(report))


def ptxas_usage(report: str) -> dict:
    """Kernel name -> ptxas's register/shared-memory line, from nvcc -v."""
    usage, kernel = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"([a-z_]+_kernel)E", line)
            kernel = found.group(1) if found else line.split("'")[1]
        elif "Used" in line and kernel:
            usage[kernel] = line.split(":", 1)[1].strip()
    return usage


def check_domain_entry(kernel, plain, other_plain, rungs, sizes, err: list,
                       rng):
    """A count entry on key planes (K1 or K2) against its plain version at
    each rung: a nonzero lo, the edge keys of domain_sides, aligned and
    misaligned views, validity tails, empty sides, a build of bad rows
    only.  sizes[1] keeps every build row at or above lo; sizes[-1] adds a
    high-word build row whose low word is under every other row's, where
    K1's lo (zero-high-word rows) and K2's (every row) part: there the
    kernel must also differ from the other entry's plain version.  Adds
    the largest |kernel - plain| to err[0]; returns the cases."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import (
        domain_sides, offset_plane_views)
    dev = torch.device("cuda")
    cases = []
    for d_rows in rungs:
        n_bits = d_rows * 4096
        lo = int(rng.integers(n_bits, 2**31))
        for i, (nb, npr) in enumerate(sizes):
            hi_under = i == len(sizes) - 1
            bk, pk = domain_sides(rng, nb, npr, lo, n_bits,
                                  below_lo=i != 1 and not hi_under,
                                  hi_under=hi_under)
            for shift in ((0, 0), (1, 1), (1, 3)):
                kh, kl = offset_plane_views(bk, dev, *shift)
                ph, pl = offset_plane_views(pk, dev, *shift[::-1])
                for nbv, npv in {(kh.numel(), ph.numel()),
                                 (max(kh.numel() - 5, 0),
                                  max(ph.numel() - 3, 0))}:
                    args = (kh, kl, ph, pl, nbv, npv, d_rows)
                    got = [int(x) for x in kernel(*args)]
                    want = [int(x) for x in plain(*args)]
                    err[0] = max(err[0], *(abs(g - w)
                                           for g, w in zip(got, want)))
                    if hi_under:
                        other = [int(x) for x in other_plain(*args)]
                        require(got != other, f"{kernel.__name__} d_rows "
                                f"{d_rows}: the other band's lo gives the "
                                f"same {got}")
                    cases.append([d_rows, nbv, npv, shift, got, want])
            del bk, pk, kh, kl, ph, pl
    return cases


def phase_kernels(cells: dict) -> dict:
    """K1 and K2, both on key planes, == plain at every rung; then both
    timed on main-path inputs.  Returns the per-kernel summary fields
    (max_abs_err, ms, ms_b2b, plain_ms, bound, library_ms)."""
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
    from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, to_device
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    err = {"scan_domain_count": [0], "dense_bitmap": [0]}
    checked = {
        "scan_domain_count": check_domain_entry(
            bp.scan_domain_count, bp.scan_domain_count_plain,
            dbm.fused_domain_bitmap_join_plain, (8, 16, 32, 64, 128, 256),
            ((2_000_001, 6_000_003), (2_000_003, 6_000_001), (0, 1_000),
             (1_000, 0), (5, 7), (-1_000, 1_000), (200_005, 600_007)),
            err["scan_domain_count"], rng),
        "dense_bitmap": check_domain_entry(
            dbm.fused_domain_bitmap_join, dbm.fused_domain_bitmap_join_plain,
            bp.scan_domain_count_plain, (512, 16384, 28672),
            ((5_000_001, 6_000_003), (5_000_003, 6_000_001), (0, 1_000),
             (1_000, 0), (5, 7), (-1_000, 1_000), (500_005, 600_007)),
            err["dense_bitmap"], rng)}
    torch.cuda.synchronize()
    err = {k: v[0] for k, v in err.items()}
    require(all(e == 0 for e in err.values()), f"kernel != plain: {checked}")
    emit("kernels_vs_plain", kernels=list(err),
         tolerance="exact (integer counts)", max_abs_err=err,
         cases=sum(len(v) for v in checked.values()))

    timing = {}
    for name in ("4e7-Q1", "4e7-Q2", "4e7-Q5", "1e8-Q5"):
        c = cells[name]
        kh, kl = device_planes(c.build_keys, dev)
        ph, pl = device_planes(c.probe_keys, dev)
        bidx_np, pidx_np, d_rows = domain_indices(c.build_keys, c.probe_keys)
        args = (kh, kl, ph, pl, kh.numel(), ph.numel(), d_rows)
        kernel, fn, plain = (
            ("scan_domain_count", bp.scan_domain_count,
             bp.scan_domain_count_plain) if d_rows <= bp.MAX_D_ROWS else
            ("dense_bitmap", dbm.fused_domain_bitmap_join,
             dbm.fused_domain_bitmap_join_plain))
        got, bad = (int(x) for x in fn(*args))
        want = int(plain(*args)[0])
        require(bad == 0, f"{name}: {bad} bad build rows")
        require(got == want, f"{kernel} {name}: kernel {got} != plain {want}")
        t = paired_ms(lambda: fn(*args), lambda: plain(*args))
        # the library yardstick of K1 and K2: one torch.isin of the cell's
        # domain indices (mapped on the host), timed here and used nowhere
        # in the port
        bidx, pidx = to_device(bidx_np, dev), to_device(pidx_np, dev)
        library_ms = cuda_ms(lambda: torch.isin(pidx, bidx).sum())
        del bidx, pidx
        timing[name] = dict(kernel=kernel, d_rows=d_rows, nb=kh.numel(),
                            npr=ph.numel(), **best(t), library_ms=library_ms)
        emit("kernel_time", cell=name, **timing[name],
             runs={k + "_runs": v for k, v in t.items()})
        del kh, kl, ph, pl, args
        torch.cuda.empty_cache()
    # K1 and K2 read the four key planes once (8 B a row of each side) and
    # write the count and the bad-row count; their design reads the build
    # planes twice (the lo pass), 16 B a build row.  About 4 integer
    # operations a row (subtract, compare, shift, mask, test or atomic OR).
    summary = {}
    for kernel, cell, at in (("dense_bitmap", "4e7-Q5",
                              "J1 4e7 Q5, d_rows 16384"),
                             ("scan_domain_count", "4e7-Q2",
                              "J1 4e7 Q2, d_rows 16")):
        q = timing[cell]
        nb, npr = q["nb"], q["npr"]
        summary[kernel] = dict(
            max_abs_err=err[kernel], ms=q["ms"], ms_b2b=q["ms_b2b"],
            plain_ms=q["plain_ms"], **bound(8 * (nb + npr) + 16,
                                            4 * (nb + npr)),
            library_ms=q["library_ms"],
            design_floor_ms=bound(16 * nb + 8 * npr + 16, 0)["bound_ms"],
            at=at)
    return summary


def _max_abs(got, want) -> int:
    """Largest |got - want| over two u32 planes or bool masks."""
    import torch
    from flash_hash_join_tpu_torch.utils.u64 import widen
    if got.numel() == 0:
        return 0
    if got.dtype == torch.bool:
        return int((got != want).any())
    return int((widen(got) - widen(want)).abs().max())


def directory_build_keys(name: str, rng) -> np.ndarray:
    """Build keys that stress the range table's bucket directory."""
    if name == "two_ends":             # span 2^64-1 in a table searched whole
        return np.array([M64, 0], np.uint64)
    n = 2_000_000
    bk = rng.integers(0, 2**64, n, dtype=np.uint64)
    if name == "all_equal":                            # span 0
        bk[:] = bk[0]
    elif name == "full_span":                          # shift 64 - p
        bk[[5, 9]] = [0, M64]
    elif name == "crowded":        # 99 % of the keys in one bucket, outliers
        bk[n // 100:] = rng.integers(5, 5 + n, n - n // 100, dtype=np.uint64)
        bk[:2] = [0, M64]
    elif name == "dup_run":                            # a 1e5-row run
        bk[n // 2: n // 2 + 100_000] = bk[3]
    return bk


def directory_reference(bk: np.ndarray, p: int):
    """The bucket directory of build keys from its definition, in numpy:
    (dir, shift), bucket = (key - min) >> shift, shift = max(0,
    bit_length(span) - p), dir[b] = the first sorted index whose bucket is
    at least b."""
    keys = np.sort(bk)
    shift = max(0, (int(keys[-1]) - int(keys[0])).bit_length() - p)
    buckets = (keys - keys[0]) >> np.uint64(shift)
    return (np.searchsorted(buckets, np.arange(2**p + 1, dtype=np.uint64)),
            shift)


def key_planes(x):
    """Sortable int64 keys -> their (hi, lo) int32 bit-pattern planes."""
    import torch
    u = x ^ -2**63
    return ((u >> 32).to(torch.int32).contiguous(),
            (u & 0xFFFFFFFF).to(torch.int32).contiguous())


def k4_flat(table, ph, pl, np_valid: int):
    """K4's 0-level route, forced: the kernel over the probe planes."""
    from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
    with rp.forced(pbits=0):
        return rp.range_probe_materialize(table, ph, pl, np_valid)


def k4_route_sweep(table, x) -> dict:
    """K4's two routes timed (cuda_ms, lone calls): the sweep from which
    ops/cuda/range_probe.plan's threshold was taken.  Two key shapes:
    "j1", tables of 2^20 to 2^25 evenly spaced keys of `table` and the whole
    of it, probed by 2^18 to 2^24 and all of the sortable probe keys x, half
    of them drawn from the table's keys (the rest misses inside its range);
    "u64", tables of 2^22 to 2^24 keys drawn uniformly from the whole u64
    range (a directory bucket's keys far from evenly spread), probed by
    2^20 to 2^24 and len(x) rows, a tenth of them the table's keys and the
    rest uniform u64 keys.  Each row: the shape, the table's keys and bytes,
    the probe rows, the plan's digit bits, and ms for the 0-level K4 and for
    the 1-level route at slice_bits."""
    import torch
    from flash_hash_join_tpu_torch.ops import range_table as rt
    from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
    dev, nb, npr = x.device, table.keys.numel(), x.numel()
    gen = torch.Generator(device=dev).manual_seed(1)
    sweep = []

    def draw(n, high=None):
        return torch.randint(-2**63, 2**63 - 1, (n,), device=dev,
                             generator=gen) if high is None else \
            torch.randint(0, high, (n,), device=dev, generator=gen)

    def timed(shape, keys, values, q, probe_rows):
        n_keys = keys.numel()
        sub = rt.RangeTable(keys, values, *rp.range_directory(
            keys, rp.directory_bits(n_keys)))
        qh, ql = key_planes(q)
        nbytes, p = rp.table_bytes(sub), rp.table_dir_bits(sub)
        for rows in probe_rows:
            row = dict(shape=shape, nb=n_keys, table_bytes=nbytes, npr=rows,
                       plan_pbits=rp._plan(sub, rows, dev).pbits)
            for name, bits in (("flat", 0), ("sliced",
                                              rp.slice_bits(nbytes, p))):
                with rp.forced(pbits=bits):
                    row[f"{name}_ms"] = cuda_ms(
                        lambda: rp.range_probe_materialize(
                            sub, qh[:rows], ql[:rows], rows))
            sweep.append(row)

    for n_keys in (2**20, 2**21, 2**22, 2**23, 2**24, 2**25, nb):
        idx = torch.arange(n_keys, device=dev) * (nb - 1) // (n_keys - 1)
        keys = table.keys[idx]
        q = x.clone()
        q[::2] = keys[draw(q[::2].numel(), n_keys)]
        timed("j1", keys, table.values[idx], q,
              (2**18, 2**20, 2**22, 2**23, 2**24, npr))
        del keys, q
    for n_keys in (2**22, 2**23, 2**24):
        keys = torch.sort(draw(n_keys)).values
        values = draw(2 * n_keys, 2**31).to(torch.int32).view(n_keys, 2)
        q = draw(npr)
        q[::10] = keys[draw(q[::10].numel(), n_keys)]
        timed("u64", keys, values, q,
              (2**20, 2**22, 2**23, 2**24, npr))
        del keys, values, q
    return dict(sweep=sweep, min_table_l2=rp.MIN_TABLE_L2,
                min_probes=rp.MIN_PROBES,
                l2_bytes=torch.cuda.get_device_properties(dev).L2_cache_size)


def phase_partitioned_kernels(cells: dict) -> dict:
    """K3, K4 and K5 == plain on edge and large shapes and on builds that
    stress the directory, on both table layouts; then each timed against
    its plain version on the radix path's J1 1e8 Q5 inputs, and K3/K4 on
    both layouts on small builds."""
    import torch
    from flash_hash_join_tpu_torch.ops import range_table as rt
    from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
    from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
    from flash_hash_join_tpu_torch.utils.u64 import (device_planes, sortable,
                                                     to_device)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    err = {"range_directory": 0, "range_probe_count": 0,
           "range_probe_materialize": 0, "range_probe_sliced": 0,
           "compact": 0}
    layouts_checked = 0
    cases = 0

    def check_compact(mask, cols, n_out):
        nonlocal cases
        count, outs = sc.compact_by_mask(mask, cols, n_out)
        wcount, wouts = sc.compact_by_mask_plain(mask, cols, n_out)
        keep = min(int(wcount), n_out)
        e = max([abs(int(count) - int(wcount))]
                + [_max_abs(o[:keep], w[:keep]) for o, w in zip(outs, wouts)])
        err["compact"] = max(err["compact"], e)
        cases += 1

    def check_directory(keys, bk, p, dtype):
        """The directory kernel against its plain version and numpy's."""
        nonlocal cases
        got = rp.range_directory(keys, p, dtype)
        plain = rp.range_directory_plain(keys, p, dtype)
        want, shift = directory_reference(bk, p)
        err["range_directory"] = max(
            err["range_directory"], int(got[0].dtype != dtype),
            *(int(not torch.equal(g, w)) for g, w in zip(got, plain)),
            int(not np.array_equal(got[0].cpu().numpy(), want)),
            abs(int(got[1]) - shift))
        cases += 1
        return got

    def check_table(bk, probe_sizes):
        """K3, K4 and K5 against their plain versions on one build, the
        table as built and with its other layouts forced (no directory, a
        directory of 2^6 buckets, 64-bit offsets); the directories against
        their plain versions and numpy's.  Probes of each size, half of
        them build keys and a sixth the keys just above those (misses
        inside buckets), the u64-max key among them; aligned and
        misaligned, np_valid < npr."""
        nonlocal cases, layouts_checked
        nb = bk.size
        bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
        kh, kl = device_planes(bk, dev)
        vh, vl = device_planes(bv, dev)
        built = rt.build_range_table(kh, kl, vh, vl, nb, with_values=True)
        tables = [built]
        p = rp.directory_bits(nb)
        if p:
            check_directory(built.keys, bk, p, torch.int32)
            wide = check_directory(built.keys, bk, p, torch.int64)
            tables += [built._replace(dir=None, shift=None),
                       built._replace(dir=wide[0], shift=wide[1])]
        elif nb:
            small = check_directory(built.keys, bk, 6, torch.int32)
            tables.append(built._replace(dir=small[0], shift=small[1]))
        layouts_checked += len(tables)
        for npr in probe_sizes:
            pk = rng.integers(0, 2**64, npr, dtype=np.uint64)
            if nb:
                pk[::2] = rng.choice(bk, pk[::2].size)
                pk[1::6] = pk[::6][:pk[1::6].size] + np.uint64(1)
            pk[: min(npr, 3)] = M64
            ph, pl = device_planes(pk, dev)
            for table, view in itertools.product(
                    tables, (slice(None), slice(1, None))):   # misaligned
                p = (ph[view], pl[view])
                n = p[0].numel()
                for np_valid in {n, max(n - 5, 0)}:
                    got = rp.range_probe_count(table, *p, np_valid)
                    want = rp.range_probe_count_plain(table, *p, np_valid)
                    err["range_probe_count"] = max(
                        err["range_probe_count"], abs(int(got) - int(want)))
                    got = k4_flat(table, *p, np_valid)
                    want = rp.range_probe_materialize_plain(table, *p,
                                                            np_valid)
                    err["range_probe_materialize"] = max(
                        err["range_probe_materialize"],
                        *(_max_abs(g, w) for g, w in zip(got, want)))
                    cases += 2
                    if rp.table_dir_bits(table):    # K4's 1-level route
                        for forced in (dict(pbits=3), dict(
                                pbits=2, pass_rows=n // 3 + 1)):
                            with rp.forced(**forced):
                                sliced = rp.range_probe_materialize(
                                    table, *p, np_valid)
                            err["range_probe_sliced"] = max(
                                err["range_probe_sliced"],
                                *(_max_abs(g, w) for g, w in zip(sliced,
                                                                  want)))
                            cases += 1
                    if (table is built and view == slice(None)
                            and np_valid == n):
                        hit, mvh, mvl = got
                        for n_planes in (2, 3, 4):
                            check_compact(hit, (p[0], p[1], mvh, mvl)[
                                :n_planes], n)
            del ph, pl
        del built, tables, kh, kl, vh, vl

    for nb in (0, 1, 5, 2_000_000):
        bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
        bk[: min(nb, 2)] = M64                         # u64-max key
        dups = min(nb // 2, 1000)                      # duplicate runs
        bk[nb // 2: nb // 2 + dups] = bk[:dups]
        check_table(bk, (0, 7, 30_000_005))
    for name in ("two_ends", "all_equal", "full_span", "crowded",
                 "dup_run"):
        check_table(directory_build_keys(name, rng), (0, 7, 3_000_005))
    # K5 alone, misaligned: edge sizes, sizes around its tile (the first
    # tiles empty, the last ones full), and each call made twice back to
    # back (its look-back scratch starts from zero every call)
    tile = sc.TILE_ROWS
    for n in (0, 7, tile - 1, tile, tile + 1, 3 * tile + 1, 30_000_005):
        bits = rng.random(n + 1) < 0.37
        if 0 < n < 30_000_005:
            bits[1:n // 2 + 1] = False
            bits[n + 1 - n // 3:] = True
        mask = torch.from_numpy(bits).to(dev)[1:]
        cols = [to_device(rng.integers(0, 2**32, n + 1, dtype=np.uint32),
                          dev)[1:] for _ in range(4)]
        for n_planes in (2, 3, 4):
            for _ in range(2):
                check_compact(mask, cols[:n_planes], n)
                check_compact(mask, cols[:n_planes], n // 3)
    torch.cuda.synchronize()
    require(all(e == 0 for e in err.values()), f"kernel != plain: {err}")
    emit("kernels_vs_plain", kernels=list(err), max_abs_err=err, cases=cases,
         table_layouts=layouts_checked,
         tolerance="exact (directories against numpy, counts, hit masks "
                   "and u32 planes)")

    c = cells["1e8-Q5"]
    kh, kl = device_planes(c.build_keys, dev)
    vh, vl = device_planes(c.build_values, dev)
    ph, pl = device_planes(c.probe_keys, dev)
    nb, npr = kh.numel(), ph.numel()
    table = rt.build_range_table(kh, kl, vh, vl, nb, with_values=True)
    del kh, kl, vh, vl
    q5_plan = rp._plan(table, npr, dev)
    require(q5_plan.pbits > 0,
            "K4's plan at J1 1e8 Q5 is not the 1-level route")
    # the plan's route at this shape (its digit bits, one pass of all the
    # rows) against its plain version and against the 0-level K4 and its
    # plain version, bit for bit
    hit, mvh, mvl = rp.range_probe_materialize(table, ph, pl, npr)
    routes = {"sliced_plain": rp.range_probe_sliced_plain(table, ph, pl, npr,
                                                          q5_plan),
              "flat": k4_flat(table, ph, pl, npr),
              "flat_plain": rp.range_probe_materialize_plain(table, ph, pl,
                                                             npr)}
    q5_err = {name: max(_max_abs(g, w) for g, w in zip((hit, mvh, mvl), r))
              for name, r in routes.items()}
    q5_err["flat_vs_plain"] = max(_max_abs(g, w) for g, w in zip(
        routes["flat"], routes["flat_plain"]))
    del routes
    err["range_probe_sliced"] = max(err["range_probe_sliced"],
                                    q5_err["sliced_plain"], q5_err["flat"])
    err["range_probe_materialize"] = max(err["range_probe_materialize"],
                                         q5_err["flat_vs_plain"])
    emit("k4_routes_vs_plain", cell="1e8-Q5", plan=q5_plan._asdict(),
         max_abs_err=q5_err, hits=int(hit.sum()))
    require(all(e == 0 for e in q5_err.values()),
            f"K4's routes differ at J1 1e8 Q5: {q5_err}")
    cols = (ph, pl, mvh, mvl)
    hits = int(hit.sum())
    # library yardsticks, timed here and used nowhere in the port: one
    # searchsorted of the probes' sortable keys (computed beforehand), one
    # searchsorted of the directory's bucket start keys (computed
    # beforehand), and one boolean-mask index of the four planes stacked
    # beforehand
    x, stacked = sortable(ph, pl), torch.stack(cols)
    searched = cuda_ms(lambda: torch.searchsorted(table.keys, x))
    p, shift = rp.directory_bits(nb), int(table.shift)
    lo = int(table.keys[0])
    starts = lo + (torch.arange(((int(table.keys[-1]) - lo) >> shift) + 1,
                                device=dev) << shift)
    library = {"range_directory": cuda_ms(
                   lambda: torch.searchsorted(table.keys, starts)),
               "range_probe_count": searched,
               "range_probe_materialize": searched,
               "range_probe_sliced": searched,
               "compact": cuda_ms(lambda: stacked[:, hit])}
    del stacked, starts
    steps = 3 * (nb.bit_length() + 1) + 4     # per probe: the lower bound
    bounds = {  # the directory: keys read, offsets and shift written; one
                # lower bound of the keys a bucket
              "range_directory": bound(8 * nb + table.dir.numel()
                                       * table.dir.element_size() + 8,
                                       table.dir.numel() * steps),
              "range_probe_count": bound(8 * nb + 8 * npr + 8, npr * steps),
              "range_probe_materialize": bound(16 * nb + 17 * npr,
                                               npr * steps),
              "range_probe_sliced": bound(16 * nb + 17 * npr, npr * steps),
              # the mask, then the hit rows' 4 planes read and written
              "compact": bound(npr + 32 * hits + 8, 6 * npr)}
    runs = {
        "range_directory": (lambda: rp.range_directory(table.keys, p),
                            lambda: rp.range_directory_plain(table.keys, p)),
        "range_probe_count": (
            lambda: rp.range_probe_count(table, ph, pl, npr),
            lambda: rp.range_probe_count_plain(table, ph, pl, npr)),
        "range_probe_materialize": (       # the 0-level K4, forced
            lambda: k4_flat(table, ph, pl, npr),
            lambda: rp.range_probe_materialize_plain(table, ph, pl, npr)),
        "range_probe_sliced": (            # the plan's route here
            lambda: rp.range_probe_materialize(table, ph, pl, npr),
            lambda: rp.range_probe_sliced_plain(table, ph, pl, npr,
                                                q5_plan)),
        "compact": (lambda: sc.compact_by_mask(hit, cols, npr),
                    lambda: sc.compact_by_mask_plain(hit, cols, npr)),
    }
    summary = {}
    for name, (kernel, plain) in runs.items():
        t = paired_ms(kernel, plain)
        summary[name] = dict(max_abs_err=err[name], **best(t), **bounds[name],
                             library_ms=library[name],
                             at="J1 1e8 Q5 (1e8 build x 1e8 probe rows)")
        emit("kernel_time", cell="1e8-Q5", kernel=name, nb=nb, npr=npr, **t,
             **bounds[name], library_ms=library[name])
    summary["range_probe_sliced"].update(
        role="K4's 1-level route: partition, slice probe, restore",
        plan=q5_plan._asdict())
    summary["range_directory"].update(
        role="table build of K3/K4 (not a TPU kernel)",
        dir_entries=table.dir.numel(), shift=shift,
        largest_bucket=int((table.dir[1:] - table.dir[:-1]).max()))

    # the offsets' two widths on the same table and probes: the 32-bit
    # directory as built, and the same offsets as int64 (the layout from
    # 2^31 keys on), K3 and K4 timed in turn
    wide = table._replace(dir=table.dir.to(torch.int64))
    require(int(rp.range_probe_count(wide, ph, pl, npr)) == hits,
            "the 64-bit directory's count differs")
    widths = {}
    for _ in range(2):
        for name, t in (("int32", table), ("int64", wide)):
            widths.setdefault(name, []).append(dict(
                K3_ms=cuda_ms(lambda: rp.range_probe_count(t, ph, pl, npr)),
                K4_ms=cuda_ms(lambda: k4_flat(t, ph, pl, npr))))
    emit("offset_widths", cell="1e8-Q5", **widths)
    del wide

    # the two table layouts on small builds: evenly spaced keys of the Q5
    # build, probed by half the Q5 probes (misses inside the keys' range)
    # and half drawn from those keys; searched whole (no directory, the
    # layout up to rp.SMALL_TABLE keys) and through a directory of the
    # size directory_bits gives larger tables
    gen = torch.Generator(device=dev).manual_seed(0)
    layouts = []
    for n_small in (100, 300, 1_000, 3_000, 10_000, 100_000):
        idx = torch.arange(n_small, device=dev) * (nb - 1) // (n_small - 1)
        keys, values = table.keys[idx], table.values[idx]
        q = x.clone()
        q[::2] = keys[torch.randint(0, n_small, (q[::2].numel(),),
                                    device=dev, generator=gen)]
        qh, ql = key_planes(q)
        p = max(1, (n_small - 1).bit_length() - 2)
        whole = rt.RangeTable(keys, values, None, None)
        directed = rt.RangeTable(keys, values, *rp.range_directory(keys, p))
        row = dict(nb=n_small, p=p)
        for name, t in (("whole", whole), ("directory", directed)):
            got = (int(rp.range_probe_count(t, qh, ql, npr)),
                   *rp.range_probe_materialize(t, qh, ql, npr))
            if name == "whole":
                first = got
            require(got[0] == first[0] and all(torch.equal(g, f) for g, f
                                               in zip(got[1:], first[1:])),
                    f"table layouts disagree at {n_small} keys")
            row[name] = dict(
                K3_ms=cuda_ms(lambda: rp.range_probe_count(t, qh, ql, npr)),
                K4_ms=cuda_ms(lambda: rp.range_probe_materialize(t, qh, ql,
                                                                 npr)))
        row["count"] = first[0]
        layouts.append(row)
        del q, qh, ql, whole, directed, first, got
    emit("table_layouts", npr=npr, small_table=rp.SMALL_TABLE,
         layouts=layouts)
    emit("k4_routes", **k4_route_sweep(table, x))
    del table, x, ph, pl, hit, mvh, mvl, cols
    torch.cuda.empty_cache()
    return summary


def dense_inputs(c, dev):
    """The dense materialize path's kernel inputs for a cell, computed on
    the card as ops/direct_bitmap.direct_join_materialize computes them:
    (v_rows, lo, the occupied slots' bitmap, value planes, probe key
    planes)."""
    from flash_hash_join_tpu_torch.ops import direct_bitmap as db
    from flash_hash_join_tpu_torch.ops import domain_map as dm
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    bk, bv, pk = c.build_keys, c.build_values, c.probe_keys
    v_rows = db.v_rows_for(int(bk.max() - bk.min()) + 1)
    kh, kl = device_planes(bk, dev)
    vh, vl = device_planes(bv, dev)
    ph, pl = device_planes(pk, dev)
    lo, _, bidx, planes = db._dense_value_planes(
        kh, kl, vh, vl, len(bk), v_rows=v_rows,
        narrow_values=int(bv.max()) < 2**32)
    bitmap = dm.pack_bitmap(bidx, max(8, v_rows // 32))
    return v_rows, lo, bitmap, planes, ph, pl


def phase_dense_kernels(cells: dict) -> dict:
    """K7/K8/K9 == plain at every rung, edge sizes and views; then each
    timed against its plain version on the dense_mat cells' inputs."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import (
        dense_domain_keys, offset_plane_views)
    from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
    from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
    from flash_hash_join_tpu_torch.utils.u64 import to_device
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    err = {"probe_gather_bitmap": 0, "probe_gather_staged": 0,
           "materialize_copy": 0}
    cases = 0

    def check(name, got, want):
        nonlocal cases
        err[name] = max(err[name], *(_max_abs(g, w)
                                     for g, w in zip(got, want)))
        cases += 1

    def planes(rows, n):
        return tuple(to_device(rng.integers(0, 2**32, (rows, 128),
                                            dtype=np.uint32), dev)
                     for _ in range(n))

    sizes = (0, 7, 30_000_005)
    for v_rows, lo in ((8, 0), (16, int(rng.integers(1, 2**31))),
                       (64, 2**32 - 1 - 64 * 64), (128, SENTINEL)):
        v_slots = v_rows * 128             # K7, key planes: one lo a rung
        bitmap, = planes(bp.GATHER_D_ROWS, 1)
        vplanes = planes(v_rows, 2)
        lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
        for n in sizes:
            pk = dense_domain_keys(rng, n, lo, v_slots)
            pk[:min(n, 7)] = np.array(     # the domain's edges, u64-max
                [lo, lo + v_slots - 1, lo + v_slots, max(lo, 1) - 1,
                 2**32 + lo, SENTINEL, M64], np.uint64)[:min(n, 7)]
            for shift in ((0, 0), (1, 3)):
                ph, pl = offset_plane_views(pk, dev, *shift)
                for k, npv in ((1, n), (2, max(n - 5, 0))):
                    args = (bitmap, vplanes[:k], ph, pl, npv, lo_t, v_rows)
                    check("probe_gather_bitmap",
                          bp.probe_gather_bitmap(*args),
                          bp.probe_gather_bitmap_domain_plain(*args))
            del pk, ph, pl
    for v_rows in (256, 512, 1024, 2048, 4096, 8192):  # K8, key planes
        v_slots = v_rows * 128
        bitmap, = planes(v_rows // 32, 1)
        vplanes = planes(v_rows, 2)
        for lo in (int(rng.integers(1, 2**31)), 0,
                   2**32 - 1 - v_slots // 2, SENTINEL):
            lo_t = torch.tensor(lo, dtype=torch.int64, device=dev)
            for n in (0, 7, 3_000_005):
                pk = dense_domain_keys(rng, n, lo, v_slots)
                for shift in ((0, 0), (1, 3)):
                    ph, pl = offset_plane_views(pk, dev, *shift)
                    for k, npv in ((1, n), (2, max(n - 5, 0))):
                        args = (bitmap, vplanes[:k], ph, pl, npv, lo_t,
                                v_rows)
                        check("probe_gather_staged",
                              dv.probe_gather_staged(*args),
                              dv.probe_gather_staged_domain_plain(*args))
                del pk, ph, pl
    # K9 also around one of its blocks (4 words a 16-byte load, 4 loads a
    # thread, 256 threads: 4096 words)
    for n in sizes + (4_095, 4_096, 4_097, 8_191, 8_193):
        x = to_device(rng.integers(0, 2**32, n + 3, dtype=np.uint32), dev)
        # aligned, misaligned by 4 and 12 bytes, odd length
        for view in (x[:n], x[1:n + 1], x[3:], x[2:n + 1]):
            check("materialize_copy", (dv.materialize_copy(view),),
                  (dv.materialize_copy_plain(view),))
    torch.cuda.synchronize()
    require(all(e == 0 for e in err.values()), f"kernel != plain: {err}")
    emit("kernels_vs_plain", kernels=list(err), max_abs_err=err, cases=cases,
         tolerance="exact (hit masks and u32 planes)")

    timing = {}
    for name in ("1e7-Q2", "4e7-Q1", "4e7-Q2", "4e7-Q2-wide", "1e8-Q1",
                 "1e8-Q2"):
        v_rows, lo, bitmap, vplanes, ph, pl = dense_inputs(cells[name], dev)
        n, k = ph.numel(), len(vplanes)
        runs = {}
        args = (bitmap, vplanes, ph, pl, n, lo, v_rows)
        if v_rows <= 128:
            runs["probe_gather_bitmap"] = (
                lambda: bp.probe_gather_bitmap(*args),
                lambda: bp.probe_gather_bitmap_domain_plain(*args))
        else:
            runs["probe_gather_staged"] = (
                lambda: dv.probe_gather_staged(*args),
                lambda: dv.probe_gather_staged_domain_plain(*args))
            if name == "1e8-Q2":
                # K9 is on no path: held against its plain version, clone,
                # on a plane of the cell's size (the probes' low words)
                runs["materialize_copy"] = (
                    lambda: (dv.materialize_copy(pl),),
                    lambda: (dv.materialize_copy_plain(pl),))
        # K7, K8: key-plane reads, the occupied slots' bitmap and value
        # planes read once, hit and value writes, lo
        gather = bound(v_rows * 16 + k * v_rows * 512 + 9 * n + 4 * k * n
                       + 8, 6 * n)
        bounds = {"probe_gather_bitmap": gather,
                  "probe_gather_staged": gather,
                  "materialize_copy": bound(8 * n, n)}
        library = {}
        for kernel, (run, plain) in runs.items():
            check(kernel, run(), plain())
            require(err[kernel] == 0, f"{kernel} {name}: kernel != plain")
            # K9's plain version is the library call, torch's clone: timed
            # in turns with the kernel, clone, K9, K9, clone, by both timers
            copy = kernel == "materialize_copy"
            t = paired_ms(run, plain, plain_b2b=copy)
            if copy:
                library[kernel] = min(t["plain_ms"])
                library[kernel + "_b2b"] = min(t["plain_ms_b2b"])
            timing[kernel, name] = dict(**best(t), **bounds[kernel],
                                        library_ms=library.get(kernel))
            if copy:
                timing[kernel, name]["library_ms_b2b"] = library[
                    kernel + "_b2b"]
            emit("kernel_time", cell=name, kernel=kernel, v_rows=v_rows,
                 n_planes=k, npr=n, **t, **bounds[kernel],
                 library_ms=library.get(kernel))
        del lo, bitmap, vplanes, ph, pl, runs, args
        torch.cuda.empty_cache()
    at = {"probe_gather_bitmap": ("1e8-Q1", "J1 1e8 Q1, v_rows 8"),
          "probe_gather_staged": ("1e8-Q2", "J1 1e8 Q2, v_rows 1024"),
          "materialize_copy": ("1e8-Q2", "1e8 words (J1 1e8 Q2's probe "
                                         "plane); on no path")}
    return {k: dict(max_abs_err=err[k], **timing[k, cell], at=where,
                    other_cells={c: timing[k, c] for kk, c in timing
                                 if kk == k and c != cell})
            for k, (cell, where) in at.items()}


def _timed_runs(fn, c, reps: int):
    """A warm-up call, then `reps` timed calls (reps 0: the one call is
    timed); returns (best core, best wall, all core seconds, last
    result)."""
    runs = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        res = fn(c.build_keys, c.build_values, c.probe_keys, device="cuda",
                 return_info=True)
        runs.append((res[1], time.perf_counter() - t0))
    timed = runs[1:] or runs                           # reps 0: the one call
    return (min(r[0] for r in timed), min(r[1] for r in timed),
            [r[0] for r in runs], res)


def phase_main(cells: dict) -> tuple[dict, dict, dict]:
    import torch
    import flash_hash_join_tpu_torch as ft
    expect = {"4e7-Q1": "scan_domain_count", "4e7-Q2": "scan_domain_count",
              "4e7-Q5": "dense_bitmap", "bench-4e7": "dense_bitmap",
              "1e8-Q5": "dense_bitmap"}
    want = {name: int(oracle(name, cells[name])[0].sum()) for name in expect}
    core, counts = {}, {}
    zero_launches()
    for name in expect:
        c = cells[name]
        gate = gate_route(c, "count")
        torch.cuda.reset_peak_memory_stats()
        best, wall, runs, (count, _, info) = _timed_runs(
            ft.adaptive_join_count, c, reps=2)
        require(count == want[name],
                f"{name}: count {count} != oracle {want[name]}")
        require(info["strategy"] == gate and not info["retried"],
                f"{name}: routed {info}, the gate says {gate}")
        if gate != "direct":           # the cell's kernel, by name
            count, _, info = ft.join_count(
                c.build_keys, c.build_values, c.probe_keys,
                strategy="direct", device="cuda", return_info=True)
            require(count == want[name], f"{name} direct: count {count}")
        require(info["launches"][expect[name]] > 0,
                f"{name}: {expect[name]} not launched: {info}")
        core[name], counts[name] = best, count
        emit("main", cell=name, nb=len(c.build_keys), npr=len(c.probe_keys),
             count=count, oracle=want[name], strategy=gate,
             d_rows=info["d_rows"], launches=info["launches"],
             core_seconds=best, probe_rows_per_s=len(c.probe_keys) / best,
             wall_seconds=wall, core_seconds_runs=runs,
             peak_device_bytes=torch.cuda.max_memory_allocated())
    return (require_launched("main", ("dense_bitmap", "scan_domain_count")),
            core, counts)


def gate_route(c, mode: str) -> str:
    """The route the adaptive gates (ops/direct_bitmap.py) decide for a
    cell, which its adaptive call must take."""
    import flash_hash_join_tpu_torch as ft
    return ft.adaptive_strategy(c.build_keys, c.build_values,
                                len(c.probe_keys), mode=mode)


def check_rows(name: str, c, keys, vals, probe_order: bool) -> None:
    hit, want_vals = oracle(name, c)
    want_keys = c.probe_keys[hit]
    if not probe_order:                                # compare sorted pairs
        order, want_order = (np.lexsort((vals, keys)),
                             np.lexsort((want_vals, want_keys)))
        keys, vals = keys[order], vals[order]
        want_keys, want_vals = want_keys[want_order], want_vals[want_order]
    require(np.array_equal(keys, want_keys) and np.array_equal(
        vals, want_vals), f"{name}: materialized rows differ from the oracle")


def api_cell(phase: str, name: str, c, fn_name: str, *, expect: str,
             kernels=(), rows_kw=None, reps: int = 2, **kw) -> dict:
    """Drive one cell through the API function fn_name (with keywords kw):
    timed runs, each count equal to the oracle's, the route `expect` with no
    retry and every kernel of `kernels` launched; with rows_kw, then the
    rows through join_materialize(return_arrays=True, **rows_kw), equal to
    the oracle's in probe order."""
    import functools
    import torch
    import flash_hash_join_tpu_torch as ft
    want = int(oracle(name, c)[0].sum())
    torch.cuda.reset_peak_memory_stats()
    best, wall, runs, (count, _, info) = _timed_runs(
        functools.partial(getattr(ft, fn_name), **kw), c, reps=reps)
    peak = torch.cuda.max_memory_allocated()
    require(count == want, f"{phase} {name} {fn_name}: count {count} != "
            f"oracle {want}")
    require(info["strategy"] == expect and not info["retried"],
            f"{phase} {name} {fn_name}: routed {info}")
    require(all(launched(info["launches"], k) for k in kernels),
            f"{phase} {name} {fn_name}: kernels not launched: {info}")
    if rows_kw is not None:
        count, _, keys, vals = ft.join_materialize(
            c.build_keys, c.build_values, c.probe_keys, device="cuda",
            return_arrays=True, **rows_kw)
        require(count == want, f"{phase} {name}: rows {count} != {want}")
        check_rows(name, c, keys, vals, probe_order=True)
    npr = len(c.probe_keys)
    fields = dict(cell=name, fn=fn_name, fn_kwargs=kw, nb=len(c.build_keys),
                  npr=npr,
                  count=count, oracle=want, strategy=info["strategy"],
                  launches=info["launches"], core_seconds=best,
                  probe_rows_per_s=npr / best, wall_seconds=wall,
                  core_seconds_runs=runs, peak_device_bytes=peak,
                  peak_bytes_per_probe_row=peak / npr)
    emit(phase, **fields)
    return fields


def partitioned_cell(phase: str, name: str, c, fn_name: str,
                     materialize: bool, **kw) -> dict:
    """api_cell on the partitioned tier: K3 for a count; K4 and K5, and the
    rows with the same strategy, for a materialize."""
    if not materialize:
        return api_cell(phase, name, c, fn_name, expect="partitioned",
                        kernels=("range_build", "range_probe_count"), **kw)
    strategy = "adaptive" if fn_name == "adaptive_join" else "partitioned"
    return api_cell(phase, name, c, fn_name, expect="partitioned",
                    kernels=("range_build", K4, "compact"),
                    rows_kw=dict(strategy=strategy), **kw)


def phase_radix(cells: dict) -> dict:
    zero_launches()
    for q in ("Q1", "Q2", "Q5"):
        partitioned_cell("radix", f"1e8-{q}", cells[f"1e8-{q}"],
                         "hash_join_radix", materialize=True)
    partitioned_cell("radix", "1e8-Q5", cells["1e8-Q5"],
                     "hash_join_count_radix", materialize=False)
    return require_launched("radix", ("range_build", "range_directory",
                                      "range_probe_count",
                                      "range_probe_materialize",
                                      "range_probe_sliced", "compact"))


def phase_adaptive(cells: dict) -> dict:
    zero_launches()
    c = cells["uniform-1e7x1e8"]
    partitioned_cell("adaptive", "uniform-1e7x1e8", c, "adaptive_join_count",
                     materialize=False)
    partitioned_cell("adaptive", "uniform-1e7x1e8", c, "adaptive_join",
                     materialize=True)
    return require_launched("adaptive", ("range_directory",
                                         "range_probe_count", K4,
                                         "compact"))


def phase_direct_vs_partitioned(cells: dict, direct_core: dict) -> None:
    for q in ("Q1", "Q2", "Q5"):
        name = f"4e7-{q}"
        f = partitioned_cell("direct_vs_partitioned", name, cells[name],
                             "join_count", materialize=False,
                             strategy="partitioned")
        emit("direct_vs_partitioned_summary", cell=name,
             direct_core_seconds=direct_core[name],
             partitioned_core_seconds=f["core_seconds"],
             partitioned_over_direct=f["core_seconds"] / direct_core[name])


def phase_fallback(c) -> None:
    import flash_hash_join_tpu_torch as ft
    name = "uniform-1e6x1e7"
    want = int(oracle(name, c)[0].sum())
    args = (c.build_keys, c.build_values, c.probe_keys)
    for strategy in ("merge", "partitioned"):
        count, secs, info = ft.join_count(*args, strategy=strategy,
                                          device="cuda", return_info=True)
        require(count == want and info["strategy"] == strategy,
                f"{strategy} count: {count} != oracle {want}, {info}")
        mcount, msecs, keys, vals, minfo = ft.join_materialize(
            *args, strategy=strategy, device="cuda", return_arrays=True,
            return_info=True)
        require(mcount == want and minfo["strategy"] == strategy,
                f"{strategy} materialize: {mcount} != oracle {want}")
        check_rows(name, c, keys, vals, probe_order=strategy != "merge")
        emit("fallback", cell="uniform 1e6 x 1e7, 5% match, 64-bit keys",
             strategy=strategy, count=count, oracle=want,
             core_seconds=secs, probe_rows_per_s=len(c.probe_keys) / secs,
             materialize_core_seconds=msecs,
             materialize_launches=minfo["launches"])


@contextlib.contextmanager
def probe_mapping_calls():
    """Counts the calls of the plain int64 probe mapping (domain_map.
    probe_domain_idx, under every name the package imports it by) on card
    tensors inside the block: yields the list they append to."""
    from flash_hash_join_tpu_torch.ops import domain_map as dm
    from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
    from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
    from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
    calls, mapping, modules = [], dm.probe_domain_idx, (dm, bp, dbm, dv)

    def spy(ph, *args):
        if ph.device.type == "cuda":
            calls.append(ph.numel())
        return mapping(ph, *args)
    for module in modules:
        module.probe_domain_idx = spy
    try:
        yield calls
    finally:
        for module in modules:
            module.probe_domain_idx = mapping


def dense_mat_cell(name: str, c) -> None:
    """Drive one dense cell through adaptive_join (timed), which must take
    the route its gate decides; then through join_materialize(strategy=
    "direct") (timed, unless adaptive went direct) and with
    return_arrays=True, checked against the oracle, K7 or K8 launched and
    no int64 probe mapping on the card; then through strategy=
    "partitioned" beside it."""
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops import direct_bitmap as db
    want = int(oracle(name, c)[0].sum())
    gate = gate_route(c, "materialize")
    torch.cuda.reset_peak_memory_stats()
    with probe_mapping_calls() as calls:
        best, wall, runs, (count, _, info) = _timed_runs(ft.adaptive_join, c,
                                                         reps=2)
        peak = torch.cuda.max_memory_allocated()
        require(count == want, f"dense_mat {name}: count {count} != {want}")
        require(info["strategy"] == gate and not info["retried"],
                f"dense_mat {name}: routed {info}, the gate says {gate}")
        adaptive = dict(core_seconds=best, wall_seconds=wall,
                        core_seconds_runs=runs, strategy=gate)
        if gate != "direct":
            torch.cuda.reset_peak_memory_stats()
            best, wall, runs, (count, _, info) = _timed_runs(
                functools.partial(ft.join_materialize, strategy="direct"),
                c, reps=2)
            peak = torch.cuda.max_memory_allocated()
            require(count == want and info["strategy"] == "direct"
                    and not info["retried"],
                    f"dense_mat {name} direct: {count} != {want}, {info}")
        count, _, keys, vals, minfo = ft.join_materialize(
            c.build_keys, c.build_values, c.probe_keys, strategy="direct",
            device="cuda", return_arrays=True, return_info=True)
    # K7 and K8 map the probe key planes inside the kernel
    require(not calls, f"dense_mat {name}: the int64 probe mapping ran on "
            f"the card ({len(calls)} calls)")
    staged = info["d_rows"] > db.MAT_SCAN_MAX_V_ROWS
    kernels = (("probe_gather_staged",) if staged
               else ("probe_gather_bitmap",)) + ("compact",)
    require(all(info["launches"][k] > 0 for k in kernels),
            f"dense_mat {name}: kernels not launched: {info}")
    # K8 reads the key planes: no copy of probe indices on the path (K9)
    require(info["launches"]["materialize_copy"] == 0,
            f"dense_mat {name}: materialize_copy launched: {info}")
    require(count == want and minfo["strategy"] == "direct"
            and not minfo["retried"], f"dense_mat {name}: rows {minfo}")
    check_rows(name, c, keys, vals, probe_order=True)
    npr = len(c.probe_keys)
    emit("dense_mat", cell=name, fn="join_materialize", strategy="direct",
         nb=len(c.build_keys), npr=npr, count=count, oracle=want,
         v_rows=info["d_rows"], launches=info["launches"], core_seconds=best,
         probe_rows_per_s=npr / best, wall_seconds=wall,
         core_seconds_runs=runs, peak_device_bytes=peak,
         peak_bytes_per_probe_row=peak / npr, adaptive=adaptive)
    part = partitioned_cell("dense_mat", name, c, "join_materialize",
                            materialize=True, strategy="partitioned")
    emit("dense_mat_summary", cell=name, v_rows=info["d_rows"],
         adaptive_route=gate, adaptive_core_seconds=adaptive["core_seconds"],
         direct_core_seconds=best,
         partitioned_core_seconds=part["core_seconds"],
         partitioned_over_direct=part["core_seconds"] / best,
         direct_wall_seconds=wall, partitioned_wall_seconds=part[
             "wall_seconds"], direct_peak_bytes=peak,
         partitioned_peak_bytes=part["peak_device_bytes"])


def phase_dense_mat(cells: dict) -> dict:
    import flash_hash_join_tpu_torch as ft
    zero_launches()
    for name in ("1e7-Q2", "4e7-Q1", "4e7-Q2", "1e8-Q1", "1e8-Q2"):
        dense_mat_cell(name, cells[name])
    # u64 values (two value planes) at the 4e7 Q2 shape: every strategy
    # equals the oracle (merge emits (hash, key) order: sorted pairs)
    name = "4e7-Q2-wide"
    c = cells[name]
    want = int(oracle(name, c)[0].sum())
    for strategy in ("direct", "partitioned", "merge"):
        count, secs, keys, vals, info = ft.join_materialize(
            c.build_keys, c.build_values, c.probe_keys, strategy=strategy,
            device="cuda", return_arrays=True, return_info=True)
        require(count == want and info["strategy"] == strategy
                and not info["retried"], f"{name} {strategy}: {count} != "
                f"{want}, {info}")
        require(strategy != "direct"
                or info["launches"]["probe_gather_staged"] > 0,
                f"{name}: K8 not launched: {info}")
        check_rows(name, c, keys, vals, probe_order=strategy != "merge")
        emit("dense_mat_wide", cell=name, strategy=strategy, count=count,
             oracle=want, v_rows=info["d_rows"], core_seconds=secs,
             launches=info["launches"])
    launches = require_launched("dense_mat", ("probe_gather_bitmap",
                                              "probe_gather_staged",
                                              "compact"))
    require(launches["materialize_copy"] == 0,
            f"dense_mat: materialize_copy launched: {launches}")
    return launches


def bucket_of(keys: np.ndarray) -> np.ndarray:
    """vmem bucket of numpy u64 keys, through the plain torch hash."""
    from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bkp
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    return bkp.probe_buckets(*device_planes(keys, "cpu")).numpy()


def bucket_table_for(bk: np.ndarray, bv: np.ndarray, dev, r_slots: int):
    from flash_hash_join_tpu_torch.ops import bucket_table as bt
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    kh, kl = device_planes(bk, dev)
    vh, vl = device_planes(bv, dev)
    return bt.build_bucket_table(kh, kl, vh, vl, len(bk), r_slots=r_slots,
                                 with_values=True)


def phase_bucket_kernels(cells: dict) -> dict:
    """K10/K11 == plain at every rung, edge sizes and views, and K6 ==
    plain at its edge cases (sizes, views, counts); then each timed against
    its plain version and its library yardstick on the path's own
    inputs."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import (RAGGED_KINDS,
                                                            ragged_counts)
    from flash_hash_join_tpu_torch.ops import bucket_table as bt
    from flash_hash_join_tpu_torch.ops import compact as cp
    from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bkp
    from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    err = {"probe_count_vmem": 0, "probe_materialize_vmem": 0,
           "concat_ragged_blocks": 0}
    cases = 0
    for r_slots in (8, 16, 32, 64, 128, 256, 512):
        # 40 % load from random keys, bucket 0 filled to its last slot
        bk = rng.integers(0, 2**64, int(0.4 * 128 * r_slots), dtype=np.uint64)
        cand = rng.integers(0, 2**64, 400 * r_slots, dtype=np.uint64)
        bk = np.concatenate([bk[bucket_of(bk) != 0],
                             cand[bucket_of(cand) == 0][:r_slots]])
        bk[:2] = M64                                   # u64-max key
        table = bucket_table_for(bk, rng.integers(0, 2**64, bk.size,
                                                  dtype=np.uint64),
                                 dev, r_slots)
        require(int(table.special[3]) == 0
                and bool((table.tk_hi[:, 0] != -1).all()),
                f"r_slots {r_slots}: bucket 0 not full, or rows dropped")
        tables = (table.tk_hi, table.tk_lo)
        values = (table.tv_hi, table.tv_lo)
        # the first launch of each above R 32 alone: the bucket-major copy
        # of the table, K11's keys and values and K10's keys alone
        err["probe_materialize_vmem"] = max(
            err["probe_materialize_vmem"],
            *(_max_abs(g.view(torch.int32), w.view(torch.int32))
              for g, w in zip(bkp.bucket_major(*tables, *values),
                              bkp.bucket_major_plain(*tables, *values))))
        err["probe_count_vmem"] = max(
            err["probe_count_vmem"],
            _max_abs(bkp.bucket_major_keys(*tables).view(torch.int32),
                     bkp.bucket_major_keys_plain(*tables).view(torch.int32)))
        cases += 2
        for npr in (0, 7, 30_000_005):
            pk = rng.integers(0, 2**64, npr + 1, dtype=np.uint64)
            pk[1::2] = rng.choice(bk, pk[1::2].size)
            pk[:4] = M64
            ph, pl = device_planes(pk, dev)
            for view in (slice(0, npr), slice(1, None)):  # misaligned
                p = (ph[view], pl[view])
                for np_valid in {npr, max(npr - 5, 0)}:
                    got = bkp.probe_count_vmem(*tables, *p, np_valid)
                    want = bkp.probe_count_vmem_plain(*tables, *p, np_valid)
                    err["probe_count_vmem"] = max(
                        err["probe_count_vmem"], abs(int(got) - int(want)))
                    args = (*tables, *values, *p, np_valid)
                    err["probe_materialize_vmem"] = max(
                        err["probe_materialize_vmem"],
                        *(_max_abs(g, w) for g, w in zip(
                            bkp.probe_materialize_vmem(*args),
                            bkp.probe_materialize_vmem_plain(*args))))
                    cases += 2
            del ph, pl
    # K6 with 1-4 planes over one block, 520 blocks of 64K words and more
    # than 32 x 132 blocks of 1001 words (each block's source at another
    # 16-byte offset); plane p a view at word offset (off + p) mod 4; counts
    # all empty, all full, random, every residue mod 4, empty and full
    # alternating, and out of range (negative; 2^32 past the block, int32
    # clipped); int32 counts at even offsets, int64 at odd
    gen = torch.Generator(device=dev).manual_seed(3)
    for n_planes in (1, 2, 3, 4):
        for nblocks, block in ((1, 65_536), (520, 65_536), (5_000, 1_001)):
            kinds = [ragged_counts(rng, kind, nblocks, block)
                     for kind in RAGGED_KINDS]
            for off in range(4):
                planes = [torch.randint(
                    -2**31, 2**31, (nblocks * block + (off + p) % 4,),
                    device=dev, dtype=torch.int32,
                    generator=gen)[(off + p) % 4:].view(nblocks, block)
                    for p in range(n_planes)]
                dtype = torch.int64 if off % 2 else torch.int32
                for counts in kinds:
                    total = int(counts.clip(0, block).sum())
                    if dtype == torch.int32:
                        counts = counts.clip(-2**31, 2**31 - 1)
                    counts = torch.from_numpy(counts).to(dtype).to(dev)
                    got_total, got = sc.concat_ragged_blocks(
                        planes, counts, with_total=True)
                    err["concat_ragged_blocks"] = max(
                        err["concat_ragged_blocks"],
                        abs(int(got_total) - total),
                        *(_max_abs(g[:total], w[:total]) for g, w in zip(
                            got, sc.concat_ragged_blocks_plain(planes,
                                                               counts))))
                    cases += 1
                del planes
    torch.cuda.synchronize()
    require(all(e == 0 for e in err.values()), f"kernel != plain: {err}")
    emit("kernels_vs_plain", kernels=list(err), max_abs_err=err, cases=cases,
         tolerance="exact (counts, hit masks and u32 planes)")

    timing = {}
    for name in ("1e8-Q1", "4e7-Q2"):
        c = cells[name]
        r_slots = bt.r_slots_for(len(c.build_keys))
        table = bucket_table_for(c.build_keys, c.build_values, dev, r_slots)
        ph, pl = device_planes(c.probe_keys, dev)
        npr = ph.numel()
        tables = (table.tk_hi, table.tk_lo)
        mat = (*tables, table.tv_hi, table.tv_lo, ph, pl, npr)
        # library yardstick for K10: one torch.isin of the probes' sortable
        # keys (computed beforehand) in the table's non-empty keys
        x = sortable(ph, pl)
        keys = sortable(*tables).view(-1)
        keys = keys[keys != 2**63 - 1]
        ops = npr * (14 + 4 * (r_slots.bit_length() + 1))  # hash + search
        runs = {"probe_count_vmem": (
                    lambda: bkp.probe_count_vmem(*tables, ph, pl, npr),
                    lambda: bkp.probe_count_vmem_plain(*tables, ph, pl, npr),
                    lambda: torch.isin(x, keys),
                    bound(2 * r_slots * 512 + 8 * npr + 8, ops)),
                "probe_materialize_vmem": (
                    lambda: bkp.probe_materialize_vmem(*mat),
                    lambda: bkp.probe_materialize_vmem_plain(*mat), None,
                    bound(4 * r_slots * 512 + 17 * npr, ops))}
        for kernel, (run, plain, lib, bnd) in runs.items():
            got, want = run(), plain()
            e = (abs(int(got) - int(want)) if kernel == "probe_count_vmem"
                 else max(_max_abs(g, w) for g, w in zip(got, want)))
            require(e == 0, f"{kernel} {name}: kernel != plain")
            t = paired_ms(run, plain)
            timing[kernel, name] = dict(
                **best(t), **bnd, library_ms=cuda_ms(lib) if lib else None)
            emit("kernel_time", cell=name, kernel=kernel, r_slots=r_slots,
                 npr=npr, **t, **bnd,
                 library_ms=timing[kernel, name]["library_ms"])
        del table, ph, pl, x, keys, runs, mat, tables
        torch.cuda.empty_cache()

    # K6 on the stream route's inputs at 1e8 rows: 4 planes at 60 % and 5 %
    # hits, 2 planes at 60 %
    n = 100_000_000
    for cell, density, n_planes in (("1e8", 0.6, 4), ("1e8-5%", 0.05, 4),
                                    ("1e8-2-planes", 0.6, 2)):
        mask = torch.rand(n, device=dev, generator=gen) < density
        cols = [torch.randint(-2**31, 2**31, (n,), device=dev,
                              dtype=torch.int32, generator=gen)
                for _ in range(n_planes)]
        planes, counts = cp.stream_blocks(mask, cols, n)
        del mask, cols
        total = int(counts.sum())
        got = sc.concat_ragged_blocks(planes, counts)
        want = sc.concat_ragged_blocks_plain(planes, counts)
        require(max(_max_abs(g[:total], w[:total]) for g, w in zip(got, want))
                == 0, f"concat_ragged_blocks at {cell}: kernel != plain")
        del got, want
        # library yardstick: one boolean-mask index of the stacked planes
        # (stacked, with the mask of each block's prefix, beforehand)
        prefix = (torch.arange(planes[0].shape[1], device=dev)
                  < counts[:, None]).view(-1)
        stacked = torch.stack([p.view(-1) for p in planes])
        t = paired_ms(lambda: sc.concat_ragged_blocks(planes, counts),
                      lambda: sc.concat_ragged_blocks_plain(planes, counts))
        bnd = bound(4 * counts.numel() + 8 * n_planes * total,
                    2 * n_planes * total)
        library_ms = cuda_ms(lambda: stacked[:, prefix])
        timing["concat_ragged_blocks", cell] = dict(
            **best(t), **bnd, library_ms=library_ms)
        emit("kernel_time", cell=f"1e8 rows, {n_planes} planes, "
             f"{density * 100:.0f} % hits", kernel="concat_ragged_blocks",
             nblocks=counts.numel(), total=total, **t, **bnd,
             library_ms=library_ms)
        del planes, counts, prefix, stacked
        torch.cuda.empty_cache()
    at = {"probe_count_vmem": ("1e8-Q1", "J1 1e8 Q1, R 16"),
          "probe_materialize_vmem": ("4e7-Q2", "J1 4e7 Q2, R 512"),
          "concat_ragged_blocks": ("1e8", "1e8 rows, 4 planes, 60 % hits")}
    return {k: dict(max_abs_err=err[k], **timing[k, cell], at=where,
                    other_cells={c: timing[k, c] for kk, c in timing
                                 if kk == k and c != cell})
            for k, (cell, where) in at.items()}


WALKS = ("global_walk_count", "global_walk_materialize")
BUILD = "global_build"


def walk_table(planes, nb: int, cfg, gbits: int, use_bloom: bool,
               pre_shift: int = 0):
    """The global tier's table over card planes (kh, kl, vh, vl), and the
    walk's static arguments."""
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    table = ht.build_table(
        *planes, nb, gbits=gbits, group_size=cfg.group_size,
        overflow_groups=cfg.overflow_groups, with_bloom=use_bloom,
        bloom_k=cfg.bloom_k, pre_shift=pre_shift,
        max_probe_iters=cfg.max_probe_iters)
    return table, dict(gbits=gbits, group_size=cfg.group_size,
                       total_groups=(1 << gbits) + cfg.overflow_groups,
                       use_bloom=use_bloom, bloom_k=cfg.bloom_k,
                       max_iters=cfg.max_probe_iters, pre_shift=pre_shift)


def walk_bound(table, static: dict, npr: int, groups: int, hits: int,
               passed: int, materialize: bool, plan) -> dict:
    """The walk's bound on this run's data: the probe planes (8 B a row),
    the group rows its probes visited (8G B each, at most the key plane),
    the bloom words (8 B a probe, at most the plane), and for materialize
    the matched slots' values (8 B a hit, at most the value plane) and its
    outputs (9 B a row); about 12 integer operations a probe (hash, home,
    tag) and 4G + 4 a group visited.  design_floor_ms, the route's own
    traffic: 0 levels (pbits 0) reads every visited group's row from device
    memory (the table is far larger than L2 at the main path's shapes); 1
    level reads the probe planes twice (count, scatter) and writes 8-byte
    records, 24 B a row, and the walk reads the records, 8 B, and each
    visited row once, at most the plane (materialize: the stage maps, 6 B
    a row, written and read, and the records' answers, 9 B, written and
    read); where the plan prunes (a count with bloom at 1 level): the planes
    read once, 8 B a row, the bloom words narrowed to u32 gathered, at most 4 B
    a row or a group, and the `passed` rows written, 8 B each, then only
    those partitioned and walked, 32 B each, and their visited rows."""
    row, pbits = 8 * static["group_size"], plan.pbits
    rows_once = min(groups * row, table.keys.numel() * 4)
    bloom_once = min(8 * npr, table.bloom.numel() * 8)
    nbytes = 8 * npr + rows_once
    floor = 8 * npr + groups * row if pbits == 0 else 32 * npr + rows_once
    if static["use_bloom"]:
        nbytes += bloom_once
        floor += 8 * npr if pbits == 0 else bloom_once
        if plan.prune:
            floor = (8 * npr + min(4 * npr, 4 * static["total_groups"])
                     + 40 * passed + rows_once)
    if materialize:
        values = min(8 * hits, table.vals.numel() * 4)
        nbytes += values + 9 * npr
        floor += (8 * hits if pbits == 0 else values + 30 * npr) + 9 * npr
    ops = 12 * npr + (4 * static["group_size"] + 4) * groups
    return dict(**bound(nbytes, ops),
                design_floor_ms=bound(floor, 0)["bound_ms"])


def walk_routes(static: dict, npr: int, materialize: bool) -> dict:
    """The walk's routes at a cell, each label -> (ops/cuda/hash_walk.plan's
    overrides, the plan they give): the plan's own, 0 levels, 1 level of
    slices, and for a count with bloom 1 level with the prune forced on
    and off."""
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    props = torch.cuda.get_device_properties(0)
    one = dict(pbits=hw.slice_bits(static["total_groups"],
                                   static["group_size"], static["use_bloom"],
                                   materialize))
    routes = {"plan": {}, "levels0": dict(pbits=0)}
    if static["use_bloom"] and not materialize:
        routes[f"levels1_pbits{one['pbits']}_pruned"] = dict(one, prune=True)
        routes[f"levels1_pbits{one['pbits']}_unpruned"] = dict(one,
                                                               prune=False)
    else:
        routes[f"levels1_pbits{one['pbits']}"] = one
    return {label: (over, hw.plan(
        npr, static["gbits"], static["total_groups"], static["group_size"],
        static["use_bloom"], materialize, l2_bytes=props.L2_cache_size,
        sms=props.multi_processor_count, **over))
        for label, over in routes.items()}


def phase_walk_kernels(cells: dict) -> dict:
    """The global tier's walk kernels (count, materialize) against the
    plain walk on the card, exactly: every case of
    models/workload.global_walk_cases (bloom off and on; crowded chains to
    the last group, max_probe_iters 2, u64-max probes with and without a
    u64-max build key, duplicates, n_valid cut, pre_shift 2, an empty probe
    side, group sizes 1 and 32; the walk's slice edges: chains across a
    slice and to the last group, every probe in one slice, Zipf-1.2
    probes, u64-max probes among partitioned rows, n_valid cut inside a
    pass), on aligned probe planes by the plan's route, and on misaligned
    ones with each route forced (ops/cuda/hash_walk.forced): 0 levels, and
    1 level of 3 digit bits in passes of 1000 rows, with the prune by the
    plan and off; then J1 1e8 Q5 and config #2, bloom off and on, by the
    plan's route: counts, hit masks, value planes and walk statistics, each
    count the oracle's, and each route forced there (walk_routes: a count
    with bloom at 1 level pruned and not) giving the oracle's count and
    the plan's rows.  The
    plan's route timed beside its bound (without bloom also beside the
    plain walk), the count also beside one torch.isin of the sortable keys;
    each route forced timed beside it."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import (
        global_walk_cases, offset_plane_views)
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
    dev = torch.device("cuda")
    err = dict.fromkeys(WALKS, 0)

    def compare(table, static, ph, pl, n_valid, chunk):
        """Kernel against plain on one table and probe side; returns
        (count, groups, longest, bloom passes)."""
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        count = int(hw.global_walk_count(table, ph, pl, n_valid, stats=stats,
                                         **static))
        got = hw.global_walk_materialize(table, ph, pl, n_valid, **static)
        ht.walk_stats.reset()
        want = int(ht.probe_count_plain(table, ph, pl, n_valid,
                                        probe_chunk=chunk, **static))
        plain = ht.walk_stats.read()
        rows = ht.probe_rows_plain(table, ph, pl, n_valid, probe_chunk=chunk,
                                   **static)
        err["global_walk_count"] = max(err["global_walk_count"],
                                       abs(count - want))
        err["global_walk_materialize"] = max(
            err["global_walk_materialize"],
            *(_max_abs(g, w) for g, w in zip(got, rows)))
        groups, longest, passed = stats.tolist()
        require(count == int(got[0].sum()) and (groups, longest, passed) == (
            plain["groups"], plain["longest"], plain["bloom_passed"]),
            f"walk stats or counts: kernel {count, groups, longest, passed}, "
            f"plain {want, plain}")
        return count, groups, longest, passed

    checked = []
    small = {"plan": {}, "levels0": dict(pbits=0),
             "levels1_passes_of_1000": dict(pbits=3, pass_rows=1000),
             "levels1_passes_of_1000_unpruned": dict(pbits=3, pass_rows=1000,
                                                     prune=False)}
    for case in global_walk_cases():
        planes = [*device_planes(case.build_keys, dev),
                  *device_planes(case.build_values, dev)]
        table, static = walk_table(planes, len(case.build_keys), case.cfg,
                                   case.gbits, case.use_bloom,
                                   case.pre_shift)
        for route, offsets in (("plan", (0, 0)), ("levels0", (1, 3)),
                               ("levels1_passes_of_1000", (1, 3)),
                               ("levels1_passes_of_1000_unpruned", (1, 3))):
            ph, pl = offset_plane_views(case.probe_keys, dev, *offsets)
            n_valid = ph.numel() if case.n_valid is None else case.n_valid
            with hw.forced(**small[route]):
                checked.append([case.name, route, offsets, *compare(
                    table, static, ph, pl, n_valid, 256)])
    torch.cuda.synchronize()
    require(all(e == 0 for e in err.values()), f"walk != plain: {err}")
    emit("walk_vs_plain", kernels=list(WALKS), max_abs_err=err,
         tolerance="exact (counts, hit masks, u32 value planes, walk "
         "statistics)", cases=checked)

    cfg, timing = DEFAULT_CONFIG, {}
    for name in ("1e8-Q5", "uniform-1e7x1e8"):
        c = cells[name]
        nb, npr = len(c.build_keys), len(c.probe_keys)
        planes = [*device_planes(c.build_keys, dev),
                  *device_planes(c.build_values, dev)]
        ph, pl = device_planes(c.probe_keys, dev)
        want = int(oracle(name, c)[0].sum())
        keys64, probes64 = sortable(planes[0], planes[1]), sortable(ph, pl)
        library_ms = cuda_ms(lambda: torch.isin(probes64, keys64).sum())
        del keys64, probes64
        for use_bloom in (False, True):
            table, static = walk_table(planes, nb, cfg, cfg.group_bits(nb),
                                       use_bloom)
            count, groups, longest, passed = compare(
                table, static, ph, pl, npr, cfg.probe_chunk)
            require(count == want, f"walk {name}: {count} != oracle {want}")
            chunk = cfg.probe_chunk
            for kernel, fn, plain in (
                    ("global_walk_count", hw.global_walk_count,
                     ht.probe_count_plain),
                    ("global_walk_materialize", hw.global_walk_materialize,
                     ht.probe_rows_plain)):
                mat = kernel.endswith("materialize")
                run = functools.partial(fn, table, ph, pl, npr, **static)
                routes = walk_routes(static, npr, mat)
                _, plan = routes.pop("plan")
                want_rows = run() if mat else None
                forced = {}
                for label, (over, route) in routes.items():
                    with hw.forced(**over):
                        got = run()
                        require(int(got[0].sum() if mat else got) == want
                                and (not mat or all(torch.equal(g, w) for
                                                    g, w in zip(got,
                                                                want_rows))),
                                f"walk {name} {kernel} {label}: != the plan")
                        del got
                        forced[label] = dict(
                            ms=cuda_ms(run), ms_b2b=cuda_ms_b2b(run),
                            prune=route.prune, **walk_bound(table, static, npr, groups, count,
                                         passed, mat, route))
                del want_rows
                # the plain walk (~0.4 s a call) is timed without bloom only
                t = ({"ms": [cuda_ms(run)], "ms_b2b": [cuda_ms_b2b(run)]}
                     if use_bloom else paired_ms(run, functools.partial(
                         plain, table, ph, pl, npr, probe_chunk=chunk,
                         **static)))
                cell = f"{name}{' bloom' if use_bloom else ''}"
                timing[kernel, cell] = dict(
                    **best(t), **walk_bound(table, static, npr, groups, count,
                                            passed, mat, plan),
                    library_ms=library_ms if not mat else None,
                    groups_per_probe=groups / npr, longest=longest,
                    bloom_passed=passed,
                    plan=plan._asdict(), routes=forced)
                emit("kernel_time", cell=cell, kernel=kernel, nb=nb, npr=npr,
                     total_groups=static["total_groups"],
                     runs={k + "_runs": v for k, v in t.items()},
                     **timing[kernel, cell])
            del table
            torch.cuda.empty_cache()
        del planes, ph, pl
        torch.cuda.empty_cache()
    return {k: dict(max_abs_err=err[k], **timing[k, "1e8-Q5"],
                    at="J1 1e8 Q5, 2^25 + 64 groups of 8, no bloom",
                    other_cells={c: timing[k, c] for kk, c in timing
                                 if kk == k and c != "1e8-Q5"})
            for k in WALKS}


TABLE_FIELDS = ("keys", "vals", "bloom", "special")


def table_err(got, want) -> int:
    """0 when two tables are equal plane for plane (torch.equal), else the
    largest |difference| of a u32 word between them."""
    import torch
    return max(0 if torch.equal(getattr(got, f), getattr(want, f))
               else max(1, _max_abs(getattr(got, f), getattr(want, f)))
               for f in TABLE_FIELDS)


def build_bound(nb: int, table, use_bloom: bool) -> dict:
    """The build's bound: the four build planes read once (16 B a row), the
    key and value planes (and the bloom words) written once; about 30
    integer operations a row (hash, home, tag)."""
    nbytes = 16 * nb + 4 * (table.keys.numel() + table.vals.numel())
    if use_bloom:
        nbytes += 8 * table.bloom.numel()
    return bound(nbytes, 30 * nb)


def phase_build_kernels(cells: dict) -> dict:
    """The global tier's build kernel (csrc/hash_build.cu) against the plain
    build (ops/hash_table.build_table_plain) on the card, planes compared
    with torch.equal: every case of models/workload.global_build_cases
    (random keys, duplicates, all keys equal, one large group with
    duplicates, u64-max keys repeated and alone, n_valid cut and 0, an
    empty side, the crowded table, max_probe_iters 2, pre_shift 1-3, group
    sizes 1, 2, 8, 32; the kernel's tile edges: a chain across a tile
    boundary, the last tile through the overflow groups, fewer group bits
    than partition bits, pre_shift 1-3 over two levels, a tile of u64-max
    rows; bloom off and on), three of them on misaligned planes, 1e6 equal
    keys and 1e5 distinct keys homed to one group (oversize tiles, finished
    from device memory; the latter's chain counted as dropped past
    max_probe_iters), those two timed against the plain build; then J1
    1e8 Q5 and config #2, bloom off and on, each timed beside its bound,
    the plain build and one stable torch.sort of the sortable build keys
    (the sort it replaces), with the peak device bytes of a build over its
    planes."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import (
        global_build_cases, homed_keys, offset_plane_views)
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
    dev = torch.device("cuda")
    err, checked = 0, []

    def compare(name, bk, bv, n_valid, kw, offsets=(0, 0)):
        """Checks the kernel's table against the plain build's; returns
        the two builds on the card planes."""
        nonlocal err
        planes = [*offset_plane_views(bk, dev, *offsets),
                  *offset_plane_views(bv, dev, *offsets)]
        got = ht.build_table(*planes, n_valid, **kw)
        e = table_err(got, ht.build_table_plain(*planes, n_valid, **kw))
        err = max(err, e)
        checked.append([name, list(offsets), e, int(got.special[3])])
        return (functools.partial(ht.build_table, *planes, n_valid, **kw),
                functools.partial(ht.build_table_plain, *planes, n_valid,
                                  **kw))

    cases = global_build_cases()
    for case in cases:
        compare(case.name, case.build_keys, case.build_values,
                case.valid_rows(), case.build_kwargs())
    for case in cases:
        if case.name in ("random", "one_large_group_bloom",
                         "n_valid_cut_bloom"):
            compare(case.name, case.build_keys, case.build_values,
                    case.valid_rows(), case.build_kwargs(), (1, 3))
    rng = np.random.default_rng(17)
    timing = {}
    bk = np.full(1_000_000, 987654321, np.uint64)
    oversize = {"all_equal_1e6": compare(
        "all_equal_1e6", bk, np.arange(bk.size, dtype=np.uint64), bk.size,
        dict(gbits=17, group_size=8, overflow_groups=64, with_bloom=True,
             max_probe_iters=256))}
    bk = rng.permutation(homed_keys(rng, 100_000, 4, 0, {9}))
    oversize["homed_1e5"] = compare(
        "homed_1e5", bk, np.arange(bk.size, dtype=np.uint64), bk.size,
        dict(gbits=4, group_size=32, overflow_groups=4_000, with_bloom=True,
             max_probe_iters=256))
    require(checked[-1][3] == 100_000 - 256 * 32,
            f"homed_1e5: {checked[-1][3]} rows counted as dropped")
    for name, (kernel, plain) in oversize.items():
        timing[name] = best(paired_ms(kernel, plain))
    del oversize
    torch.cuda.synchronize()
    require(err == 0, f"build kernel != plain build: {checked}")
    emit("build_vs_plain", kernel="global_build_table", max_abs_err=err,
         tolerance="exact (torch.equal of keys, vals, bloom, special)",
         cases=checked)

    cfg = DEFAULT_CONFIG
    for name in ("1e8-Q5", "uniform-1e7x1e8"):
        c = cells[name]
        nb = len(c.build_keys)
        planes = [*device_planes(c.build_keys, dev),
                  *device_planes(c.build_values, dev)]
        keys64 = sortable(planes[0], planes[1])
        sort_ms = cuda_ms(lambda: torch.sort(keys64, stable=True))
        del keys64
        for use_bloom in (False, True):
            kw = dict(gbits=cfg.group_bits(nb), group_size=cfg.group_size,
                      overflow_groups=cfg.overflow_groups,
                      with_bloom=use_bloom, bloom_k=cfg.bloom_k,
                      max_probe_iters=cfg.max_probe_iters)
            kernel = functools.partial(ht.build_table, *planes, nb, **kw)
            plain = functools.partial(ht.build_table_plain, *planes, nb, **kw)
            peak = {}
            for which, fn in (("kernel", kernel), ("plain", plain)):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak[which] = torch.cuda.max_memory_allocated() - base
            got, want = kernel(), plain()
            e = table_err(got, want)
            err = max(err, e)
            require(e == 0, f"build {name} bloom={use_bloom}: != plain")
            drops = int(got.special[3])
            table_bound = build_bound(nb, got, use_bloom)
            del got, want
            torch.cuda.empty_cache()
            t = paired_ms(kernel, plain)
            cell = f"{name}{' bloom' if use_bloom else ''}"
            timing[cell] = dict(**best(t), **table_bound, sort_ms=sort_ms,
                                library_ms=None, drops=drops,
                                peak_device_bytes=peak["kernel"],
                                plain_peak_device_bytes=peak["plain"])
            emit("kernel_time", cell=cell, kernel="global_build_table",
                 nb=nb, total_groups=(1 << kw["gbits"]) + cfg.overflow_groups,
                 runs={k + "_runs": v for k, v in t.items()}, **timing[cell])
            torch.cuda.empty_cache()
        del planes
        torch.cuda.empty_cache()
    return {"global_build": dict(
        max_abs_err=err, **timing["1e8-Q5"],
        at="J1 1e8 Q5, 2^25 + 64 groups of 8, no bloom",
        other_cells={c: t for c, t in timing.items() if c != "1e8-Q5"})}


def phase_range_build(cells: dict) -> dict:
    """The partitioned table build's kernels == their plain version (the
    torch.sort build), bit for bit, with values and without, on
    models/workload.range_build_cases and the build sides of J1 4e7 and
    1e8 Q5, each with the passes the card took (ops/cuda/range_build.
    device_plan), which must be the plan of the keys' varying bits; then
    timed against the plain build and one stable torch.sort of the
    sortable keys (library_ms) on J1 1e8 Q5's build side."""
    import torch
    from flash_hash_join_tpu_torch.models.workload import range_build_cases
    from flash_hash_join_tpu_torch.ops.cuda import range_build as rb
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
    cases = [(c.name, c.build_keys, c.build_values, c.nb_valid)
             for c in range_build_cases()]
    cases += [(q, cells[q].build_keys, cells[q].build_values,
               len(cells[q].build_keys)) for q in ("4e7-Q5", "1e8-Q5")]
    err = 0
    for name, bk, bv, nb in cases:
        planes = [*device_planes(bk, "cuda"), *device_planes(bv, "cuda")]
        for with_values in (True, False):
            got = rb.range_build(*planes, nb, with_values=with_values)
            want = rb.range_build_plain(*planes, nb, with_values=with_values)
            same = torch.equal(got[0], want[0]) and (
                not with_values or torch.equal(got[1], want[1]))
            err += not same
            if nb:
                keys = bk[:nb]
                want_plan = rb.plan(int(np.bitwise_or.reduce(keys)
                                        ^ np.bitwise_and.reduce(keys)),
                                    with_values)
                plan = rb.device_plan(*planes, nb, with_values=with_values)
                err += plan != want_plan
                emit("range_build", case=name, rows=nb,
                     with_values=with_values, passes=plan.passes,
                     digits=list(plan.digits),
                     record_bytes=plan.record_bytes, equal=same)
            del got, want
        del planes
        torch.cuda.empty_cache()
    require(err == 0, f"range_build: {err} builds differ from the plain "
            "build or from their plan")
    c = cells["1e8-Q5"]
    n = len(c.build_keys)
    planes = [*device_planes(c.build_keys, "cuda"),
              *device_planes(c.build_values, "cuda")]
    timing = {}
    for with_values in (True, False):
        t = paired_ms(functools.partial(rb.range_build, *planes, n,
                                        with_values=with_values),
                      functools.partial(rb.range_build_plain, *planes, n,
                                        with_values=with_values))
        cell = "materialize" if with_values else "count"
        timing[cell] = dict(
            **best(t), **bound((32 if with_values else 16) * n, 0),
            library_ms=cuda_ms(lambda: torch.sort(sortable(*planes[:2]),
                                                  stable=True)))
        emit("kernel_time", cell=f"1e8-Q5 {cell}", kernel="range_build",
             nb=n, runs={k + "_runs": v for k, v in t.items()},
             **timing[cell])
    del planes
    torch.cuda.empty_cache()
    return {"range_build": dict(
        max_abs_err=err, **timing["materialize"],
        at="J1 1e8 Q5's build side, with values",
        other_cells={"count": timing["count"]})}


def phase_vmem(cells: dict) -> dict:
    """The explicit vmem tier: J1 1e8 Q1 (R 16) and 4e7 Q2 (R 512) count
    and materialize, exact, no retry, K10 or K11 + K5; then a build of 1e6
    keys, past the tier's 64K slots, which must rerun on merge, exact."""
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops import bucket_table as bt
    zero_launches()
    for name in ("1e8-Q1", "4e7-Q2"):
        c = cells[name]
        for fn, kernels, rows_kw in (
                ("join_count", ("probe_count_vmem",), None),
                ("join_materialize", ("probe_materialize_vmem", "compact"),
                 dict(strategy="vmem"))):
            f = api_cell("vmem", name, c, fn, expect="vmem", kernels=kernels,
                         rows_kw=rows_kw, strategy="vmem")
            emit("vmem_rung", cell=name, fn=fn,
                 r_slots=bt.r_slots_for(f["nb"]))
    name = "uniform-1e6x1e7"
    c = cells[name]
    want = int(oracle(name, c)[0].sum())
    args = (c.build_keys, c.build_values, c.probe_keys)
    count, secs, info = ft.join_count(*args, strategy="vmem", device="cuda",
                                      return_info=True)
    mcount, msecs, keys, vals, minfo = ft.join_materialize(
        *args, strategy="vmem", device="cuda", return_arrays=True,
        return_info=True)
    for i in (info, minfo):
        require(i["retried"] and i["strategy"] == "merge",
                f"vmem overflow cell: routed {i}")
    require(count == mcount == want, f"vmem overflow: {count}, {mcount} "
            f"!= oracle {want}")
    check_rows(name, c, keys, vals, probe_order=False)
    emit("vmem_overflow", cell=name, count=count, oracle=want,
         retried=info["retried"], strategy=info["strategy"],
         core_seconds=secs, materialize_core_seconds=msecs,
         launches=minfo["launches"])
    return require_launched("vmem", ("probe_count_vmem",
                                     "probe_materialize_vmem", "compact"))


def global_split(name: str, c) -> None:
    """Device time of the global count's two halves on a cell, with and
    without bloom: the table build and the probe walk (CUDA events)."""
    import torch
    from flash_hash_join_tpu_torch import engine
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    dev = torch.device("cuda")
    planes = [*device_planes(c.build_keys, dev),
              *device_planes(c.build_values, dev)]
    ph, pl = device_planes(c.probe_keys, dev)
    nb, npr = len(c.build_keys), len(c.probe_keys)
    cfg = engine.DEFAULT_CONFIG
    for use_bloom in (False, True):
        def build():
            return engine._global_table(*planes, nb, cfg, cfg.group_bits(nb),
                                        use_bloom)
        build_ms = cuda_ms(build, reps=3)
        table, static = build()
        probe_ms = cuda_ms(lambda: ht.probe_count(table, ph, pl, npr,
                                                  **static), reps=3)
        emit("global_split", cell=name, use_bloom=use_bloom,
             build_ms=build_ms, probe_ms=probe_ms,
             table_bytes=table.keys.numel() * 8,
             total_groups=static["total_groups"])
        del table
    torch.cuda.empty_cache()


def phase_global(cells: dict) -> dict:
    """The global tier (hash_join_count[_bloom], hash_join[_bloom]) on J1
    1e8 Q5 and config #2: exact, no retry, bloom and no bloom agreeing,
    the walk kernel launched once on every call (count or materialize),
    with each function's walk statistics (groups a probe, the longest
    walk), and the count's build and probe device times."""
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    zero_launches()
    for name in ("1e8-Q5", "uniform-1e7x1e8"):
        global_split(name, cells[name])
        counts = {}
        for fn in ("hash_join_count", "hash_join_count_bloom", "hash_join",
                   "hash_join_bloom"):
            count_fn = fn.startswith("hash_join_count")
            walk = WALKS[0] if count_fn else WALKS[1]
            rows_kw = (None if count_fn else
                       dict(strategy="global", use_bloom=fn.endswith("bloom")))
            ht.walk_stats.reset()
            f = api_cell("global", name, cells[name], fn, expect="global",
                         kernels=(BUILD, walk) if count_fn
                         else (BUILD, walk, "compact"),
                         rows_kw=rows_kw, reps=1)
            for k in (BUILD, walk):
                require(f["launches"][k] == 1, f"global {name} {fn}: {k} "
                        f"launched {f['launches'][k]} times in one call")
            counts[fn] = f["count"]
            emit("global_walk", cell=name, fn=fn, **ht.walk_stats.read())
        require(len(set(counts.values())) == 1,
                f"global {name}: bloom and no bloom disagree: {counts}")
    return require_launched("global", (BUILD, *WALKS, "compact"))


def phase_stream_compact(cells: dict) -> dict:
    """FHJ_COMPACT=stream: hash_join_radix on J1 1e8 Q2 and join_materialize
    (strategy="direct") on J1 1e8 Q1 compact through the blockwise sort and
    K6;
    their rows equal the oracle's in probe order, as phases radix and
    dense_mat found for the K5 route."""
    import os
    zero_launches()
    os.environ["FHJ_COMPACT"] = "stream"
    api_cell("stream_compact", "1e8-Q2", cells["1e8-Q2"], "hash_join_radix",
             expect="partitioned",
             kernels=("range_probe_materialize", "concat_ragged_blocks"),
             rows_kw=dict(strategy="partitioned"), reps=1)
    api_cell("stream_compact", "1e8-Q1", cells["1e8-Q1"], "join_materialize",
             expect="direct",
             kernels=("probe_gather_bitmap", "concat_ragged_blocks"),
             rows_kw=dict(strategy="direct"), reps=1, strategy="direct")
    del os.environ["FHJ_COMPACT"]
    launches = require_launched("stream_compact", ("concat_ragged_blocks",))
    require(launches["compact"] == 0,
            f"stream_compact: K5 launched under FHJ_COMPACT=stream: {launches}")
    return launches


@contextlib.contextmanager
def planned_chunks(nb: int, npr: int, mode: str, chunks: int):
    """Patch the planner's budget (api.hbm_budget_bytes) to one under
    which models/cost.py plans `chunks` probe chunks for this shape: the
    build side and a chunk of ceil(npr / chunks) rows in the depth-2
    pipeline, with the sliced probe's scratch of a chunk where its plan
    takes that route (chunks 1: the card's own budget)."""
    from flash_hash_join_tpu_torch import api
    from flash_hash_join_tpu_torch.models import cost
    real = api.hbm_budget_bytes
    budget = real("cuda")
    if chunks > 1:
        fixed, per_row, pipelined = cost.footprint(nb, mode)
        rows = -(-npr // chunks)
        budget = (fixed + rows * (per_row + pipelined)
                  + cost.probe_scratch_bytes(nb, rows, mode))
    require(cost.plan_probe_chunks(nb, npr, mode, budget) == chunks,
            f"{mode} {nb} x {npr}: a budget of {budget} B does not plan "
            f"{chunks} chunks")
    api.hbm_budget_bytes = lambda dev: budget
    try:
        yield budget
    finally:
        api.hbm_budget_bytes = real


@contextlib.contextmanager
def chunk_overlap(on: bool):
    """FHJ_CHUNK_OVERLAP unset (the depth-2 pipeline) or "0" (serial)."""
    if on:
        yield
        return
    os.environ["FHJ_CHUNK_OVERLAP"] = "0"
    try:
        yield
    finally:
        del os.environ["FHJ_CHUNK_OVERLAP"]


def config3_case():
    """BASELINE.json config #3 and its oracle: uniform_case puts the
    misses in [2^62, 2^63) and draws the hits from the build keys, so the
    count is the number of probe keys below 2^62 and the rows are those
    keys in probe order, each with the value of the minimum build row of
    its key (np.searchsorted of the hits alone; the sorted oracle() over
    1e9 keys would take minutes)."""
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    t0 = time.perf_counter()
    c = uniform_case(10_000_000, 1_000_000_000, 0.05)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    keys = c.probe_keys[c.probe_keys < 2**62]
    uniq, first = np.unique(c.build_keys, return_index=True)
    order = np.argsort(keys)              # sorted searches, as in oracle()
    pos = np.empty_like(order)
    pos[order] = np.searchsorted(uniq, keys[order])
    require(np.array_equal(uniq[pos], keys), "config #3: a hit key is not "
            "a build key")
    vals = c.build_values[first[pos]]
    return c, keys, vals, gen_s, time.perf_counter() - t0


def event_seconds(fn, reps: int = 3):
    """A warm-up call of fn(), then `reps` calls each between two CUDA
    events, the window closed after fn's result is read on the host (as
    api._timed closes it); returns (best seconds, all seconds, result)."""
    import torch
    fn()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 1e3)
    return min(runs), runs, res


def config3_resident(c, want: int) -> dict:
    """Config #3's count with the table built once: its planes put on the
    card once, then ops.range_table.range_join_count_chunked at 1, 4 and
    16 chunks over the resident probe planes, a warm-up and the best of 3
    CUDA-event timings each; and the table build alone, timed the same
    way.  Each call: count == oracle, K3 launched once a chunk, the
    directory once.  Returns {n_chunks: best seconds, "build": seconds}."""
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops import range_table as rt
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    nb, npr = len(c.build_keys), len(c.probe_keys)
    t0 = time.perf_counter()
    planes = (*device_planes(c.build_keys, "cuda"),
              *device_planes(c.build_values, "cuda"),
              *device_planes(c.probe_keys, "cuda"))
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    out = {}
    for n_chunks in (1, 4, 16):
        torch.cuda.reset_peak_memory_stats()
        before = ft.launch_counts()
        best, runs, count = event_seconds(lambda: int(
            rt.range_join_count_chunked(*planes, nb, npr,
                                        n_chunks=n_chunks)[0]))
        calls = len(runs) + 1                           # and the warm-up
        after = ft.launch_counts()
        k3 = after["range_probe_count"] - before["range_probe_count"]
        dirs = after["range_directory"] - before["range_directory"]
        require(count == want, f"config3 resident {n_chunks} chunks: count "
                f"{count} != oracle {want}")
        require(k3 == n_chunks * calls and dirs == calls,
                f"config3 resident {n_chunks} chunks: {k3} K3 launches and "
                f"{dirs} directory builds in {calls} calls")
        out[n_chunks] = best
        emit("config3_resident", n_chunks=n_chunks, nb=nb, npr=npr,
             count=count, oracle=want, core_seconds=best,
             core_seconds_runs=runs, probe_rows_per_s=npr / best,
             k3_launches_per_call=k3 // calls,
             directory_builds_per_call=dirs // calls,
             planes_h2d_seconds=h2d_s,
             peak_allocated_per_probe_row=(
                 torch.cuda.max_memory_allocated() / npr),
             peak_reserved_per_probe_row=(
                 torch.cuda.max_memory_reserved() / npr))
    out["build"], runs, _ = event_seconds(lambda: int(rt.build_range_table(
        *planes[:4], nb, with_values=False).keys[-1]))
    emit("config3_resident", table_build_core_seconds=out["build"],
         core_seconds_runs=runs, nb=nb)
    del planes
    torch.cuda.empty_cache()
    return out


def config3_prune(c) -> dict:
    """The prune kernel (hw.global_prune) against its plain version
    (ops/hash_table.prune_plain) on one pass of config #3 on the card: the
    table of the 1e7 build rows with bloom (2^22 + 64 groups of 8), the
    first PASS_ROWS probe rows.  Exactly: the survivors as a sorted
    multiset, the u64-max rows' count and stats[2] the survivors' number;
    one launch a call.  Timed beside the plain prune (paired_ms) and beside
    its bound on this run's bytes: the planes read once, 8 B a row, and
    the survivors written, 8 B each; about 12 integer operations a row
    (hash, home group, tag)."""
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG as cfg
    from flash_hash_join_tpu_torch.utils.u64 import device_planes, sortable
    dev = torch.device("cuda")
    nb, n = len(c.build_keys), hw.PASS_ROWS
    planes = [*device_planes(c.build_keys, dev),
              *device_planes(c.build_values, dev)]
    table, static = walk_table(planes, nb, cfg, cfg.group_bits(nb), True)
    del planes
    ph, pl = device_planes(c.probe_keys[:n], dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    before = ft.launch_counts()["global_prune"]
    sh, sl, rows, count = hw.global_prune(table, ph, pl, n, stats=stats,
                                          **static)
    require(ft.launch_counts()["global_prune"] - before == 1,
            "prune: not one launch a call")
    kept = int(rows[1])
    got = torch.sort(sortable(sh[:kept], sl[:kept])).values
    del sh, sl
    psh, psl, max_hits = ht.prune_plain(table, ph, pl, n, **static)
    want = torch.sort(sortable(psh, psl)).values
    del psh, psl
    require(int(rows[0]) == 0 and torch.equal(got, want)
            and int(count) == int(max_hits) and int(stats[2]) == kept,
            f"prune != plain: {kept} survivors against {want.numel()}, "
            f"u64-max {int(count)} against {int(max_hits)}, stats[2] "
            f"{int(stats[2])}")
    del got, want
    t = paired_ms(
        lambda: hw.global_prune(table, ph, pl, n, **static),
        lambda: ht.prune_plain(table, ph, pl, n, **static))
    out = dict(max_abs_err=0, **best(t), **bound(8 * n + 8 * kept, 12 * n),
               survivors=kept, survivor_share=kept / n,
               at=f"config #3, the first pass of {n} probe rows, "
                  f"2^{static['gbits']} + {cfg.overflow_groups} groups of "
                  f"{cfg.group_size}, bloom_k {cfg.bloom_k}")
    emit("kernel_time", cell="config3 pass", kernel="global_prune", nb=nb,
         npr=n, total_groups=static["total_groups"],
         runs={k + "_runs": v for k, v in t.items()}, **out)
    del table, ph, pl
    torch.cuda.empty_cache()
    return out


def config3_bloom(c, want: int) -> None:
    """hash_join_count_bloom on config #3: a warm-up and 2 timed calls,
    the count held to the oracle, the route global with bloom and the
    prune launched; the walk statistics of the three calls."""
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    npr = len(c.probe_keys)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ht.walk_stats.reset()
    best, wall, runs, (count, _, info) = _timed_runs(ft.hash_join_count_bloom,
                                                     c, reps=2)
    stats = ht.walk_stats.read()
    require(count == want, f"config3 bloom: count {count} != oracle {want}")
    require(info["strategy"] == "global" and info["use_bloom"]
            and not info["retried"] and info["launches"]["global_prune"] > 0,
            f"config3 bloom: routed {info}")
    emit("config3_bloom", count=count, oracle=want, core_seconds=best,
         core_seconds_runs=runs, wall_seconds=wall,
         probe_rows_per_s=npr / best, launches=info["launches"],
         walk_groups=stats["groups"], walk_longest=stats["longest"],
         bloom_passed=stats["bloom_passed"], probes=stats["probes"],
         bloom_passed_share=stats["bloom_passed"] / stats["probes"],
         peak_allocated_per_probe_row=(
             torch.cuda.max_memory_allocated() / npr))
    torch.cuda.empty_cache()


def phase_config3() -> dict:
    """BASELINE.json config #3, 1e7 x 1e9 at 5 % match (64-bit keys, so
    partitioned): adaptive_join_count and join_materialize(return_arrays=
    True), each at the card's own budget (one chunk) and with the budget
    patched to plan 4 chunks, streamed both ways (the depth-2 pipeline and
    FHJ_CHUNK_OVERLAP=0); a warm-up and 2 calls a run, then one serial
    call.  Count and rows equal the oracle, probe_chunks as planned, no
    merge retry, K3 or K4 and K5 launched.  First config3_prune (its
    summary is returned beside the phase's launches), then
    config3_resident and config3_bloom.  The data is made here and freed
    after."""
    import torch
    import flash_hash_join_tpu_torch as ft
    c, want_keys, want_vals, gen_s, oracle_s = config3_case()
    want = len(want_keys)
    nb, npr = len(c.build_keys), len(c.probe_keys)
    emit("config3_data", nb=nb, npr=npr, oracle=want, generate_seconds=gen_s,
         oracle_seconds=oracle_s)
    torch.cuda.empty_cache()
    zero_launches()
    prune = config3_prune(c)
    out = {}
    for mode, fn, kernels in (
            ("count", ft.adaptive_join_count, ("range_probe_count",)),
            ("materialize", functools.partial(ft.join_materialize,
                                              return_arrays=True),
             (K4, "compact"))):
        for chunks in (1, 4):
            with planned_chunks(nb, npr, mode, chunks) as budget:
                for overlap in ((True,) if chunks == 1 else (True, False)):
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    with chunk_overlap(overlap):
                        best, wall, runs, res = _timed_runs(
                            fn, c, reps=2 if overlap else 0)
                    count, info = res[0], res[-1]
                    require(count == want, f"config3 {mode} {chunks}: count "
                            f"{count} != oracle {want}")
                    require(info["probe_chunks"] == chunks
                            and info["strategy"] == "partitioned"
                            and not info["retried"],
                            f"config3 {mode} {chunks}: routed {info}")
                    require(all(launched(info["launches"], k)
                                for k in kernels),
                            f"config3 {mode}: kernels not launched: {info}")
                    if mode == "materialize":
                        require(np.array_equal(res[2], want_keys)
                                and np.array_equal(res[3], want_vals),
                                f"config3 {chunks} chunks: rows differ from "
                                "the oracle")
                    out[mode, chunks, overlap] = best
                    emit("config3", mode=mode, probe_chunks=chunks,
                         overlap=overlap, budget_bytes=budget, count=count,
                         oracle=want, core_seconds=best,
                         core_seconds_runs=runs, wall_seconds=wall,
                         probe_rows_per_s=npr / best,
                         launches=info["launches"],
                         peak_allocated_per_probe_row=(
                             torch.cuda.max_memory_allocated() / npr),
                         peak_reserved_per_probe_row=(
                             torch.cuda.max_memory_reserved() / npr))
    resident = config3_resident(c, want)
    config3_bloom(c, want)
    for mode in ("count", "materialize"):
        extra = ({"resident_chunked_core_seconds": resident[4],
                  "resident_table_build_core_seconds": resident["build"]}
                 if mode == "count" else {})
        emit("config3_summary", mode=mode,
             single_shot_core_seconds=out[mode, 1, True],
             streamed_core_seconds=out[mode, 4, True],
             streamed_serial_core_seconds=out[mode, 4, False], **extra,
             note="streamed core with the overlap is the loop's wall time, "
                  "host->device copies included; serial is the sum of the "
                  "chunks' CUDA-event times; resident: the table built once "
                  "over probe planes already on the card")
    del c, want_keys, want_vals
    torch.cuda.empty_cache()
    return prune, require_launched("config3", (
        "range_directory", "range_probe_count", K4, "compact",
        "global_prune"))


def phase_stream_direct(cells: dict, main_counts: dict,
                        direct_core: dict) -> dict:
    """J1 1e8 Q5 adaptive_join_count with the budget patched to plan 4
    chunks: each chunk runs the route the gates decide for its rows (direct:
    K1 once a chunk), and the count equals the main phase's single shot."""
    import flash_hash_join_tpu_torch as ft
    name = "1e8-Q5"
    c = cells[name]
    nb, npr = len(c.build_keys), len(c.probe_keys)
    zero_launches()
    core = {}
    with planned_chunks(nb, npr, "count", 4):
        gate = gate_route(c, "count")
        kernel = "dense_bitmap" if gate == "direct" else "range_probe_count"
        for overlap in (True, False):
            with chunk_overlap(overlap):
                best, wall, runs, (count, _, info) = _timed_runs(
                    ft.adaptive_join_count, c, reps=2)
            require(count == main_counts[name],
                    f"stream_direct: {count} != main's {main_counts[name]}")
            require(info["strategy"] == gate and not info["retried"]
                    and info["probe_chunks"] == 4
                    and info["launches"][kernel] == 4,
                    f"stream_direct: routed {info}, the gate says {gate}")
            core[overlap] = best
            emit("stream_direct", cell=name, overlap=overlap, count=count,
                 probe_chunks=4, d_rows=info["d_rows"],
                 launches=info["launches"], core_seconds=best,
                 core_seconds_runs=runs, wall_seconds=wall)
    emit("stream_direct_summary", cell=name,
         single_shot_core_seconds=direct_core[name],
         streamed_core_seconds=core[True],
         streamed_serial_core_seconds=core[False])
    return require_launched("stream_direct", (kernel,))


def phase_measure(cells: dict, direct_core: dict) -> dict:
    """measure_device_seconds on bench.py's 4e7 cell and J1 1e8 Q5: the
    oracle's count, chained False, 0 < device_seconds <= the single call's,
    beside the main phase's best core; the kernel of the route the gates
    decide (direct: K1) launched."""
    import flash_hash_join_tpu_torch as ft
    zero_launches()
    kernels = set()
    for name in ("bench-4e7", "1e8-Q5"):
        c = cells[name]
        kernels.add("dense_bitmap" if gate_route(c, "count") == "direct"
                    else "range_probe_count")
        want = int(oracle(name, c)[0].sum())
        count, dev_s, single, chained = ft.measure_device_seconds(
            c.build_keys, c.build_values, c.probe_keys)
        require(count == want and chained is False
                and 0 < dev_s <= single,
                f"measure {name}: {count, dev_s, single, chained}, oracle "
                f"{want}")
        emit("measure", cell=name, count=count, device_seconds=dev_s,
             single_call_seconds=single, chained=chained,
             main_core_seconds=direct_core[name])
    return require_launched("measure", tuple(kernels))


def hash_u64_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """ops/hashing.hash_u64 in numpy uint32 arithmetic (wraps mod 2^32)."""
    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))
    return fmix32(fmix32(lo) ^ (hi * np.uint32(0x9E3779B9)))


def phase_primitives() -> dict:
    """The query primitives at db-benchmark groupby G1 scale (h2oai/
    db-benchmark _data/groupby-datagen.R, G1_1e8_1e2_0_0: 1e8 rows, id6
    uniform over [1, 1e6], v1 over [1, 5]): hash_aggregate of v1 by id6,
    filter_columns on between_u64, sort_u64 of id6 with the row number,
    radix_partition_by_hash(pbits=8); each exact against numpy (integer
    bincounts, a stable argsort) and timed with CUDA events (cuda_ms)."""
    import torch
    from flash_hash_join_tpu_torch import ops
    from flash_hash_join_tpu_torch.ops.filter import between_u64
    from flash_hash_join_tpu_torch.utils.u64 import (device_planes, split_u64,
                                                     to_numpy_u64)
    n = 100_000_000
    rng = np.random.default_rng(1)
    id6 = rng.integers(1, 1_000_001, n, dtype=np.uint64)
    v1 = rng.integers(1, 6, n, dtype=np.uint64)
    dev = torch.device("cuda")
    kh, kl = device_planes(id6, dev)
    vh, vl = device_planes(v1, dev)
    zero_launches()
    ms = {}

    def u64(hi, lo, count=n):
        return to_numpy_u64(hi, lo, count)

    # hash_aggregate: count, sum, min, max of v1 by id6
    ms["hash_aggregate"] = cuda_ms(
        lambda: ops.hash_aggregate(kh, kl, vh, vl, n), reps=3)
    g = ops.hash_aggregate(kh, kl, vh, vl, n)
    ng = int(g.n_groups)
    ids = id6.view(np.int64)                           # all below 2^63
    by_v = np.stack([np.bincount(ids[v1 == v], minlength=1_000_001)
                     for v in range(1, 6)])
    counts = by_v.sum(0)
    keys = u64(g.key_hi, g.key_lo, ng).astype(np.int64)
    present = np.flatnonzero(counts)
    require(ng == present.size and np.array_equal(np.sort(keys), present),
            "hash_aggregate: groups differ from numpy")
    want_sum = (np.arange(1, 6)[:, None] * by_v).sum(0)
    want_min = np.argmax(by_v > 0, 0) + 1
    want_max = 5 - np.argmax(by_v[::-1] > 0, 0)
    require(np.array_equal(g.count[:ng].cpu().numpy(), counts[keys])
            and np.array_equal(u64(g.sum_hi, g.sum_lo, ng), want_sum[keys])
            and np.array_equal(u64(g.min_hi, g.min_lo, ng), want_min[keys])
            and np.array_equal(u64(g.max_hi, g.max_lo, ng), want_max[keys]),
            "hash_aggregate: count, sum, min or max differ from numpy")
    del g, by_v

    # filter_columns on between_u64
    lo_c, hi_c = (0, 250_000), (0, 750_000)
    ms["filter_columns"] = cuda_ms(lambda: ops.filter_columns(
        between_u64(kh, kl, lo_c, hi_c), kh, kl, vh, vl), reps=3)
    count, fkh, fkl, fvh, fvl = ops.filter_columns(
        between_u64(kh, kl, lo_c, hi_c), kh, kl, vh, vl)
    count = int(count)
    sel = (id6 >= 250_000) & (id6 <= 750_000)
    require(count == int(sel.sum())
            and np.array_equal(u64(fkh, fkl, count), id6[sel])
            and np.array_equal(u64(fvh, fvl, count), v1[sel])
            and not any(bool(p[count:].any()) for p in (fkh, fkl, fvh, fvl)),
            "filter_columns: rows differ from numpy")
    del fkh, fkl, fvh, fvl, sel

    # sort_u64: stable, so the row numbers of equal keys stay ascending
    rows = torch.arange(n, device=dev)
    ms["sort_u64"] = cuda_ms(lambda: ops.sort_u64(kh, kl, rows), reps=3)
    skh, skl, srow = ops.sort_u64(kh, kl, rows)
    want_sorted = np.repeat(np.arange(1_000_001, dtype=np.uint64), counts)
    srow = srow.cpu().numpy()
    require(np.array_equal(u64(skh, skl), want_sorted)
            and np.array_equal(id6[srow], want_sorted)
            and bool(np.all((want_sorted[1:] != want_sorted[:-1])
                            | (srow[1:] > srow[:-1]))),
            "sort_u64: differs from numpy's sort, or is not stable")
    del skh, skl, srow, rows, want_sorted

    # radix_partition_by_hash: offsets and rows against numpy
    ms["radix_partition_by_hash"] = cuda_ms(
        lambda: ops.radix_partition_by_hash((kh, kl, vh, vl), kh, kl,
                                            pbits=8), reps=3)
    part = ops.radix_partition_by_hash((kh, kl, vh, vl), kh, kl, pbits=8)
    pid = (hash_u64_np(*split_u64(id6)) >> np.uint32(24)).astype(np.uint8)
    order = np.argsort(pid, kind="stable")
    want_offsets = np.concatenate([[0], np.cumsum(np.bincount(
        pid, minlength=256))])
    require(np.array_equal(part.offsets.cpu().numpy(), want_offsets)
            and np.array_equal(part.pid.cpu().numpy(), pid[order])
            and np.array_equal(u64(*part.cols[:2]), id6[order])
            and np.array_equal(u64(*part.cols[2:]), v1[order]),
            "radix_partition_by_hash: differs from numpy")
    del part, order, pid
    for name, t in ms.items():
        emit("primitives", primitive=name, rows=n, ms=t,
             rows_per_s=n / t * 1e3)
    launches = require_launched("primitives", ("compact",))
    del kh, kl, vh, vl
    torch.cuda.empty_cache()
    return launches


C5_RANKS = 4
C5_ROWS = 62_500_000        # BASELINE.json config #5's share of a chip: 1e9 / 16


def dist_devices(ranks: int):
    """The ranks' devices, one card a rank when the machine has them, else
    every rank on cuda:0; and a note that says which."""
    import torch
    n = torch.cuda.device_count()
    if n >= ranks:
        return [f"cuda:{i}" for i in range(ranks)], (
            f"{ranks} distinct card{'s' * (ranks > 1)}")
    return ["cuda:0"] * ranks, (f"{ranks} ranks on cuda:0 (the machine has "
                                f"{n} card{'s' * (n > 1)})")


def dist_call(cell: str, fn, c, ranks: int, **kw):
    """One call of a distributed_join_* function on the cell through the
    in-process mesh: its line (count, core, wall, stage seconds, rows each
    rank received, hot set, drops and reruns, launches, each card's peak
    allocated and reserved bytes); returns the call's result."""
    import torch
    devices, placement = dist_devices(ranks)
    cards = sorted(set(devices))
    for d in cards:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    res = fn(c.build_keys, c.build_values, c.probe_keys, devices=devices,
             return_info=True, **kw)
    wall = time.perf_counter() - t0
    info = res[-1]
    emit("distributed", cell=cell, fn=fn.__name__, ranks=ranks,
         placement=placement, nb=len(c.build_keys), npr=len(c.probe_keys),
         count=res[0], core_seconds=res[1], wall_seconds=wall,
         probe_rows_per_s=len(c.probe_keys) / res[1],
         stages=info["stages"], build_rows=info["build_rows"],
         probe_rows=info["probe_rows"], rank_counts=info["rank_counts"],
         hot_keys=info["hot_keys"], drops=info["drops"],
         reruns=info["reruns"], probe_chunks=info["probe_chunks"],
         launches=info["launches"],
         peak_bytes={d: dict(allocated=torch.cuda.max_memory_allocated(d),
                             reserved=torch.cuda.max_memory_reserved(d))
                     for d in cards})
    return res


def check_zipf_rows(c, count: int, keys, vals) -> None:
    """The dist-zipf-c5 oracle, on the card: every Zipf probe is a build
    key by construction, so numpy's count is the probe count; a sorted
    search of the probes among the (unique, ascending) build keys confirms
    it.  The sorted output keys equal the sorted matching probes, and each
    output value is its key's (minimum, here only) build row's value."""
    import torch
    dev = torch.device("cuda:0")
    flip = torch.iinfo(torch.int64).min      # u64 order as signed order

    def card(u):
        return torch.from_numpy(u.view(np.int64)).to(dev) ^ flip
    bk, pk = card(c.build_keys), card(c.probe_keys)
    pos = torch.searchsorted(bk, pk).clamp_(max=bk.numel() - 1)
    hit = bk[pos] == pk
    want = int(hit.sum())
    require(want == len(c.probe_keys) == count == len(keys),
            f"dist-zipf-c5: count {count}, rows {len(keys)}, oracle {want} "
            f"of {len(c.probe_keys)} probes")
    del pos
    out = card(keys)
    require(torch.equal(torch.sort(out).values, torch.sort(pk[hit]).values),
            "dist-zipf-c5: the output keys differ from the matching probes")
    del pk, hit
    at = torch.searchsorted(bk, out)
    bv = torch.from_numpy(c.build_values.view(np.int64)).to(dev)
    require(torch.equal(bv[at], torch.from_numpy(vals.view(np.int64)).to(
        dev)), "dist-zipf-c5: an output value is not its key's build row's")
    del bk, out, at, bv
    torch.cuda.empty_cache()


def phase_distributed() -> dict:
    """The distributed tier (distributed_join_count / _materialize through
    the in-process mesh; the process group through its worker processes).
    dist-zipf-c5: BASELINE.json config #5's share of one chip, 6.25e7
    build and probe rows a rank at 4 ranks (2.5e8 x 2.5e8; 16 chips cut to
    4 ranks), Zipf-1.2 probes over unique build keys, all matching: count
    (a warm-up call, then one) and materialize against the oracle
    (check_zipf_rows), and the count with the probe side's exchange not
    overlapped (one chunk).  dist-scale-1e8: uniform 1e8 x 1e8, 50 %
    match, count at 1, 2 and 4 ranks.  dist-pg: dist-scale-1e8's data (and
    dist-zipf-c5's where 4 cards hold its ranks) over NCCL through the
    worker processes, one a card, world = the largest power of two <=
    min(4, cards); each worker checks the count, the ranks' rows and their
    values on its card, and the count is numpy's.  K5 and both walk
    kernels launched."""
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.models.workload import (uniform_case,
                                                           zipf_probe_case)
    from flash_hash_join_tpu_torch.parallel.distributed_join import (
        distributed_join_exact)
    from flash_hash_join_tpu_torch.parallel.dryrun import run_workers
    from flash_hash_join_tpu_torch.parallel.mesh import data_mesh
    zero_launches()
    t0 = time.perf_counter()
    n = C5_RANKS * C5_ROWS
    # 8 streams on any host, so every machine draws the same data
    c = zipf_probe_case(n, n, a=1.2, seed=0, threads=8)
    emit("distributed_data", cell="dist-zipf-c5", nb=len(c.build_keys),
         npr=len(c.probe_keys), generate_seconds=time.perf_counter() - t0)
    for _ in range(2):                                  # a warm-up, then one
        count = dist_call("dist-zipf-c5", ft.distributed_join_count, c,
                          C5_RANKS)[0]
        require(count == len(c.probe_keys),
                f"dist-zipf-c5: count {count} != oracle {len(c.probe_keys)}")
    count, _, keys, vals, _ = dist_call(
        "dist-zipf-c5", ft.distributed_join_materialize, c, C5_RANKS,
        return_arrays=True)
    check_zipf_rows(c, count, keys, vals)
    del keys, vals
    devices, placement = dist_devices(C5_RANKS)
    res = distributed_join_exact(data_mesh(devices=devices), c.build_keys,
                                 c.build_values, c.probe_keys,
                                 overlap_chunks=1)
    require(res.count == count, f"dist-zipf-c5 not overlapped: {res.count}")
    emit("distributed", cell="dist-zipf-c5", fn="distributed_join_exact",
         overlap_chunks=1, ranks=C5_RANKS, placement=placement,
         count=res.count, stages=res.info["stages"])
    del c, res
    torch.cuda.empty_cache()

    c = uniform_case(100_000_000, 100_000_000, 0.5)
    want = int((c.probe_keys < 2**62).sum())   # uniform_case's misses: >= 2^62
    for ranks in (1, 2, 4):
        count = dist_call("dist-scale-1e8", ft.distributed_join_count, c,
                          ranks)[0]
        require(count == want, f"dist-scale-1e8 at {ranks} ranks: count "
                f"{count} != oracle {want}")
    del c
    torch.cuda.empty_cache()

    cards = min(C5_RANKS, torch.cuda.device_count())
    world = 1 << (cards.bit_length() - 1)
    # dist-scale-1e8's data; dist-zipf-c5's too where 4 cards hold its ranks
    cells = [("uniform", 100_000_000, want)]
    if world == C5_RANKS:
        cells.append(("zipf", n, n))          # every Zipf probe matches
    for case, rows, oracle_count in cells:
        t0 = time.perf_counter()
        outs = run_workers(world, "--case", case, "--build-rows", rows,
                           "--probe-rows", rows, "--timeout", 300,
                           device="cuda", timeout=900)
        counts = {line.split("count=")[1] for out in outs
                  for line in out.splitlines() if "MHOK" in line}
        require(counts == {str(oracle_count)}, f"dist-pg {case}: counts "
                f"{counts}, oracle {oracle_count}")
        report = [json.loads(line.split(" ", 1)[1]) for line in
                  outs[0].splitlines() if line.startswith("MHSTAGES ")][0]
        emit("distributed", cell="dist-pg", case=case, backend="nccl",
             world=world, count=oracle_count,
             seconds=time.perf_counter() - t0, rank0=report)
    return require_launched("distributed", ("compact", *WALKS, BUILD))


HARNESS_KERNELS = ("dense_bitmap", "scan_domain_count", "range_build",
                   "range_probe_count", "range_probe_materialize",
                   "range_probe_sliced", "compact", "probe_gather_bitmap",
                   "probe_gather_staged", "probe_count_vmem",
                   "probe_materialize_vmem", *WALKS, BUILD)


def phase_harness(cells: dict) -> dict:
    """The harness twins (flash_hash_join_tpu_torch/harness/), their log on
    stderr.  (a) run_suites on the generated 1e6 suite (J1 Q1, Q2, Q5 and
    QB5), all six impls, count and materialize, the values of merge, global
    and partitioned checked; (b) run_suites on J1 1e8 Q1, Q2, Q5 (config
    #4) with adaptive_join and flash_join_radix; (c) the fuzzer twin, 40
    fixed-shape iterations and 12 streamed in 2-4 chunks.  Every run agrees
    with the oracle, the native oracle serves every case and the fuzzer
    fails no iteration; K1-K5, K7, K8, K10 and K11 launched."""
    from flash_hash_join_tpu_torch.harness import benchmark as hb
    from flash_hash_join_tpu_torch.harness import fuzz_join as hf
    config4 = [(name, c.build_keys, c.build_values, c.probe_keys)
               for name, c in cells.items()
               if name in ("1e8-Q1", "1e8-Q2", "1e8-Q5")]
    zero_launches()
    seconds, results, fuzz = {}, [], {}
    with contextlib.redirect_stdout(sys.stderr):
        for part, suites, impls, values_max in (
                ("gen-1e6", hb.gen_suites(1_000_000, 0), None, 1_000_000),
                ("config4-1e8", [("1e8", config4)],
                 ("adaptive_join", "flash_join_radix"), 0)):
            t0 = time.perf_counter()
            rows, ok = hb.run_suites(suites, impls, device="cuda",
                                     check_values_max=values_max,
                                     device_time=False, repeats=2)
            seconds[part] = time.perf_counter() - t0
            bad = [r for r in rows if not r["ok"]]
            require(ok and not bad, f"harness {part}: parity failures {bad}")
            results += rows
        for mode, seed, iters in (("fixed", 0, 40), ("chunked", 40, 12)):
            fuzz[mode] = hf.run_fuzz(
                iters, seed, fixed_shapes=True, chunked=mode == "chunked",
                device="cuda", log=print)
            seconds[f"fuzz-{mode}"] = fuzz[mode]["seconds"]
    oracles = sorted({r["oracle"] for r in results})
    require(oracles == ["native"], f"harness: cases served by {oracles}")
    require(all(f["fails"] == 0 for f in fuzz.values()),
            f"harness: fuzz failures {fuzz}")
    require(fuzz["chunked"]["streamed"] > 0, "harness: no fuzz iteration "
            "streamed its probe side")
    best = {}
    for r in results:
        if r["task"] != "check_values":
            best.setdefault(r["case"], {}).setdefault(r["label"], {})[
                r["task"]] = r["core"]
    emit("harness", runs=len(results),
         failures=sum(not r["ok"] for r in results), oracle=oracles,
         value_checks=sum(r["task"] == "check_values" for r in results),
         fuzz=fuzz, best_core_seconds=best, seconds=seconds)
    return require_launched("harness", HARNESS_KERNELS)


GATES_KERNELS = ("dense_bitmap", "scan_domain_count", "range_build",
                 "range_probe_count",
                 "range_probe_materialize", "compact", "probe_gather_bitmap",
                 "probe_gather_staged")


def phase_gates(cells: dict) -> dict:
    """The gate-drift check (flash_hash_join_tpu_torch/harness/
    gate_drift.py) on the card, its lines on stderr: a sentinel on each side
    of every adaptive gate (the J1 cells made here where the shape is one
    of them), each timed direct against partitioned by
    measure_device_seconds.  Every count equals the C++ host oracle's,
    every adaptive call takes the route its gate decides and every gate
    PASSes (the faster strategy is the gate's, or within 15 %); K1-K5, K7
    and K8 launched."""
    from flash_hash_join_tpu_torch.harness import gate_drift
    zero_launches()
    with contextlib.redirect_stdout(sys.stderr):
        rows, _ = gate_drift.run_checks(device="cuda", cells=cells)
    emit("gates", sentinels=rows)
    # a row fails on a count off the oracle's, an adaptive call off its
    # gate's route, or a gate on the slower strategy by more than 15 %
    require(all(r["ok"] for r in rows), "gates: sentinels FAIL: "
            f"{[r['label'] for r in rows if not r['ok']]}")
    return require_launched("gates", GATES_KERNELS)


def make_cells() -> dict:
    from flash_hash_join_tpu_torch.models.workload import (
        JoinCase, j1_suite, uniform_case)
    q1, q2, q5 = j1_suite(40_000_000, seed=0)
    n = 40_000_000                                     # bench.py:50-54
    rng = np.random.default_rng(2026)
    bench = JoinCase("bench-4e7",
                     rng.integers(0, int(n * 1.1), n, dtype=np.uint64),
                     rng.integers(0, 2**63, n, dtype=np.uint64),
                     rng.integers(0, int(n * 1.1), n, dtype=np.uint64))
    x1, x2, x5 = j1_suite(100_000_000, seed=0)
    y2 = j1_suite(10_000_000, seed=0)[1]
    wide = JoinCase("4e7-Q2-wide", q2.build_keys,
                    np.random.default_rng(7).integers(
                        0, 2**64, len(q2.build_keys), dtype=np.uint64),
                    q2.probe_keys)
    return {"4e7-Q1": q1, "4e7-Q2": q2, "4e7-Q5": q5, "bench-4e7": bench,
            "1e8-Q1": x1, "1e8-Q2": x2, "1e8-Q5": x5, "1e7-Q2": y2,
            "4e7-Q2-wide": wide,
            "uniform-1e7x1e8": uniform_case(10_000_000, 100_000_000, 0.5),
            "uniform-1e6x1e7": uniform_case(1_000_000, 10_000_000, 0.05)}


def main() -> int:
    if not (ROOT / "flash_hash_join_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it inside a checkout of the repository "
              "(flash_hash_join_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        start = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - start
        return out

    phase("env", phase_env)
    cells = phase("data", make_cells)
    emit("data", seconds=seconds["data"])
    summary = phase("kernels", phase_kernels, cells)
    summary.update(phase("partitioned_kernels", phase_partitioned_kernels,
                         cells))
    summary.update(phase("dense_kernels", phase_dense_kernels, cells))
    summary.update(phase("bucket_kernels", phase_bucket_kernels, cells))
    summary.update(phase("walk_kernels", phase_walk_kernels, cells))
    summary.update(phase("build_kernels", phase_build_kernels, cells))
    summary.update(phase("range_build", phase_range_build, cells))
    launches, direct_core, main_counts = phase("main", phase_main, cells)
    radix = phase("radix", phase_radix, cells)
    for k in ("range_build", "range_directory", "range_probe_count",
              "range_probe_materialize", "range_probe_sliced", "compact"):
        launches[k] = radix[k]
    phase("adaptive", phase_adaptive, cells)
    phase("direct_vs_partitioned", phase_direct_vs_partitioned, cells,
          direct_core)
    phase("fallback", phase_fallback, cells["uniform-1e6x1e7"])
    dense = phase("dense_mat", phase_dense_mat, cells)
    for k in ("probe_gather_bitmap", "probe_gather_staged",
              "materialize_copy"):
        launches[k] = dense[k]
    vmem = phase("vmem", phase_vmem, cells)
    for k in ("probe_count_vmem", "probe_materialize_vmem"):
        launches[k] = vmem[k]
    walk = phase("global", phase_global, cells)
    for k in (*WALKS, BUILD):
        launches[k] = walk[k]
    stream = phase("stream_compact", phase_stream_compact, cells)
    launches["concat_ragged_blocks"] = stream["concat_ragged_blocks"]
    summary["global_prune"], config3 = phase("config3", phase_config3)
    launches["global_prune"] = config3["global_prune"]
    phase("stream_direct", phase_stream_direct, cells, main_counts,
          direct_core)
    phase("measure", phase_measure, cells, direct_core)
    phase("primitives", phase_primitives)
    harness = phase("harness", phase_harness, cells)
    for k in HARNESS_KERNELS:
        launches[k] += harness[k]
    gates = phase("gates", phase_gates, cells)
    for k in GATES_KERNELS:
        launches[k] += gates[k]
    # K5's, the walk's and the build's launches: the distributed tier's too
    dist = phase("distributed", phase_distributed)
    for k in ("compact", *WALKS, BUILD):
        launches[k] += dist[k]
    emit("seconds", total=time.perf_counter() - t0, **seconds)
    src = "flash_hash_join_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": wrapper, "route": "cuda", "source": src + source,
         "replaces": REPLACES[key], "launches": launches[key],
         **summary[key]}
        for key, (wrapper, source) in KERNELS.items()]}), flush=True)
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
