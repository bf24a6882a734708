#!/usr/bin/env python3
"""Where the device time of one port API call goes, under torch.profiler,
on chip_smoke.py's cells (same generators and seeds).

    python3 profile_cells.py                   # every cell below
    python3 profile_cells.py vmem-count-1e8-Q1 global-count-1e8-Q5
    python3 profile_cells.py global-build-plain-1e8-Q5   # a build alone

For each cell: a warm-up call, three timed calls (the best core_seconds,
CUDA events as the API reports them, is `best_core_ms`; the best host
clock around the whole call is `best_wall_s`; the most device memory any
of them held is `peak_device_bytes`), then one profiled call.  Prints one
JSON line per cell: the profiled call's core_seconds (the profiler's own
cost is inside), the kernels' summed device time,
the idle share of core_seconds (1 - kernel time / core), the host->device
copy time (outside core), the number of kernel launches, and the kernels
with the most device time.  The global-build-* cells time and profile
the `global` tier's table build alone (ops/hash_table.build_table, the
kernel, or build_table_plain) on the cell's build planes, already on the
card, as engine._global_table calls it: best of three by CUDA events, the
peak bytes above the planes, and also the profiled call's device time by
torch op.  Needs an NVIDIA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

CELLS = {  # name -> (chip_smoke cell, API function, keywords, FHJ_COMPACT)
    # the direct count (K2 on Q1/Q2, K1 on Q5: bench.py's main path), the
    # dense materialize's staged band (K8; 4e7-Q2-wide: u64 values) and
    # its scan band (K7)
    "direct-count-4e7-Q1": ("4e7-Q1", "adaptive_join_count", {}, None),
    "direct-count-4e7-Q2": ("4e7-Q2", "adaptive_join_count", {}, None),
    "direct-count-4e7-Q5": ("4e7-Q5", "adaptive_join_count", {}, None),
    "direct-count-bench-4e7": ("bench-4e7", "adaptive_join_count", {}, None),
    "direct-count-1e8-Q5": ("1e8-Q5", "adaptive_join_count", {}, None),
    "dense-mat-1e8-Q2": ("1e8-Q2", "adaptive_join", {}, None),
    "dense-mat-4e7-Q2": ("4e7-Q2", "adaptive_join", {}, None),
    "dense-mat-4e7-Q2-wide": ("4e7-Q2-wide", "adaptive_join", {}, None),
    "dense-mat-1e7-Q2": ("1e7-Q2", "adaptive_join", {}, None),
    "dense-mat-4e7-Q1": ("4e7-Q1", "adaptive_join", {}, None),
    "dense-mat-1e8-Q1": ("1e8-Q1", "adaptive_join", {}, None),
    "partitioned-count-4e7-Q1": ("4e7-Q1", "join_count",
                                 {"strategy": "partitioned"}, None),
    "partitioned-count-4e7-Q2": ("4e7-Q2", "join_count",
                                 {"strategy": "partitioned"}, None),
    "partitioned-materialize-1e8-Q2": ("1e8-Q2", "join_materialize",
                                       {"strategy": "partitioned"}, None),
    "vmem-count-1e8-Q1": ("1e8-Q1", "join_count", {"strategy": "vmem"}, None),
    "vmem-materialize-1e8-Q1": ("1e8-Q1", "join_materialize",
                                {"strategy": "vmem"}, None),
    "vmem-count-4e7-Q2": ("4e7-Q2", "join_count", {"strategy": "vmem"}, None),
    # K11 at R 512, the rung it is judged on
    "vmem-materialize-4e7-Q2": ("4e7-Q2", "join_materialize",
                                {"strategy": "vmem"}, None),
    "radix-materialize-1e8-Q1": ("1e8-Q1", "hash_join_radix", {}, None),
    "radix-materialize-1e8-Q2": ("1e8-Q2", "hash_join_radix", {}, None),
    "radix-materialize-1e8-Q5": ("1e8-Q5", "hash_join_radix", {}, None),
    "radix-count-1e8-Q5": ("1e8-Q5", "hash_join_count_radix", {}, None),
    "adaptive-count-config2": ("uniform-1e7x1e8", "adaptive_join_count", {},
                               None),
    "adaptive-materialize-config2": ("uniform-1e7x1e8", "adaptive_join", {},
                                     None),
    "global-count-1e8-Q5": ("1e8-Q5", "hash_join_count", {}, None),
    "global-count-bloom-1e8-Q5": ("1e8-Q5", "hash_join_count_bloom", {},
                                  None),
    "global-count-config2": ("uniform-1e7x1e8", "hash_join_count", {}, None),
    # chip_smoke.py's two stream_compact cells (blockwise sort + K6)
    "stream-radix-1e8-Q2": ("1e8-Q2", "hash_join_radix", {}, "stream"),
    "stream-adaptive-1e8-Q1": ("1e8-Q1", "adaptive_join", {}, "stream"),
}

BUILD_CELLS = {  # name -> (chip_smoke cell, plain build?, bloom?)
    f"global-build{'-plain' * plain}{'-bloom' * bloom}-{tag}": (
        cell, plain, bloom)
    for tag, cell in (("1e8-Q5", "1e8-Q5"), ("config2", "uniform-1e7x1e8"))
    for plain in (False, True) for bloom in (False, True)}


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def profile(name: str, cells: dict) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    import flash_hash_join_tpu_torch as ft
    cell, fn_name, kw, compact = CELLS[name]
    c = cells[cell]
    fn = getattr(ft, fn_name)
    if compact:
        os.environ["FHJ_COMPACT"] = compact
    args = (c.build_keys, c.build_values, c.probe_keys)
    fn(*args, device="cuda", **kw)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        core = fn(*args, device="cuda", **kw)[1]
        runs.append((core, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        count, core, info = fn(*args, device="cuda", return_info=True, **kw)
        torch.cuda.synchronize()
    os.environ.pop("FHJ_COMPACT", None)
    kernels, copy_us = [], 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        us = _device_us(e)
        if us <= 0:
            continue
        if e.key.startswith("Memcpy HtoD"):
            copy_us += us
        else:
            kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels) / 1e3
    return dict(cell=name, fn=fn_name, fn_kwargs=kw, compact=compact,
                count=count, strategy=info["strategy"],
                best_core_ms=min(r[0] for r in runs) * 1e3,
                best_wall_s=min(r[1] for r in runs),
                peak_device_bytes=peak,
                peak_bytes_per_probe_row=peak / len(c.probe_keys),
                core_ms=core * 1e3,
                kernel_ms=busy_ms,
                idle_share=1 - busy_ms / (core * 1e3),
                h2d_ms=copy_us / 1e3,
                launches=sum(k[1] for k in kernels),
                wrapper_launches={k: v for k, v in info["launches"].items()
                                  if v},
                top=[dict(ms=us / 1e3, calls=n, kernel=key[:90])
                     for us, n, key in kernels[:10]])


def profile_build(name: str, cells: dict) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG as cfg
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    cell, plain, bloom = BUILD_CELLS[name]
    c = cells[cell]
    nb = len(c.build_keys)
    planes = [*device_planes(c.build_keys, "cuda"),
              *device_planes(c.build_values, "cuda")]
    kw = dict(gbits=cfg.group_bits(nb), group_size=cfg.group_size,
              overflow_groups=cfg.overflow_groups, with_bloom=bloom,
              bloom_k=cfg.bloom_k, max_probe_iters=cfg.max_probe_iters)
    fn = ht.build_table_plain if plain else ht.build_table

    def build():
        return fn(*planes, nb, **kw)

    build()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        table = build()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del table
    peak = torch.cuda.max_memory_allocated() - base
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        build()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            dev_us = getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0))
            if e.key.startswith("aten::") and dev_us > 0:
                ops.append((dev_us, e.count, e.key))
        elif _device_us(e) > 0:
            kernels.append((_device_us(e), e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    return dict(cell=name, build="plain" if plain else "kernel",
                with_bloom=bloom, nb=nb, gbits=kw["gbits"],
                total_groups=(1 << kw["gbits"]) + cfg.overflow_groups,
                best_ms=min(times), runs_ms=times,
                peak_device_bytes_over_planes=peak,
                kernel_ms=sum(k[0] for k in kernels) / 1e3,
                launches=sum(k[1] for k in kernels),
                top=[dict(ms=us / 1e3, calls=n, kernel=key[:90])
                     for us, n, key in kernels[:12]],
                ops=[dict(ms=us / 1e3, calls=n, op=key)
                     for us, n, key in ops[:16]])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_cells.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke
    names = sys.argv[1:] or [*CELLS, *BUILD_CELLS]
    unknown = [n for n in names if n not in CELLS and n not in BUILD_CELLS]
    if unknown:
        print(f"profile_cells.py: unknown cells {unknown}; one of "
              f"{[*CELLS, *BUILD_CELLS]}", file=sys.stderr)
        return 2
    cells = chip_smoke.make_cells()
    for name in names:
        out = profile_build(name, cells) if name in BUILD_CELLS \
            else profile(name, cells)
        print(json.dumps(out), flush=True)
    print(chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
