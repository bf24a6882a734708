#!/usr/bin/env python3
"""The `global` tier's table build and walk on the card, and the calls they
serve, timed in this checkout or in turns with another one (such as the
parent's `git archive`).

    python3 scripts/bench_global_build.py                  # this checkout
    python3 scripts/bench_global_build.py --other DIR      # DIR, this, this, DIR
    python3 scripts/bench_global_build.py --distributed    # and dist-zipf-c5
    python3 scripts/bench_global_build.py --parts walk,core --sweep

Each turn is a process of its own that imports its checkout's package and
chip_smoke.py (the kernels built there) and prints one JSON line a
measurement, tagged with the checkout (--parts picks among build, walk and
core; all three by default):
  build  ops/hash_table.build_table on the cell's build planes already on
         the card, bloom off and on: chip_smoke.cuda_ms (a lone call, the
         median of 5) and cuda_ms_b2b (calls back to back), the peak device
         bytes above the planes, and one profiled call's device time by
         kernel (memsets apart);
  walk   the walk kernels, count and materialize, on the cell's table and
         probe planes, bloom off and on: the same two timings, the peak
         device bytes a probe row above the planes, one profiled call's
         device time by step (partition: the count, scan and scatter;
         walk; restore), the count checked against the numpy oracle; where
         the checkout has ops/cuda/hash_walk.forced, each route (0 levels,
         and the plan's 1 level) forced in turn beside the plan's own;
  core   hash_join_count[_bloom] and hash_join[_bloom]: the best
         core_seconds of 3 calls after a warm-up, the counts equal;
  dist   (--distributed) chip_smoke.py's dist-zipf-c5 count at 4 ranks on
         the card, a warm-up then one call: its stage seconds;
  sweep  (--sweep, this checkout only) the walk's count, a lone call by
         chip_smoke.cuda_ms, on each cell's table at probe prefixes from
         1/8 of a probe a group up to the whole side, 0 levels against 1
         level (the crossover behind hash_walk.MIN_PROBES_PER_GROUP); then
         on the whole sides, count and materialize, bloom off and on, 0
         levels and 1 level at 4-8 digit bits (behind MAX_PBITS and
         SLICE_BYTES).
Cells: chip_smoke.py's J1 1e8 Q5 and config #2 (uniform 1e7 x 1e8).  Then
the card's name and power limit.  Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARTS = ("build", "walk", "core")
STEPS = (("slice_walk_kernel", "walk"), ("walk_kernel", "walk"),
         ("restore_kernel", "restore"), ("hist_kernel", "partition"),
         ("scan_kernel", "partition"), ("scatter_kernel", "partition"))


def device_ms(fn) -> dict:
    """One profiled call of fn: device milliseconds by kernel name (the
    first 60 characters), memsets apart."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and not e.key.startswith("Memset"):
            kernels[e.key[:60]] = us / 1e3
    return kernels


def by_step(kernels: dict) -> dict:
    """A walk's device milliseconds by step (STEPS), from device_ms."""
    steps = {}
    for name, ms in kernels.items():
        step = next((s for k, s in STEPS if k in name), "other")
        steps[step] = steps.get(step, 0.0) + ms
    return steps


def peak_over(fn) -> int:
    """Peak device bytes allocated during fn() above what was allocated."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def measure(root: Path, parts: set, distributed: bool, sweep: bool) -> None:
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    import chip_smoke as cs
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.models.workload import (j1_suite,
                                                           uniform_case)
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG as cfg
    from flash_hash_join_tpu_torch.utils.u64 import device_planes

    def out(**kw):
        print(json.dumps(dict(tree=str(root), **kw)), flush=True)

    forced = getattr(hw, "forced", None)
    props = torch.cuda.get_device_properties(0)

    def route(static, npr, mat, **kw):
        return hw.plan(npr, static["gbits"], static["total_groups"],
                       static["group_size"], static["use_bloom"], mat,
                       l2_bytes=props.L2_cache_size,
                       sms=props.multi_processor_count, **kw)

    cells = {"1e8-Q5": j1_suite(100_000_000, seed=0)[2],
             "config2": uniform_case(10_000_000, 100_000_000, 0.5)}
    for name, c in cells.items():
        nb, npr = len(c.build_keys), len(c.probe_keys)
        planes = [*device_planes(c.build_keys, "cuda"),
                  *device_planes(c.build_values, "cuda")]
        for bloom in (False, True):
            kw = dict(gbits=cfg.group_bits(nb), group_size=cfg.group_size,
                      overflow_groups=cfg.overflow_groups, with_bloom=bloom,
                      bloom_k=cfg.bloom_k, max_probe_iters=cfg.max_probe_iters)

            def build():
                return ht.build_table(*planes, nb, **kw)

            if "build" in parts:
                build()
                peak = peak_over(build)
                out(what="build", cell=name, bloom=bloom, nb=nb,
                    ms=cs.cuda_ms(build), ms_b2b=cs.cuda_ms_b2b(build),
                    peak_device_bytes_over_planes=peak,
                    kernel_ms=device_ms(build))
                torch.cuda.empty_cache()
            if "walk" in parts or sweep:
                table, static = cs.walk_table(planes, nb, cfg, kw["gbits"],
                                              bloom)
                ph, pl = device_planes(c.probe_keys, "cuda")
                want = int(cs.oracle(name, c)[0].sum())
                if "walk" in parts:
                    walk_cell(out, name, bloom, table, static, ph, pl, npr,
                              want, forced, route)
                if sweep and forced is not None:
                    sweep_cell(out, name, bloom, table, static, ph, pl, npr,
                               forced)
                del table, ph, pl
                torch.cuda.empty_cache()
        del planes
        torch.cuda.empty_cache()
        if "core" not in parts:
            continue
        counts = {}
        for fn in ("hash_join_count", "hash_join_count_bloom", "hash_join",
                   "hash_join_bloom"):
            f = getattr(ft, fn)
            f(c.build_keys, c.build_values, c.probe_keys, device="cuda")
            runs = []
            for _ in range(3):
                count, core = f(c.build_keys, c.build_values, c.probe_keys,
                                device="cuda")
                runs.append(core)
            counts[fn] = count
            out(what="core", cell=name, fn=fn, count=count,
                core_ms=min(runs) * 1e3, core_ms_runs=[r * 1e3 for r in runs])
        if len(set(counts.values())) != 1:
            raise SystemExit(f"{name}: the four calls disagree: {counts}")
    del cells
    if distributed:
        from flash_hash_join_tpu_torch.models.workload import zipf_probe_case
        n = cs.C5_RANKS * cs.C5_ROWS
        c = zipf_probe_case(n, n, a=1.2, seed=0, threads=8)
        for _ in range(2):                              # a warm-up, then one
            res = cs.dist_call("dist-zipf-c5", ft.distributed_join_count, c,
                               cs.C5_RANKS)
        if res[0] != len(c.probe_keys):
            raise SystemExit(f"dist-zipf-c5: count {res[0]}")
        out(what="dist", cell="dist-zipf-c5", core_s=res[1],
            stages=res[-1]["stages"])


def walk_cell(out, name, bloom, table, static, ph, pl, npr, want, forced,
              route) -> None:
    """The walk kernels on one table: the plan's route, and where the
    checkout can force them, each route alone."""
    import torch
    import chip_smoke as cs
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    for kernel in ("count", "materialize"):
        fn = hw.global_walk_count if kernel == "count" \
            else hw.global_walk_materialize
        routes = {"plan": {}}
        if forced is not None:
            routes["levels0"] = dict(pbits=0)
            routes["levels1"] = dict(pbits=hw.slice_bits(
                static["total_groups"], static["group_size"],
                static["use_bloom"], kernel == "materialize"))
        for label, over in routes.items():
            with forced(**over) if over else contextlib.nullcontext():
                def run():
                    return fn(table, ph, pl, npr, **static)
                got = run()
                count = int(got if kernel == "count" else got[0].sum())
                if count != want:
                    raise SystemExit(f"walk {name} {kernel} {label}: {count}"
                                     f" != oracle {want}")
                del got
                peak = peak_over(run)
                steps = by_step(device_ms(run))
                out(what="walk", cell=name, bloom=bloom, kernel=kernel,
                    route=label, plan=list(route(
                        static, npr, kernel == "materialize", **over))
                    if forced is not None else None,
                    ms=cs.cuda_ms(run), ms_b2b=cs.cuda_ms_b2b(run),
                    peak_bytes_per_probe_row=peak / npr, step_ms=steps)
            torch.cuda.empty_cache()


def sweep_cell(out, name, bloom, table, static, ph, pl, npr, forced) -> None:
    """The crossover of the two routes over probe prefixes, and the level's
    digit bits and probes a thread on the whole side."""
    import chip_smoke as cs
    from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw
    groups = static["total_groups"]
    one = hw.slice_bits(groups, static["group_size"], bloom, False)
    sizes = sorted({min(npr, int(f * groups))
                    for f in (0.125, 0.25, 0.5, 1, 2, 4, 8, 16, 32)})
    for n in sizes if not bloom else ():
        for pbits in (0, one):
            with forced(pbits=pbits):
                ms = cs.cuda_ms(lambda: hw.global_walk_count(
                    table, ph, pl, n, **static))
            out(what="sweep", part="crossover", cell=name, n=n,
                probes_per_group=n / groups, pbits=pbits, ms=ms)
    for kernel, fn in (("count", hw.global_walk_count),
                       ("materialize", hw.global_walk_materialize)):
        for pbits in (0, 4, 5, 6, 7, 8):
            with forced(pbits=pbits):
                ms = cs.cuda_ms(lambda: fn(table, ph, pl, npr, **static))
            out(what="sweep", part="tune", cell=name, bloom=bloom,
                kernel=kernel, pbits=pbits, ms=ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="a checkout to run in turns")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated, of " + ", ".join(PARTS))
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = {p for p in args.parts.split(",") if p}
    if not parts <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(parts - set(PARTS))}")
    if args.measure:
        measure(args.measure.resolve(), parts, args.distributed, args.sweep)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_global_build.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    trees = [ROOT] if args.other is None else [
        args.other.resolve(), ROOT, ROOT, args.other.resolve()]
    for i, tree in enumerate(trees):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(tree), "--parts", ",".join(sorted(parts))]
        cmd += ["--distributed"] * args.distributed
        # the sweep once, in this checkout's first turn
        cmd += ["--sweep"] * (args.sweep and i == trees.index(ROOT))
        if subprocess.run(cmd).returncode:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
