#!/usr/bin/env python3
"""The `global` tier's table build on the card, and the calls it serves,
timed in this checkout or in turns with another one (such as the parent's
`git archive`).

    python3 scripts/bench_global_build.py                  # this checkout
    python3 scripts/bench_global_build.py --other DIR      # DIR, this, this, DIR
    python3 scripts/bench_global_build.py --distributed    # and dist-zipf-c5

Each turn is a process of its own that imports its checkout's package and
chip_smoke.py (the kernels built there) and prints one JSON line a
measurement, tagged with the checkout:
  build  ops/hash_table.build_table on the cell's build planes already on
         the card, bloom off and on: chip_smoke.cuda_ms (a lone call, the
         median of 5) and cuda_ms_b2b (calls back to back), the peak device
         bytes above the planes, and one profiled call's device time by
         kernel (memsets apart);
  core   hash_join_count and hash_join_count_bloom: the best core_seconds
         of 3 calls after a warm-up, the two counts equal;
  dist   (--distributed) chip_smoke.py's dist-zipf-c5 count at 4 ranks on
         the card, a warm-up then one call: its stage seconds.
Cells: chip_smoke.py's J1 1e8 Q5 and config #2 (uniform 1e7 x 1e8).  Then
the card's name and power limit.  Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(root: Path, distributed: bool) -> None:
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity
    import chip_smoke as cs
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.models.workload import (j1_suite,
                                                           uniform_case)
    from flash_hash_join_tpu_torch.ops import hash_table as ht
    from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG as cfg
    from flash_hash_join_tpu_torch.utils.u64 import device_planes

    def out(**kw):
        print(json.dumps(dict(tree=str(root), **kw)), flush=True)

    cells = {"1e8-Q5": j1_suite(100_000_000, seed=0)[2],
             "config2": uniform_case(10_000_000, 100_000_000, 0.5)}
    for name, c in cells.items():
        nb = len(c.build_keys)
        planes = [*device_planes(c.build_keys, "cuda"),
                  *device_planes(c.build_values, "cuda")]
        for bloom in (False, True):
            kw = dict(gbits=cfg.group_bits(nb), group_size=cfg.group_size,
                      overflow_groups=cfg.overflow_groups, with_bloom=bloom,
                      bloom_k=cfg.bloom_k, max_probe_iters=cfg.max_probe_iters)

            def build():
                return ht.build_table(*planes, nb, **kw)

            build()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            build()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            lone, b2b = cs.cuda_ms(build), cs.cuda_ms_b2b(build)
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                build()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                if us > 0 and not e.key.startswith("Memset"):
                    kernels[e.key[:60]] = us / 1e3
            out(what="build", cell=name, bloom=bloom, nb=nb, ms=lone,
                ms_b2b=b2b, peak_device_bytes_over_planes=peak,
                kernel_ms=kernels)
            torch.cuda.empty_cache()
        del planes
        torch.cuda.empty_cache()
        counts = {}
        for fn in ("hash_join_count", "hash_join_count_bloom"):
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
            raise SystemExit(f"{name}: bloom and no bloom disagree: {counts}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="a checkout to run in turns")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure.resolve(), args.distributed)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_global_build.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    trees = [ROOT] if args.other is None else [
        args.other.resolve(), ROOT, ROOT, args.other.resolve()]
    for tree in trees:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--measure",
               str(tree)] + ["--distributed"] * args.distributed
        if subprocess.run(cmd).returncode:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
