#!/usr/bin/env python3
"""Peak device memory of the partitioned tier on one NVIDIA card, the
readings that set models/cost.py's constants.

    python3 scripts/calibrate_planner.py

Cells: BASELINE.json config #2 (uniform 64-bit keys, 1e7 build x 1e8 probe
rows, 50 % match) and config #3 (1e7 x 1e9, 5 % match), made by
models/workload.uniform_case.  Each runs once single-shot (the planner's
budget patched out of the way) through join_count and join_materialize
with strategy="partitioned", after torch.cuda.empty_cache() and
reset_peak_memory_stats(); the materialize's rows are not read back.  One
JSON line a run: the peak allocated and reserved bytes, core and wall
seconds.  Then, from the two probe sides at one build side, for each mode
and each of the two readings: the slope (bytes a probe row) and the
intercept (bytes a build row); the constants that the reserved readings
give with MARGIN; and the plans of config #3 and of a 4e9-row probe side
at the card's budget under models/cost.py's constants as they are and
under the constants before this calibration (the JAX package's v5e ones).
Last, the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MARGIN = 1.10      # on every slope and intercept
# models/cost.py's constants before the H100 readings (the v5e ones)
V5E = dict(BUILD_BYTES_COUNT=32, BUILD_BYTES_MATERIALIZE=40,
           TRANSIENT_BYTES_COUNT=40, TRANSIENT_BYTES_MATERIALIZE=56)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def peaks(fn, case, **kw) -> dict:
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(case.build_keys, case.build_values, case.probe_keys,
             device="cuda", return_info=True, **kw)
    wall = time.perf_counter() - t0
    return dict(allocated=torch.cuda.max_memory_allocated(),
                reserved=torch.cuda.max_memory_reserved(),
                count=out[0], core_seconds=out[1], wall_seconds=wall,
                probe_chunks=out[-1]["probe_chunks"],
                strategy=out[-1]["strategy"])


def plans(cost, budget: int, nb: int) -> dict:
    return {f"{mode} {npr:.0e}": cost.plan_probe_chunks(nb, npr, mode, budget)
            for mode in ("count", "materialize")
            for npr in (1_000_000_000, 4_000_000_000)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("calibrate_planner.py needs an NVIDIA card", file=sys.stderr)
        return 1
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch import api
    from flash_hash_join_tpu_torch.models import cost
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    ft.initialize()
    budget = cost.hbm_budget_bytes("cuda")
    api.hbm_budget_bytes = lambda dev: 1 << 60          # single-shot
    nb = 10_000_000
    readings = {}
    for npr, rate in ((100_000_000, 0.5), (1_000_000_000, 0.05)):
        t0 = time.perf_counter()
        case = uniform_case(nb, npr, rate)
        gen_s = time.perf_counter() - t0
        want = int((case.probe_keys < 2**62).sum())
        for mode, fn in (("count", ft.join_count),
                         ("materialize", ft.join_materialize)):
            r = peaks(fn, case, strategy="partitioned")
            if r["count"] != want or r["probe_chunks"] != 1:
                raise RuntimeError(f"{mode} {npr}: {r}, oracle {want}")
            readings[mode, npr] = r
            emit(cell=f"{nb:.0e} x {npr:.0e}", mode=mode, generate_seconds=gen_s,
                 **r, allocated_per_probe_row=r["allocated"] / npr,
                 reserved_per_probe_row=r["reserved"] / npr)
        del case
    fit = {}
    for mode in ("count", "materialize"):
        for what in ("allocated", "reserved"):
            lo, hi = (readings[mode, n][what]
                      for n in (100_000_000, 1_000_000_000))
            slope = (hi - lo) / 900_000_000
            fit[mode, what] = (slope, (lo - slope * 100_000_000) / nb)
            emit(fit=mode, reading=what, bytes_per_probe_row=slope,
                 bytes_per_build_row=fit[mode, what][1])
    derived = dict(
        BUILD_BYTES_COUNT=math.ceil(fit["count", "reserved"][1] * MARGIN),
        BUILD_BYTES_MATERIALIZE=math.ceil(
            fit["materialize", "reserved"][1] * MARGIN),
        TRANSIENT_BYTES_COUNT=max(
            math.ceil(fit["count", "reserved"][0] * MARGIN) - 8, 0),
        TRANSIENT_BYTES_MATERIALIZE=max(
            math.ceil(fit["materialize", "reserved"][0] * MARGIN) - 24, 0))
    current = {k: getattr(cost, k) for k in V5E}
    emit(margin=MARGIN, derived=derived, models_cost=current,
         budget_bytes=budget,
         plans_models_cost=plans(cost, budget, nb))
    for name, values in (("v5e", V5E), ("derived", derived)):
        for k, v in values.items():
            setattr(cost, k, v)
        emit(constants=name, plans=plans(cost, budget, nb))
    for k, v in current.items():
        setattr(cost, k, v)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
