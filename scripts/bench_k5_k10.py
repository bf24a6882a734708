#!/usr/bin/env python3
"""K5 (compact_by_mask) and K10 (probe_count_vmem) of this checkout, on one
NVIDIA card, through the wrappers the join paths call.

    python3 scripts/bench_k5_k10.py

Cells: K5 on 1e8 rows and 4 planes with 60 % and 5 % of the rows hit, and
on 3 planes at 60 % (the dense materialize's narrow-value shape); random
masks and planes from a seeded torch.Generator.  K10 on the vmem tier's J1
cells (1e8 Q1: 100 build rows, R 16; 4e7 Q2: 4e4 build rows, R 512;
models/workload.j1_suite, seed 0), the table built as the count path
builds it (no values).  Each kernel first checked equal to its plain
version, then read by both of chip_smoke.py's timers: cuda_ms (a lone
call) and cuda_ms_b2b (calls back to back), in two turns.  The script uses
only what every checkout since the port began has, so it can be copied into
another checkout (such as the parent's `git archive`) and run there, in
turns with this one.  Prints one JSON line a cell, then the card's name
and power limit.

Its --variants option, in commits 281b589 and 4be6ae1, timed the kernels'
design choices in turns: K5's tile of 4096 rows against 8192, and K10 at R
64 and R 128 with its keys in shared memory against its fence path.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def turns(runs: dict, order) -> dict:
    """Both timers of chip_smoke.py over each named call, in the order
    given."""
    from chip_smoke import cuda_ms, cuda_ms_b2b
    out = {name: {"ms": [], "ms_b2b": []} for name in runs}
    for name in order:
        out[name]["ms"].append(cuda_ms(runs[name]))
        out[name]["ms_b2b"].append(cuda_ms_b2b(runs[name]))
    return out


def require_equal(got, want, what: str) -> None:
    import torch
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        ok = int(got) == int(want)
    else:
        count, outs = got
        wcount, wouts = want
        keep = int(wcount)
        ok = int(count) == keep and all(torch.equal(o[:keep], w[:keep])
                                        for o, w in zip(outs, wouts))
    if not ok:
        raise RuntimeError(f"{what}: kernel != plain")


def bench_k5() -> None:
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 100_000_000
    for density, n_planes in ((0.6, 4), (0.05, 4), (0.6, 3)):
        mask = torch.rand(n, device="cuda", generator=gen) < density
        cols = [torch.randint(-2**31, 2**31, (n,), device="cuda",
                              dtype=torch.int32, generator=gen)
                for _ in range(n_planes)]
        want = sc.compact_by_mask_plain(mask, cols, n)
        hits = int(want[0])

        def k5():
            return sc.compact_by_mask(mask, cols, n)
        require_equal(k5(), want, "K5")
        t = turns({"k5": k5}, ("k5", "k5"))
        print(json.dumps({"kernel": "compact_by_mask", "rows": n,
                          "planes": n_planes, "hits": hits, **t}),
              flush=True)
        del mask, cols, want
        torch.cuda.empty_cache()


def bench_k10() -> None:
    import torch
    from flash_hash_join_tpu_torch.models.workload import j1_suite
    from flash_hash_join_tpu_torch.ops import bucket_table as bt
    from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bkp
    from flash_hash_join_tpu_torch.utils.u64 import device_planes
    cells = {"1e8-Q1": j1_suite(100_000_000, seed=0)[0],
             "4e7-Q2": j1_suite(40_000_000, seed=0)[1]}
    for name, c in cells.items():
        r_slots = bt.r_slots_for(len(c.build_keys))
        kh, kl = device_planes(c.build_keys, "cuda")
        table = bt.build_bucket_table(kh, kl, kh, kl, len(c.build_keys),
                                      r_slots=r_slots, with_values=False)
        ph, pl = device_planes(c.probe_keys, "cuda")
        npr = ph.numel()
        want = bkp.probe_count_vmem_plain(table.tk_hi, table.tk_lo, ph, pl,
                                          npr)

        def k10():
            return bkp.probe_count_vmem(table.tk_hi, table.tk_lo, ph, pl, npr)
        require_equal(k10(), want, f"K10 at {name}")
        t = turns({"k10": k10}, ("k10", "k10"))
        print(json.dumps({"kernel": "probe_count_vmem", "cell": name,
                          "r_slots": r_slots, "npr": npr,
                          "count": int(want), **t}), flush=True)
        del table, ph, pl, kh, kl
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_k5_k10.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import run
    bench_k5()
    bench_k10()
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
