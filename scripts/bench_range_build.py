#!/usr/bin/env python3
"""The partitioned tier's table build on one NVIDIA card: the build kernels
(ops/cuda/range_build.range_build) against their plain version (the
torch.sort build: a stable sort of the sortable keys, a stack of the value
planes and a gather of it) and against one stable torch.sort of the
sortable keys alone (library_ms), by both of chip_smoke.py's timers (ms: a
lone call; ms_b2b: calls back to back), in turns plain, kernel, kernel,
plain.

    python3 scripts/bench_range_build.py [--cells NAME ...]

Cells (planes made on the card from a seeded torch.Generator):
  j1-1e8-q5        1e8 keys, a permutation of 1..1.1e8 cut to 1e8 (J1 1e8
                   Q5's build side: 27 bits), values random; with values
                   (the materialize) and without (the count)
  equal-1e6-in-1e7 1e7 keys over 1..1.1e8, 1e6 of them one key
  j1-1e8-u64-max   j1-1e8-q5's keys with one u64-max key (every digit
                   varies: eight passes of 16-byte records)
  full-range-1e8   1e8 keys over all 64 bits
Each cell is first checked equal to the plain build, bit for bit, and its
plan read back (the passes and record bytes the card took).  Beside the
times: the bound (chip_smoke.bound: each row's key and value words read
once, its sortable key and value pair written once) and each build's peak
device memory above its inputs.  Prints one JSON line a cell and build,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

CELLS = ("j1-1e8-q5", "equal-1e6-in-1e7", "j1-1e8-u64-max", "full-range-1e8")


def planes_of(cell: str):
    """(kh, kl, vh, vl) int32 planes of a cell on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(23)
    if cell == "full-range-1e8":
        n = 100_000_000
        kh, kl = (torch.randint(-2**31, 2**31, (n,), device="cuda",
                                dtype=torch.int32, generator=gen)
                  for _ in range(2))
    else:
        n = 10_000_000 if cell == "equal-1e6-in-1e7" else 100_000_000
        if cell == "equal-1e6-in-1e7":
            keys = torch.randint(1, 110_000_001, (n,), device="cuda",
                                 generator=gen)
            at = torch.randperm(n, device="cuda", generator=gen)[:1_000_000]
            keys[at] = 55_555_555
        else:
            keys = torch.randperm(110_000_000, device="cuda",
                                  generator=gen)[:n] + 1
        kl = keys.to(torch.int32)
        kh = torch.zeros_like(kl)
        del keys
        if cell == "j1-1e8-u64-max":
            kh[n // 3] = kl[n // 3] = -1
    vh, vl = (torch.randint(-2**31, 2**31, (n,), device="cuda",
                            dtype=torch.int32, generator=gen)
              for _ in range(2))
    return kh, kl, vh, vl


def varying(kh, kl) -> int:
    """The OR of the keys XOR their AND, over the planes in numpy."""
    import numpy as np
    keys = (kh.cpu().numpy().view(np.uint32).astype(np.uint64) << np.uint64(32)
            | kl.cpu().numpy().view(np.uint32).astype(np.uint64))
    return int(np.bitwise_or.reduce(keys) ^ np.bitwise_and.reduce(keys))


def peak_bytes(fn) -> int:
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def bench(cells) -> None:
    import torch
    from bench_k5_k10 import turns
    from chip_smoke import bound, cuda_ms
    from flash_hash_join_tpu_torch.ops.cuda import range_build as rb
    from flash_hash_join_tpu_torch.utils.u64 import sortable
    for cell in cells:
        planes = planes_of(cell)
        n = planes[0].numel()
        bits = varying(*planes[:2])
        for with_values in ((True, False) if cell == "j1-1e8-q5" else (True,)):
            def kernel():
                return rb.range_build(*planes, n, with_values=with_values)

            def plain():
                return rb.range_build_plain(*planes, n,
                                            with_values=with_values)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and (
                    not with_values or torch.equal(got[1], want[1]))):
                raise RuntimeError(f"{cell}: kernel != plain")
            del got, want
            plan = rb.device_plan(*planes, n, with_values=with_values)
            if plan != rb.plan(bits, with_values):
                raise RuntimeError(f"{cell}: the card's plan {plan} is not "
                                   f"{rb.plan(bits, with_values)}")
            t = turns({"plain": plain, "kernel": kernel},
                      ("plain", "kernel", "kernel", "plain"))
            library_ms = cuda_ms(lambda: torch.sort(
                sortable(*planes[:2]), stable=True))
            row_bytes = 32 if with_values else 16
            print(json.dumps({
                "cell": cell, "rows": n, "with_values": with_values,
                "passes": plan.passes, "digits": list(plan.digits),
                "record_bytes": plan.record_bytes,
                **bound(row_bytes * n, 0),
                "ms": min(t["kernel"]["ms"]),
                "ms_b2b": min(t["kernel"]["ms_b2b"]),
                "plain_ms": min(t["plain"]["ms"]),
                "plain_ms_b2b": min(t["plain"]["ms_b2b"]),
                "library_ms": library_ms,
                "peak_bytes": peak_bytes(kernel),
                "plain_peak_bytes": peak_bytes(plain), "turns": t}),
                flush=True)
        del planes
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", choices=CELLS, default=CELLS)
    args = ap.parse_args()
    bench(args.cells)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
