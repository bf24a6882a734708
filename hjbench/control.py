"""The control of `correct`, run at a cell's own size.

    python3 -m hjbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's columns, then the reference with keys matched by
a 32-bit fingerprint in place of the 64-bit key (check.control), judged as
the program's window is.  Each seed prints one JSON line with its numbers,
their limits and whether they pass: the control has to fail, and the
command exits 1 where it passed on any seed.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from hjbench import catalog, check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    man = catalog.manifest()
    cell = catalog.workload(man, a.workload)
    cfg = catalog.config(man, cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    gen = catalog.datagen(cfg["generator"])
    passed = 0
    for seed in a.seeds:
        bk, bv, pk = gen.make(cfg, traffic["table"], seed % (1 << 64))
        checks = check.control(bk, bv, pk, traffic["mode"], "cuda")
        passes = check.verdict(checks)
        passed += passes
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "checks": checks, "limits": check.LIMITS,
                          "passes": passes}), flush=True)
        del bk, bv, pk
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
