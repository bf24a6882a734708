#!/usr/bin/env python3
"""K6 (concat_ragged_blocks) of this checkout on one NVIDIA card, through
the wrapper the FHJ_COMPACT=stream route calls.

    python3 scripts/bench_k6.py

Cells: 1e8 rows with 60 % and 5 % of them hit, 4 planes, and 60 % with 2
planes; random masks and planes from a seeded torch.Generator, cut into
64K-word blocks with each block's hits at its front by the route's own
ops/compact.stream_blocks.  A fourth cell takes the first, 60 % and 4
planes, with each count cut to a multiple of 4, so that every block's
source and destination lie on 16-byte boundaries alike: against the first
it shows what reading a misaligned source with scalar loads costs.  K6 is first checked equal to its plain version,
then read by both of chip_smoke.py's timers, cuda_ms (a lone call) and
cuda_ms_b2b (calls back to back), in two turns, beside its bound
(chip_smoke.bound: the counts, and each kept word read once and written
once) and one boolean-mask index of the stacked planes (`plane[mask]`, the
library yardstick).  The script uses only what every checkout since the
port began has, so it can be copied into another checkout (such as the
parent's `git archive`) and run there, in turns with this one.  Prints one
JSON line a cell, then the card's name and power limit.

Its --variants option, in commit 3b55cd0, timed the kernel's design
choices in turns: a misaligned source read with four scalar loads a 16-byte
word or realigned with warp shuffles, at 256 or 512 threads a block.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def bench() -> None:
    import torch
    from bench_k5_k10 import turns
    from chip_smoke import bound, cuda_ms
    from flash_hash_join_tpu_torch.ops import compact as cp
    from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 100_000_000
    for density, n_planes, whole in ((0.6, 4, False), (0.05, 4, False),
                                     (0.6, 2, False), (0.6, 4, True)):
        mask = torch.rand(n, device="cuda", generator=gen) < density
        cols = [torch.randint(-2**31, 2**31, (n,), device="cuda",
                              dtype=torch.int32, generator=gen)
                for _ in range(n_planes)]
        planes, counts = cp.stream_blocks(mask, cols, n)
        del mask, cols
        if whole:           # every offset, and so every source, on 16 bytes
            counts -= counts % 4
        total = int(counts.sum())
        want = sc.concat_ragged_blocks_plain(planes, counts)

        def k6():
            return sc.concat_ragged_blocks(planes, counts)
        got = k6()
        torch.cuda.synchronize()
        if not all(torch.equal(g[:total], w[:total])
                   for g, w in zip(got, want)):
            raise RuntimeError("K6: kernel != plain")
        del want, got
        t = turns({"k6": k6}, ("k6", "k6"))
        prefix = (torch.arange(planes[0].shape[1], device="cuda")
                  < counts[:, None]).view(-1)
        stacked = torch.stack([p.view(-1) for p in planes])
        library_ms = cuda_ms(lambda: stacked[:, prefix])
        print(json.dumps({"kernel": "concat_ragged_blocks", "rows": n,
                          "planes": n_planes, "counts_of_4": whole,
                          "nblocks": counts.numel(),
                          "hits": total,
                          **bound(4 * counts.numel() + 8 * n_planes * total,
                                  2 * n_planes * total),
                          "library_ms": library_ms, **t}), flush=True)
        del planes, counts, prefix, stacked
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_k6.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import run
    bench()
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
