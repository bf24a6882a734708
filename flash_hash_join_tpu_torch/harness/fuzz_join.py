"""Differential fuzzer of the port: random joins against the C++ host
oracle, every strategy.  The twin of the JAX package's scripts/fuzz_join.py.

Random shapes x key distributions x value widths x strategies, each checked
for the count, the materialized count and the (key, value) multiset against
the port's exact oracle (utils/native.py).  Every tier of the port keeps
the minimum build row of a duplicate key, as the oracle does, so the pairs
are compared exactly on any build.  gen_case draws the same arrays as the JAX fuzzer's for
the same seed, and the strategy of iteration `it` is the same, so a
`FAIL seed=...` line of either fuzzer reproduces in the other.  `direct`
runs where the port takes the build keys as a dense domain (api._dense_rung:
below 2^32, a span of at most MAX_XL_DOMAIN_BITS slots for a count; for a
materialize also at most MAX_BUILD_ROWS build rows and v_rows_for(span) <=
MAT_MAX_V_ROWS), else `merge`.

Run: python3 -m flash_hash_join_tpu_torch.harness.fuzz_join [--iters 200]
     [--seed 0] [--fixed-shapes] [--chunked] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import numpy as np

from flash_hash_join_tpu_torch import api
from flash_hash_join_tpu_torch.harness.benchmark import pair_multiset
from flash_hash_join_tpu_torch.utils.native import host_join_materialize

# The JAX fuzzer's fixed shape set (compile reuse on its TPU): the same
# shapes here, so that a seed draws the same case in both fuzzers.
FIXED_SHAPES = [(7, 100_000), (1_000, 5_000), (30_000, 60_000),
                (50_000, 50_000), (65_536, 131_072), (200_000, 400_000),
                (40_000, 262_144),   # BLOCKWISE probe mode band
                (16_385, 262_144),   # blockwise lower edge (just past SMALL)
                (63_488, 133_000),   # blockwise S=62 cap + 1928-row ragged tail
                (40_000, 131_073),   # 1-row ragged tail past 2 full blocks
                (400_000, 400_000)]  # large dense-bitmap band (dense_wide)

STRATEGIES = ["adaptive", "partitioned", "merge", "global", "vmem", "direct"]


def gen_case(rng, fixed_shapes=False):
    """(dist, build_keys, build_values, probe_keys) drawn from `rng`,
    draw for draw as the JAX fuzzer's gen_case."""
    if fixed_shapes:
        nb, npr = FIXED_SHAPES[int(rng.integers(0, len(FIXED_SHAPES)))]
    # mostly small/medium, occasionally large enough to exercise the
    # sorted-window paths (W >= 2, wstart clipping, ladder retries)
    elif rng.integers(0, 4) == 0:
        nb = int(rng.integers(20_000, 300_000))
        npr = int(rng.integers(1, 500_000))
    else:
        nb = int(rng.integers(1, 60_000))
        npr = int(rng.integers(1, 120_000))
    dist = rng.choice(["uniform", "narrow", "dense", "zipf", "dup_heavy",
                       "sentinel", "tiny_universe", "dense_wide"])
    if dist == "uniform":
        bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
        pk = rng.integers(0, 2**63, npr, dtype=np.uint64)
    elif dist == "narrow":
        u = int(rng.integers(2, 2**31))
        bk = rng.integers(0, u, nb, dtype=np.uint64)
        pk = rng.integers(0, u, npr, dtype=np.uint64)
    elif dist == "dense":
        base = int(rng.integers(0, 2**40))
        bk = (rng.integers(0, max(nb // 2, 2), nb) + base).astype(np.uint64)
        pk = rng.integers(0, 2**41, npr, dtype=np.uint64)
    elif dist == "zipf":
        bk = np.minimum(rng.zipf(1.3, nb), 2**50).astype(np.uint64)
        pk = np.minimum(rng.zipf(1.3, npr), 2**50).astype(np.uint64)
    elif dist == "dup_heavy":
        uniq = max(int(rng.integers(1, 50)), 1)
        pool = rng.integers(0, 2**62, uniq, dtype=np.uint64)
        bk = rng.choice(pool, nb)
        pk = rng.choice(pool, npr)
    elif dist == "sentinel":
        bk = rng.integers(0, 1000, nb, dtype=np.uint64)
        pk = rng.integers(0, 1200, npr, dtype=np.uint64)
        for arr in (bk, pk):
            hits = rng.integers(0, len(arr), max(len(arr) // 50, 1))
            arr[hits] = rng.choice(
                np.array([2**64 - 1, 2**32 - 1, 0], np.uint64), len(hits))
    elif dist == "dense_wide":
        # spans past 2^20 slots (the JAX package's large dense-bitmap band,
        # K1's here); a third of the time with a wide gap carved out of the
        # key space.  Random mode keeps the JAX fuzzer's one shape, which
        # bounds its interpreted kernel's compile time on the CPU.
        if not fixed_shapes:
            nb, npr = 40_000, 65_536
            span = int(rng.integers((1 << 20) + 1, 1 << 21))
        else:
            span = int(rng.integers((1 << 20) + 1, 1 << 22))
        base = int(rng.integers(0, 2**31))
        bk = (rng.integers(0, span, nb) + base).astype(np.uint64)
        pk = (rng.integers(0, int(span * 1.2) + 1, npr) + base).astype(
            np.uint64)
        if rng.integers(0, 3) == 0:
            lo, hi = int(span * 0.3), int(span * 0.9)
            for arr in (bk, pk):
                m = (arr - base >= lo) & (arr - base < hi)
                arr[m] += np.uint64(hi - lo)
    else:  # tiny_universe
        u = int(rng.integers(1, 6))
        bk = rng.integers(0, u, nb, dtype=np.uint64)
        pk = rng.integers(0, u + 2, npr, dtype=np.uint64)
    if bool(rng.integers(0, 2)):
        bv = rng.integers(0, 2**31, nb, dtype=np.uint64)   # narrow values
    else:
        bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    return dist, bk, bv, pk


def strategies_for(it: int, bk, bv, pk) -> tuple[str, str]:
    """(count strategy, materialize strategy) of iteration `it`: the
    rotation, vmem only on builds of at most 40000 rows probed at least
    twice over (past its slots it reruns on merge), direct only where the
    port takes the domain, else merge."""
    strat = STRATEGIES[it % len(STRATEGIES)]
    if strat == "vmem" and (len(bk) > 40_000 or len(pk) < 2 * len(bk)):
        strat = "merge"
    if strat != "direct":
        return strat, strat
    return tuple("direct" if api._dense_rung(mode, bk, bv)[0] else "merge"
                 for mode in ("count", "materialize"))


@contextlib.contextmanager
def chunked_plans():
    """Plan 2-4 probe chunks (state["chunks"]) for every adaptive or
    partitioned join of at least 4096 probe rows that would run in one
    shot, and let the caller set FHJ_CHUNK_OVERLAP; both restored after."""
    real, state = api.choose_plan, {"chunks": 2}
    overlap = os.environ.get("FHJ_CHUNK_OVERLAP")

    def plan(nb, npr, cfg, mode, budget):
        p = real(nb, npr, cfg, mode, budget)
        if npr >= 4_096 and p.probe_chunks == 1:
            p = dataclasses.replace(p, probe_chunks=state["chunks"])
        return p

    api.choose_plan = plan
    try:
        yield state
    finally:
        api.choose_plan = real
        if overlap is None:
            os.environ.pop("FHJ_CHUNK_OVERLAP", None)
        else:
            os.environ["FHJ_CHUNK_OVERLAP"] = overlap


def check_case(bk, bv, pk, strat: str, mat_strat: str, device) -> int:
    """Run the count and the materialize; raises AssertionError on any
    disagreement with the oracle.  Returns the most probe chunks either
    join streamed."""
    ok_ref, ov_ref = host_join_materialize(bk, bv, pk)
    want = len(ok_ref)
    c, _, info = api.join_count(bk, bv, pk, strategy=strat, device=device,
                                return_info=True)
    if c != want:
        raise AssertionError(f"count {c} != {want}")
    c2, _, keys, vals, minfo = api.join_materialize(
        bk, bv, pk, strategy=mat_strat, return_arrays=True, device=device,
        return_info=True)
    if c2 != want:
        raise AssertionError(f"mat count {c2} != {want}")
    if not np.array_equal(np.sort(keys), np.sort(ok_ref)):
        raise AssertionError("key multiset")
    if not np.array_equal(pair_multiset(keys, vals),
                          pair_multiset(ok_ref, ov_ref)):
        raise AssertionError("(key, value) multiset")
    return max(i["probe_chunks"] if i else 1 for i in (info, minfo))


def run_fuzz(iters: int, seed: int = 0, *, fixed_shapes: bool = False,
             chunked: bool = False, device="cuda", log=print) -> dict:
    """Iterations seed .. seed + iters - 1; returns {iters, fails, seconds,
    streamed (iterations whose join ran in 2 or more probe chunks),
    strategies (iterations a count strategy)}.  Each failure logs a
    `FAIL seed=...` line."""
    t0 = time.perf_counter()
    fails = streamed = 0
    ran: dict = {}
    with chunked_plans() if chunked else contextlib.nullcontext() as state:
        for it in range(iters):
            case_seed = seed + it
            dist, bk, bv, pk = gen_case(np.random.default_rng(case_seed),
                                        fixed_shapes)
            strat, mat_strat = strategies_for(it, bk, bv, pk)
            ran[strat] = ran.get(strat, 0) + 1
            if chunked:
                # chunk counts 2, 3, 4 and overlap on / off in turns
                state["chunks"] = 2 + (it % 3)
                os.environ["FHJ_CHUNK_OVERLAP"] = "01"[it % 2]
            try:
                streamed += check_case(bk, bv, pk, strat, mat_strat,
                                       device) >= 2
            except Exception as e:     # a failure of this case: log, go on
                fails += 1
                log(f"FAIL seed={case_seed} dist={dist} strat={strat} "
                    f"nb={len(bk)} npr={len(pk)}: {e!r}")
            if (it + 1) % 20 == 0:
                log(f"[{it + 1}/{iters}] {time.perf_counter() - t0:.0f}s "
                    f"fails={fails}")
    return {"iters": iters, "fails": fails,
            "seconds": time.perf_counter() - t0, "streamed": streamed,
            "strategies": ran}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fixed-shapes", action="store_true",
                    help="draw shapes from FIXED_SHAPES")
    ap.add_argument("--chunked", action="store_true",
                    help="force host-side probe-chunk streaming (2-4 "
                         "chunks, overlapped and serial in turns) on every "
                         "adaptive or partitioned iteration of at least "
                         "4096 probe rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where each kernel's plain "
                         "PyTorch version runs")
    args = ap.parse_args(argv)
    api.initialize(device=args.device)
    res = run_fuzz(args.iters, args.seed, fixed_shapes=args.fixed_shapes,
                   chunked=args.chunked, device=args.device,
                   log=lambda s: print(s, flush=True))
    print(f"DONE {res['iters']} iters, {res['fails']} failures, "
          f"{res['streamed']} streamed, strategies {res['strategies']}, "
          f"{res['seconds']:.1f}s", flush=True)
    sys.exit(1 if res["fails"] else 0)


if __name__ == "__main__":
    main()
