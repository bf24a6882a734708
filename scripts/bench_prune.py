#!/usr/bin/env python3
"""The `global` tier's bloom prune on the card, at BASELINE config #3's
size (1e7 build x 1e9 probe rows, 5 % match, misses below 2^62).

    python3 scripts/bench_prune.py [--probe-rows N] [--reps R]

Prints one JSON line a measurement (CUDA events, the median of R calls
after a warm-up, ms):
  prune      fhj_global_prune over every pass of the probe side, on the
             bloom words narrowed to u32 (the path's), and on them at 10
             group bits (the words stay in L1: what the gather from L2
             costs beside the rest); the bytes each reads at least (8 B a
             probe row) at the HBM peak over its time;
  narrow     the bloom words' narrowing alone (one pass's share of it);
  count      ops/cuda/hash_walk.global_walk_count with bloom (the pruned
             passes) against the same walk entry with the bloom tested in
             the slice walk (every row partitioned, no prune), the counts
             equal; and the pruned count's device time by kernel, profiled.
Then the card's name and power limit.  Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flash_hash_join_tpu_torch.ops import hash_table as ht  # noqa: E402
from flash_hash_join_tpu_torch.ops.cuda import _build  # noqa: E402
from flash_hash_join_tpu_torch.ops.cuda import hash_walk as hw  # noqa: E402
from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG  # noqa: E402
from flash_hash_join_tpu_torch.utils.u64 import narrow  # noqa: E402

HBM = 3.35e12


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def planes(keys: torch.Tensor):
    return narrow(keys >> 32), narrow(keys & 0xFFFFFFFF)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build-rows", type=int, default=10_000_000)
    ap.add_argument("--probe-rows", type=int, default=1_000_000_000)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    dev = torch.device("cuda")
    g = torch.Generator(dev)
    g.manual_seed(25)
    nb, npr = a.build_rows, a.probe_rows
    bk = torch.randint(0, 1 << 62, (nb,), generator=g, device=dev)
    bv = torch.randint(0, 1 << 62, (nb,), generator=g, device=dev)
    pk = torch.randint(0, 1 << 62, (npr,), generator=g, device=dev)
    hits = npr // 20
    pk[:hits] = bk[torch.randint(0, nb, (hits,), generator=g, device=dev)]
    pk = pk[torch.randperm(npr, generator=g, device=dev)]
    ph, pl = planes(pk)
    del pk
    cfg = DEFAULT_CONFIG
    gbits = cfg.group_bits(nb)
    static = dict(gbits=gbits, group_size=cfg.group_size,
                  total_groups=(1 << gbits) + cfg.overflow_groups,
                  use_bloom=True, bloom_k=cfg.bloom_k,
                  max_iters=cfg.max_probe_iters, pre_shift=0)
    table = ht.build_table(*planes(bk), *planes(bv), nb, gbits=gbits,
                           group_size=cfg.group_size,
                           overflow_groups=cfg.overflow_groups,
                           with_bloom=True, bloom_k=cfg.bloom_k,
                           max_probe_iters=cfg.max_probe_iters)
    lib = _build.lib()
    props = torch.cuda.get_device_properties(dev)
    p = hw.plan(npr, gbits, static["total_groups"], cfg.group_size, True,
                False, l2_bytes=props.L2_cache_size,
                sms=props.multi_processor_count)
    emit(cell="config3", nb=nb, npr=npr, gbits=gbits, plan=p._asdict())
    pass_rows = p.pass_rows
    sh, sl = torch.empty((2, pass_rows), dtype=torch.int32, device=dev)
    rows = torch.empty(2, dtype=torch.int32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    words = table.bloom.to(torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def prune_all(bloom, w, bits):
        def run():
            for p0 in range(0, npr, pass_rows):
                n = min(pass_rows, npr - p0)
                _build.check(lib.fhj_global_prune(
                    bloom, w, static["total_groups"],
                    table.special.data_ptr(), bits, 0, cfg.bloom_k,
                    ph.data_ptr() + 4 * p0, pl.data_ptr() + 4 * p0, n,
                    sh.data_ptr(), sl.data_ptr(), rows.data_ptr(),
                    count.data_ptr(), None, stream), "global_prune")
        return run

    for name, bits in (("u32", gbits), ("u32_l1", 10)):
        ms = cuda_ms(prune_all(None, words.data_ptr(), bits), a.reps)
        emit(part="prune", words=name, ms=ms,
             survivors_last_pass=int(rows[1]),
             hbm_share=100 * 8 * npr / HBM / (ms / 1e3))

    def narrow_once():
        _build.check(lib.fhj_global_prune(
            table.bloom.data_ptr(), words.data_ptr(), static["total_groups"],
            table.special.data_ptr(), gbits, 0, cfg.bloom_k, ph.data_ptr(),
            pl.data_ptr(), 0, sh.data_ptr(), sl.data_ptr(), rows.data_ptr(),
            count.data_ptr(), None, stream), "global_prune")
    emit(part="narrow", ms=cuda_ms(narrow_once, a.reps))

    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    pruned = int(hw.global_walk_count(table, ph, pl, npr, stats=stats,
                                      **static))
    scratch = torch.empty(lib.fhj_global_walk_scratch_bytes(gbits, *p, 0),
                          dtype=torch.uint8, device=dev)

    def in_walk():
        c = torch.zeros((), dtype=torch.int64, device=dev)
        _build.check(lib.fhj_global_walk_count(
            table.keys.data_ptr(), table.bloom.data_ptr(),
            table.special.data_ptr(), static["total_groups"], cfg.group_size,
            gbits, 0, cfg.bloom_k, cfg.max_probe_iters, ph.data_ptr(),
            pl.data_ptr(), npr, c.data_ptr(), None, *p, scratch.data_ptr(),
            scratch.numel(), None, stream), "global_walk_count")
        return c
    unpruned = int(in_walk())
    emit(part="count", pruned_count=pruned, in_walk_count=unpruned,
         bloom_passed=stats[2].item(), bloom_passed_share=stats[2].item() / npr,
         pruned_ms=cuda_ms(lambda: hw.global_walk_count(table, ph, pl, npr,
                                                        **static), a.reps),
         in_walk_ms=cuda_ms(in_walk, a.reps))
    assert pruned == unpruned, (pruned, unpruned)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hw.global_walk_count(table, ph, pl, npr, **static)
        torch.cuda.synchronize()
    by = defaultdict(float)
    for e in prof.key_averages():
        if e.device_time_total > 0:
            by[e.key[:60]] += e.device_time_total / 1e3
    emit(part="count_by_kernel", ms=dict(sorted(by.items(),
                                                key=lambda kv: -kv[1])))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
