#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flash_hash_join_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, one JSON line each on stdout:
  1. env      torch/CUDA versions, the card, nvcc, and the kernels' build
              from the checkout's csrc/ (seconds, ptxas register report).
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              card (exact counts) at every bitmap rung the path uses, then
              both timed (CUDA events, median of 5 after a warm-up) on the
              main path's own index streams.
  3. main     adaptive_join_count(device="cuda") on the db-benchmark J1
              cells: 4e7 Q1, Q2, Q5 (j1_suite seed 0), bench.py's 4e7 case
              (default_rng(2026)) and 1e8 Q5.  Each count must equal
              np.isin(pk, np.unique(bk)).sum(), route "direct" with no
              merge retry, and launch its kernel.  Best of 3 after a
              warm-up: core_seconds (device time) and probe rows/s.
  4. fallback a sparse 64-bit case routed to the exact merge join.
Then the kernels summary, the card's name and power limit as nvidia-smi
prints them, and last {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and the last line is
not printed.  Without a CUDA card, or outside a checkout, it exits 1
before doing anything.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SENTINEL = 0xFFFFFFFF
K1_REPLACES = "flash_hash_join_tpu/ops/pallas/dense_bitmap.py:159"
K2_REPLACES = "flash_hash_join_tpu/ops/pallas/bitmap_probe.py:149"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() on the card, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def domain_indices(bk: np.ndarray, pk: np.ndarray):
    """The main path's K1/K2 inputs, computed independently in numpy:
    lo-relative u32 domain indices of both sides and the bitmap rung."""
    from flash_hash_join_tpu_torch.ops import direct_bitmap as db
    lo = bk.min()
    d_rows = db.d_rows_for(int(bk.max() - lo) + 1)
    d_bits = np.uint64(d_rows * 4096)
    bidx = (bk - lo).astype(np.uint32)
    pd = pk - lo                                       # wraps below lo
    pidx = np.where((pk >= lo) & (pd < d_bits), pd, SENTINEL)
    return bidx, pidx.astype(np.uint32), d_rows


def random_indices(rng, n: int, n_bits: int, dev):
    from flash_hash_join_tpu_torch.utils.u64 import to_device
    idx = rng.integers(0, n_bits, n, dtype=np.uint32)
    idx[rng.random(n) < 0.05] = SENTINEL
    idx[:3] = n_bits + 7                               # out of the domain
    return to_device(idx, dev)


def phase_env():
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    report = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         nvidia_smi=run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"]),
         nvcc=run([_build._nvcc(), "--version"]).splitlines()[-1],
         build_seconds=build_s, ptxas=ptxas_usage(report))


def ptxas_usage(report: str) -> dict:
    """Kernel name -> ptxas's register/shared-memory line, from nvcc -v."""
    usage, kernel = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"([a-z_]+_kernel)E", line)
            kernel = found.group(1) if found else line.split("'")[1]
        elif "Used" in line and kernel:
            usage[kernel] = line.split(":", 1)[1].strip()
    return usage


def phase_kernels(cells: dict) -> dict:
    """Kernel == plain at every rung; then both timed on main-path inputs.
    Returns the per-kernel summary fields (max_abs_err, ms, plain_ms)."""
    import torch
    from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
    from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
    from flash_hash_join_tpu_torch.utils.u64 import to_device
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    err = {"bitmap_probe": 0, "dense_bitmap": 0}
    checked = []

    for d_rows in (8, 16, 128, 256):
        bitmap = to_device(rng.integers(0, 2**32, (d_rows, 128),
                                        dtype=np.uint32), dev)
        for n in (1, 3, 4_000_037):
            idx = random_indices(rng, n, d_rows * 4096, dev)
            for view in (idx, idx[1:]):                # ragged, misaligned
                got = int(bp.probe_count_bitmap(bitmap, view, d_rows))
                want = int(bp.probe_count_bitmap_plain(bitmap, view, d_rows))
                err["bitmap_probe"] = max(err["bitmap_probe"],
                                          abs(got - want))
                checked.append(["bitmap_probe", d_rows, view.numel(), got,
                                want])
    for d_rows in (512, 16384, 28672):
        n_bits = d_rows * 4096
        for nb, npr in ((20_000_001, 30_000_005), (0, 1_000), (1_000, 0),
                        (5, 7)):
            bidx = random_indices(rng, nb, n_bits, dev)
            pidx = random_indices(rng, npr, n_bits, dev)
            got = int(dbm.fused_bitmap_join(bidx, pidx, d_rows)[0])
            want = int(dbm.fused_bitmap_join_plain(bidx, pidx, d_rows))
            err["dense_bitmap"] = max(err["dense_bitmap"], abs(got - want))
            checked.append(["dense_bitmap", d_rows, nb, npr, got, want])
    torch.cuda.synchronize()
    require(err == {"bitmap_probe": 0, "dense_bitmap": 0},
            f"kernel != plain: {checked}")
    emit("kernels_vs_plain", tolerance="exact (integer counts)",
         max_abs_err=err, cases=len(checked))

    timing = {}
    for name in ("4e7-Q1", "4e7-Q2", "4e7-Q5", "1e8-Q5"):
        bidx_np, pidx_np, d_rows = domain_indices(
            cells[name].build_keys, cells[name].probe_keys)
        bidx, pidx = to_device(bidx_np, dev), to_device(pidx_np, dev)
        if d_rows <= bp.MAX_D_ROWS:
            kernel = "bitmap_probe"
            bitmap = dbm.pack_bitmap(bidx, d_rows)
            got = int(bp.probe_count_bitmap(bitmap, pidx, d_rows))
            want = int(bp.probe_count_bitmap_plain(bitmap, pidx, d_rows))
            ms = cuda_ms(lambda: bp.probe_count_bitmap(bitmap, pidx, d_rows))
            plain_ms = cuda_ms(
                lambda: bp.probe_count_bitmap_plain(bitmap, pidx, d_rows))
        else:
            kernel = "dense_bitmap"
            got = int(dbm.fused_bitmap_join(bidx, pidx, d_rows)[0])
            want = int(dbm.fused_bitmap_join_plain(bidx, pidx, d_rows))
            ms = cuda_ms(lambda: dbm.fused_bitmap_join(bidx, pidx, d_rows))
            plain_ms = cuda_ms(
                lambda: dbm.fused_bitmap_join_plain(bidx, pidx, d_rows))
        require(got == want, f"{kernel} {name}: kernel {got} != plain {want}")
        err[kernel] = max(err[kernel], abs(got - want))
        timing[name] = dict(kernel=kernel, d_rows=d_rows, nb=bidx.numel(),
                            npr=pidx.numel(), ms=ms, plain_ms=plain_ms)
        emit("kernel_time", cell=name, **timing[name])
        del bidx, pidx
    return {"dense_bitmap": dict(max_abs_err=err["dense_bitmap"],
                                 ms=timing["4e7-Q5"]["ms"],
                                 plain_ms=timing["4e7-Q5"]["plain_ms"],
                                 at="J1 4e7 Q5, d_rows 16384"),
            "bitmap_probe": dict(max_abs_err=err["bitmap_probe"],
                                 ms=timing["4e7-Q2"]["ms"],
                                 plain_ms=timing["4e7-Q2"]["plain_ms"],
                                 at="J1 4e7 Q2, d_rows 16")}


def phase_main(cells: dict) -> dict:
    import torch
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
    from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
    expect = {"4e7-Q1": "bitmap_probe", "4e7-Q2": "bitmap_probe",
              "4e7-Q5": "dense_bitmap", "bench-4e7": "dense_bitmap",
              "1e8-Q5": "dense_bitmap"}
    oracle = {name: int(np.isin(c.probe_keys, np.unique(c.build_keys)).sum())
              for name, c in cells.items()}
    dbm.fused_bitmap_join.launches = 0
    bp.probe_count_bitmap.launches = 0
    for name, c in cells.items():
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(4):                             # warm-up + 3
            t0 = time.perf_counter()
            count, secs, info = ft.adaptive_join_count(
                c.build_keys, c.build_values, c.probe_keys, device="cuda",
                return_info=True)
            runs.append((secs, time.perf_counter() - t0))
            require(count == oracle[name],
                    f"{name}: count {count} != oracle {oracle[name]}")
            require(info["strategy"] == "direct" and not info["retried"],
                    f"{name}: routed {info}")
            require(info["launches"][expect[name]] > 0,
                    f"{name}: {expect[name]} not launched: {info}")
        core = min(r[0] for r in runs[1:])
        emit("main", cell=name, nb=len(c.build_keys), npr=len(c.probe_keys),
             count=count, oracle=oracle[name], strategy=info["strategy"],
             d_rows=info["d_rows"], launches=info["launches"],
             core_seconds=core, probe_rows_per_s=len(c.probe_keys) / core,
             wall_seconds=min(r[1] for r in runs[1:]),
             core_seconds_runs=[r[0] for r in runs],
             peak_device_bytes=torch.cuda.max_memory_allocated())
    launches = {"dense_bitmap": dbm.fused_bitmap_join.launches,
                "bitmap_probe": bp.probe_count_bitmap.launches}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    return launches


def phase_fallback():
    import flash_hash_join_tpu_torch as ft
    from flash_hash_join_tpu_torch.models.workload import uniform_case
    c = uniform_case(1_000_000, 10_000_000, 0.05)
    want = int(np.isin(c.probe_keys, np.unique(c.build_keys)).sum())
    count, secs, info = ft.adaptive_join_count(
        c.build_keys, c.build_values, c.probe_keys, device="cuda",
        return_info=True)
    require(count == want, f"merge fallback: count {count} != oracle {want}")
    require(info["strategy"] == "merge", f"fallback routed {info}")
    emit("fallback", cell="uniform 1e6 x 1e7, 5% match, 64-bit keys",
         count=count, oracle=want, strategy=info["strategy"],
         core_seconds=secs, probe_rows_per_s=len(c.probe_keys) / secs)


def make_cells() -> dict:
    from flash_hash_join_tpu_torch.models.workload import JoinCase, j1_suite
    q1, q2, q5 = j1_suite(40_000_000, seed=0)
    n = 40_000_000                                     # bench.py:50-54
    rng = np.random.default_rng(2026)
    bench = JoinCase("bench-4e7",
                     rng.integers(0, int(n * 1.1), n, dtype=np.uint64),
                     rng.integers(0, 2**63, n, dtype=np.uint64),
                     rng.integers(0, int(n * 1.1), n, dtype=np.uint64))
    xl = j1_suite(100_000_000, seed=0)[2]
    return {"4e7-Q1": q1, "4e7-Q2": q2, "4e7-Q5": q5, "bench-4e7": bench,
            "1e8-Q5": xl}


def main() -> int:
    if not (ROOT / "flash_hash_join_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it inside a checkout of the repository "
              "(flash_hash_join_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    phase_env()
    cells = make_cells()
    emit("data", seconds=time.perf_counter() - t0)
    summary = phase_kernels(cells)
    launches = phase_main(cells)
    phase_fallback()
    src = "flash_hash_join_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "fused_bitmap_join", "route": "cuda",
         "source": src + "dense_bitmap.cu", "replaces": K1_REPLACES,
         "launches": launches["dense_bitmap"], **summary["dense_bitmap"]},
        {"name": "probe_count_bitmap", "route": "cuda",
         "source": src + "bitmap_probe.cu", "replaces": K2_REPLACES,
         "launches": launches["bitmap_probe"], **summary["bitmap_probe"]},
    ]}), flush=True)
    print(run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
