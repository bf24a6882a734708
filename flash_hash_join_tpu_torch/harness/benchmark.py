"""End-to-end benchmark and parity harness of the port: the twin of the JAX
package's benchmark.py, with the same flags, impl labels and RESULT lines.

Suites come from db-benchmark J1 CSVs (--data-dir: J1_<n>_<right>_0_0.csv,
each key column read by the port's C++ loader, no pandas) or are generated
(--gen N: models/workload.py, the same arrays for the same seed as the JAX
harness).  Every implementation runs count and materialize, each printing

    RESULT,Library=<label>,Task=<task>,Threads=1,Time=<s>,Core=<s>[,Device=<s>],Result=<count>[,Alias=<label>]

Time is the host clock around the first call; Core the least core_seconds
of `repeats` calls (device time after the host->device copy, CUDA events).
Device (--device-time) is measure_device_seconds' device_seconds: the join
resolved once, then timed again on its device-resident planes, the least
of its calls; the port has no chained graph, so no dispatch overhead is
subtracted.  Each count is checked against the exact oracle, the port's C++
host oracle (utils/native.py), or numpy where that does not build; each
case's log line names the oracle that served it.  Cases with at most
--check-values-max probe rows also check the materialized (key, value)
rows of merge, global and partitioned.  DuckDB's columns appear when
`import duckdb` succeeds.  Any parity failure exits 1.

Usage:
  python3 -m flash_hash_join_tpu_torch.harness.benchmark --gen 1e7
  python3 -m flash_hash_join_tpu_torch.harness.benchmark --data-dir ./data
  python3 -m flash_hash_join_tpu_torch.harness.benchmark --gen 1e5 --device cpu --no-charts
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import time
from collections import defaultdict

import numpy as np
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch.utils import native

# label -> (count function, materialize function, strategy, use_bloom): the
# JAX harness's labels, so that the two harnesses' RESULT lines line up
IMPLS = {
    "adaptive_join": (ft.adaptive_join_count, ft.adaptive_join, "adaptive",
                      False),
    "adaptive_bloom": (ft.adaptive_join_count_bloom, ft.adaptive_join_bloom,
                       "adaptive", True),
    "flash_join": (ft.hash_join_count, ft.hash_join, "global", False),
    "flash_join_radix": (ft.hash_join_count_radix, ft.hash_join_radix,
                         "partitioned", False),
    "flash_join_bloom": (ft.hash_join_count_bloom, ft.hash_join_bloom,
                         "global", True),
    "flash_join_radix_bloom": (ft.hash_join_count_radix_bloom,
                               ft.hash_join_radix_bloom, "partitioned", True),
}


def log(*a):
    print(*a, flush=True)


def run_one(label: str, task: str, fn, oracle_count: int, results: list,
            case: str = "", repeats: int = 2, dev_fn=None, alias: str = "",
            served_by: str = ""):
    """Run fn() -> (count, core_seconds) `repeats` times; print the RESULT
    line and append its row to `results`.  A count that differs between
    calls, or from the oracle's, is a parity failure."""
    t0 = time.perf_counter()
    count, core = fn()
    total = time.perf_counter() - t0
    # Core = best of `repeats` calls, as in the JAX harness (the reference
    # harness times a single call).
    for _ in range(max(repeats - 1, 0)):
        c2, core2 = fn()
        count = count if c2 == count else -1
        core = min(core, core2)
    dev, dsec = "", None
    if dev_fn is not None:
        dcount, dsec, dsingle, _ = dev_fn()
        count = count if dcount == count else -1
        core = min(core, dsingle)
        dev = f",Device={dsec:.4f}"
    # Alias= marks a `_bloom` variant that runs the same join as its plain
    # twin (bloom changes only the global tier).
    anote = f",Alias={alias}" if alias else ""
    log(f"    RESULT,Library={label},Task={task},Threads=1,"
        f"Time={total:.4f},Core={core:.4f}{dev},Result={count}{anote}")
    ok = count == oracle_count
    if not ok:
        log(f"    PARITY FAILURE: {label}/{task}: got {count}, oracle "
            f"{oracle_count}")
    results.append({"label": label, "task": task, "total": total,
                    "core": core, "count": count, "ok": ok, "case": case,
                    "device": dsec, "alias": alias, "oracle": served_by})
    return ok


def duckdb_module():
    """The duckdb module if importable, else None."""
    try:
        import duckdb
        return duckdb
    except Exception:
        return None


def run_duckdb_case(duckdb, case_id, bk, bv, pk, expected, results,
                    threads: int = 0, served_by: str = ""):
    """DuckDB's rows, as the JAX harness makes them: ingest timed apart;
    COUNT(*) of the join = join_count; the join into a TEMP table =
    join_materialize; each also reported as Ingest + Join.  The build side
    keeps the first row of each key, so DuckDB's full inner join counts
    what the first-match join counts.  DuckDB scans pandas DataFrames, so
    this path alone needs pandas."""
    import pandas as pd
    _, first = np.unique(bk, return_index=True)
    sel = np.sort(first)
    build_df = pd.DataFrame({"key": bk[sel], "value": bv[sel]})   # noqa: F841
    probe_df = pd.DataFrame({"key": pk})                          # noqa: F841
    con = duckdb.connect(database=":memory:")
    if threads:
        con.execute(f"PRAGMA THREADS={threads}")
    t0 = time.perf_counter()
    con.execute("CREATE TABLE build_native AS SELECT * FROM build_df;")
    con.execute("CREATE TABLE probe_native AS SELECT * FROM probe_df;")
    t_ingest = time.perf_counter() - t0

    t0 = time.perf_counter()
    dcount = con.execute(
        "SELECT count(*) FROM build_native b JOIN probe_native p "
        "ON b.key = p.key;").fetchone()[0]
    t_count = time.perf_counter() - t0

    t0 = time.perf_counter()
    con.execute(
        "CREATE OR REPLACE TEMPORARY TABLE temp AS SELECT p.key, b.value "
        "FROM build_native b JOIN probe_native p ON b.key = p.key;")
    mcount = con.execute("SELECT count(*) FROM temp").fetchone()[0]
    t_mat = time.perf_counter() - t0
    con.close()

    ok = True
    for label, task, t, cnt in (
            ("duckdb (Join Only)", "join_count", t_count, dcount),
            ("duckdb (Ingest + Join)", "join_count", t_ingest + t_count,
             dcount),
            ("duckdb (Join Only)", "join_materialize", t_mat, mcount),
            ("duckdb (Ingest + Join)", "join_materialize", t_ingest + t_mat,
             mcount)):
        row_ok = cnt == expected
        ok &= row_ok
        log(f"    RESULT,Library={label},Task={task},Threads="
            f"{threads or 'default'},Time={t:.4f},Core={t:.4f},Result={cnt}")
        if not row_ok:
            log(f"    PARITY FAILURE: {label}/{task}: got {cnt}, "
                f"oracle {expected}")
        results.append({"label": label, "task": task, "total": t, "core": t,
                        "count": cnt, "ok": row_ok, "case": case_id,
                        "device": None, "alias": "", "oracle": served_by})
    return ok


def csv_column(path: str, name: str):
    """Column `name` of a headered CSV as uint64, or None when the header
    has no such column.  The header is read here; the values by the C++
    loader, given room for the most rows the file can hold (each row has
    at least one character and one separator a column)."""
    with open(path, "rb") as f:
        header = f.readline()
    names = [h.strip().strip('"') for h in
             header.decode().rstrip("\r\n").split(",")]
    if name not in names:
        return None
    body = os.path.getsize(path) - len(header)
    return native.load_csv_u64(path, names.index(name),
                               max_rows=body // (2 * len(names)) + 1)


def load_csv_suites(data_dir: str):
    """Discover db-benchmark J1 CSV suites, J1_<n>_<right>_0_0.csv grouped
    by n as the JAX harness groups them: for x of n rows, the cases Q1
    (the n / 1e6-row table on id1), Q2 (n / 1e3 rows, id2) and Q5 (n rows,
    id3), build values v2.  x is J1_<n>_NA_0_0.csv, db-benchmark's own
    name for it, or where the set has none J1_<n>_<n>_0_0.csv, the name the
    reference harness reads (its big table then serves as x too)."""
    suites = []
    groups = defaultdict(dict)
    for f in glob.glob(os.path.join(data_dir, "J1_*.csv")):
        m = re.match(r"J1_(\de\d+)_(.+)_0_0\.csv", os.path.basename(f))
        if not m:
            continue
        groups[m.group(1)][m.group(2)] = f
    for gname, files in sorted(groups.items()):
        mantissa, exp = gname.split("e")
        need = {"small": f"{mantissa}e{int(exp) - 6}",
                "medium": f"{mantissa}e{int(exp) - 3}", "big": gname}
        x = files.get("NA", files.get(gname))
        if x is None or not all(v in files for v in need.values()):
            continue
        cases = []
        for qid, right, keycol in (("Q1", "small", "id1"),
                                   ("Q2", "medium", "id2"),
                                   ("Q5", "big", "id3")):
            bfile = files[need[right]]
            bk = csv_column(bfile, keycol)
            bv = csv_column(bfile, "v2")
            pk = csv_column(x, keycol)
            if bk is None or bv is None or pk is None:
                continue
            cases.append((f"{gname}-{qid}", bk, bv, pk))
        suites.append((gname, cases))
    return suites


def gen_suites(n: int, seed: int):
    """The J1-shaped suite of n probe rows (Q1, Q2, Q5) and QB5:
    BASELINE.json config #3's shape scaled, n / 4 build rows at 5 % match,
    where the global tier's bloom filter prunes probe gathers."""
    from flash_hash_join_tpu_torch.models.workload import (j1_suite,
                                                           uniform_case)
    cases = [(c.name, c.build_keys, c.build_values, c.probe_keys)
             for c in j1_suite(n, seed)]
    c = uniform_case(max(n // 4, 1), n, match_rate=0.05, seed=seed)
    cases.append((f"{n:.0e}-QB5".replace("+", ""),
                  c.build_keys, c.build_values, c.probe_keys))
    return [(f"{n:.0e}".replace("+", ""), cases)]


def oracle(bk, pk) -> tuple[int, str]:
    """(first-match count, the oracle that served it): the C++ host oracle,
    numpy where the library does not build."""
    try:
        return native.host_join_count(bk, pk), "native"
    except (OSError, RuntimeError) as e:
        log(f"    native oracle unavailable, numpy serves: {e}")
        return int(np.isin(pk, np.unique(bk)).sum()), "numpy"


def oracle_rows(bk, bv, pk):
    """(keys, values, the oracle that served them): the matched rows in
    probe order, the first build row of a key winning."""
    try:
        return (*native.host_join_materialize(bk, bv, pk), "native")
    except (OSError, RuntimeError) as e:
        log(f"    native oracle unavailable, numpy serves: {e}")
        uniq, first = np.unique(bk, return_index=True)
        mask = np.isin(pk, uniq)
        keys = pk[mask]
        return keys, bv[first[np.searchsorted(uniq, keys)]], "numpy"


def pair_multiset(keys, vals) -> np.ndarray:
    """The (key, value) rows as an (n, 2) array sorted by key, then value."""
    pairs = np.stack([np.asarray(keys, np.uint64),
                      np.asarray(vals, np.uint64)], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def check_values(bk, bv, pk, strategies=("merge", "global", "partitioned"),
                 *, device="cuda", results=None, case: str = "") -> bool:
    """Materialized value parity: each strategy's (key, value) rows, as a
    sorted multiset, equal the oracle's.  Output order differs between
    strategies by contract, the winner among duplicate build keys does not:
    every tier of the port keeps the minimum build row, as the oracle does,
    so the pairs are compared exactly on any build.  Each check is also a
    row of `results` (task "check_values")."""
    ok_ref, ov_ref, served_by = oracle_rows(bk, bv, pk)
    ref_pairs = pair_multiset(ok_ref, ov_ref)
    all_ok = True
    for strat in strategies:
        try:
            count, _, keys, vals = ft.join_materialize(
                bk, bv, pk, strategy=strat, return_arrays=True,
                device=device)
            got = pair_multiset(keys, vals)
            same = count == len(ref_pairs) and np.array_equal(got, ref_pairs)
        except Exception as e:         # report it as a failure, and go on
            log(f"    VALUE CHECK ERROR [{strat}]: {e!r}")
            count, same = -1, False
        log(f"    VALUES,Strategy={strat},Result="
            f"{'OK' if same else 'MISMATCH'}")
        all_ok &= same
        if results is not None:
            results.append({"label": strat, "task": "check_values",
                            "total": None, "core": None, "count": count,
                            "ok": same, "case": case, "device": None,
                            "alias": "", "oracle": served_by})
    return all_ok


def run_suites(suites, impls=None, *, device="cuda",
               check_values_max: int = 4_000_000, device_time: bool = False,
               repeats: int = 2, cases=None, ddb=None,
               duckdb_threads: int = 0):
    """Run every case of `suites` ([(name, [(case_id, bk, bv, pk), ...])])
    through each impl label of `impls` (None: all of IMPLS), count and
    materialize, against the oracle; `cases` keeps the case ids that end
    with one of its suffixes; device_time (on a card only) adds each
    join's measure_device_seconds.  Returns (results, all_ok): the rows of
    run_one, run_duckdb_case and check_values, and whether every one
    agreed with the oracle."""
    impls = list(IMPLS) if impls is None else list(impls)
    unknown = set(impls) - set(IMPLS)
    if unknown:
        raise ValueError(f"unknown impls {sorted(unknown)}; of {list(IMPLS)}")
    if device_time and torch.device(device).type != "cuda":
        log("device time is measured on a card only: no Device= on the CPU")
        device_time = False
    results, all_ok = [], True
    for gname, suite_cases in suites:
        log("=" * 70)
        log(f"Suite {gname}")
        for case_id, bk, bv, pk in suite_cases:
            if cases and not any(case_id.endswith(c) for c in cases):
                continue
            expected, served_by = oracle(bk, pk)
            log(f"-- case {case_id}: build={len(bk)} probe={len(pk)} "
                f"oracle_count={expected} oracle={served_by}")
            for label in impls:
                count_fn, mat_fn, strat, bloom = IMPLS[label]
                alias = ""
                if bloom and not ft.bloom_is_distinct(
                        len(bk), len(pk), "count", strat, device=device):
                    alias = label.replace("_bloom", "").replace(
                        "adaptive", "adaptive_join")
                for task, api_fn, mode in (("join_count", count_fn, "count"),
                                           ("join_materialize", mat_fn,
                                            "materialize")):
                    dev_fn = None
                    if device_time:
                        dev_fn = (lambda m=mode, s=strat, b=bloom:
                                  ft.measure_device_seconds(
                                      bk, bv, pk, mode=m, strategy=s,
                                      use_bloom=b, device=device))
                    all_ok &= run_one(
                        label, task,
                        lambda f=api_fn: f(bk, bv, pk, device=device),
                        expected, results, case=case_id, repeats=repeats,
                        dev_fn=dev_fn, alias=alias, served_by=served_by)
            if ddb is not None:
                all_ok &= run_duckdb_case(ddb, case_id, bk, bv, pk,
                                          expected, results,
                                          threads=duckdb_threads,
                                          served_by=served_by)
            if len(pk) <= check_values_max:
                all_ok &= check_values(bk, bv, pk, device=device,
                                       results=results, case=case_id)
    return results, all_ok


def plot_results(results, task: str, outfile: str, card: str):
    """Grouped bar chart of each case's time by impl (Device where
    measured, else Core), titled with the card's name."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        log(f"matplotlib unavailable; skipping {outfile}")
        return
    rows = [r for r in results if r["task"] == task]
    if not rows:
        return
    cases = sorted({r["case"] for r in rows})
    labels = sorted({r["label"] for r in rows})
    width = 0.8 / max(len(labels), 1)
    fig, ax = plt.subplots(figsize=(max(8, 2.2 * len(cases)), 5))
    for j, label in enumerate(labels):
        xs, ys = [], []
        for i, case in enumerate(cases):
            match = [r for r in rows if r["case"] == case
                     and r["label"] == label]
            if match:
                xs.append(i + j * width)
                ys.append(match[0]["device"] or match[0]["core"])
        bars = ax.bar(xs, ys, width=width, label=label)
        ax.bar_label(bars, fmt="%.4f", fontsize=6, rotation=90, padding=2)
    ax.set_xticks([i + 0.4 for i in range(len(cases))])
    ax.set_xticklabels(cases, fontsize=8)
    ax.set_ylabel("device seconds on resident planes (best of N)"
                  if any(r["device"] for r in rows)
                  else "core seconds (best of N)")
    ax.set_title(f"flash_hash_join_tpu_torch — {task} — {card}", fontsize=10)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(outfile, dpi=120)
    plt.close(fig)
    log(f"wrote {outfile}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", type=str, default=None)
    ap.add_argument("--gen", type=float, default=None,
                    help="generate a J1-shaped suite with this many probe rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impls", nargs="*", default=None)
    ap.add_argument("--cases", nargs="*", default=None,
                    help="run only cases whose id ends with one of these "
                         "suffixes (e.g. --cases Q5 QB5)")
    ap.add_argument("--check-values-max", type=int, default=4_000_000,
                    help="check the materialized values of cases with at "
                         "most this many probe rows")
    ap.add_argument("--no-charts", action="store_true")
    ap.add_argument("--no-duckdb", action="store_true",
                    help="skip the DuckDB columns even when duckdb imports")
    ap.add_argument("--duckdb-threads", type=int, default=0,
                    help="PRAGMA THREADS for DuckDB (0 = its default)")
    ap.add_argument("--device-time", action="store_true",
                    help="also time each join again on its device-resident "
                         "planes (measure_device_seconds), printed as Device=")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where each kernel's plain "
                         "PyTorch version runs")
    args = ap.parse_args(argv)

    ft.initialize(device=args.device)
    card = (torch.cuda.get_device_name(torch.device(args.device))
            if torch.device(args.device).type == "cuda" else "CPU")
    log(f"flash_hash_join_tpu_torch initialized on {card}.")

    if args.data_dir:
        suites = load_csv_suites(args.data_dir)
    else:
        suites = gen_suites(int(args.gen or 1_000_000), args.seed)
    if not suites:
        log("No suites found.")
        sys.exit(1)

    ddb = None if args.no_duckdb else duckdb_module()
    if ddb is not None:
        log("duckdb detected: competitor columns enabled.")

    results, all_ok = run_suites(
        suites, args.impls, device=args.device,
        check_values_max=args.check_values_max,
        device_time=args.device_time, cases=args.cases, ddb=ddb,
        duckdb_threads=args.duckdb_threads)

    log("=" * 70)
    n_fail = sum(1 for r in results if not r["ok"])
    log(f"{len(results)} runs, {n_fail} parity failures")
    if not args.no_charts:
        for task in ("join_count", "join_materialize"):
            plot_results(results, task, f"benchmark_torch_{task}.png", card)
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
