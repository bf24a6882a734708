"""Direct-vs-partitioned crossover sweep of the adaptive gates: the port's
twin of the JAX package's scripts/profile_crossover.py (the large band's
(nb, npr) surface), scripts/profile_direct.py (J1 counts and the scan
band's spans) and scripts/profile_dense_mat.py (dense materialize by
value-plane rung), merged into one module with a --mode flag.

At each point the same build and probe columns run through `adaptive`
(its route printed), `direct` and `partitioned`.  Each strategy is timed
by the API's own core_seconds, the best of --repeats (10) calls after a
warm-up call, the strategies called in turns, with
measure_device_seconds' device time beside it.  Every
count is checked against the port's C++ host oracle
(utils/native.host_join_count); a materialize also checks its rows, in
probe order, against utils/native.host_join_materialize up to
CHECK_ROWS_MAX probe rows.  One line a point:

    RESULT,mode=..,case=..,nb=..,npr=..,span=..,rung=d_rows:N|v_rows:N,
        band=scan|large|staged|none,values=narrow|u64,count=..,
        adaptive_route=..,<strategy>_core_ms=..,<strategy>_device_ms=..,
        winner=direct|partitioned,margin=..,adaptive_over_best=..

winner and margin compare direct with partitioned by core (margin: the
slower's core over the faster's, less 1); adaptive_over_best is
adaptive's core over the faster of the two, less 1.  A point where
direct does not take the keys prints direct_core_ms=skip.  Keys are
uniform over a span, drawn with default_rng(seed) as the JAX scripts draw
them; the J1 points are models/workload.j1_suite(n, seed), the cells of
chip_smoke.py.  Any wrong count or row exits 1.

Without grid flags each mode runs its default grid (count: J1 shapes at
1e5-1e8, the large band's nb x npr, spans beside 2^19 and 2^20, probe
sides of 1e4-2.5e5 rows; materialize: v_rows 8-8192 x npr 6.5e4-1e8 with
narrow and u64 values, and the J1 shapes at 1e7-1e8).  To see why a
route loses, set FHJ_PROFILE_DIR: each single-shot join then writes a
torch.profiler trace of its timed call there (api._maybe_profile), whose
gaps between kernels are the host's dispatch.

Usage:
  python3 -m flash_hash_join_tpu_torch.harness.crossover --mode count
  python3 -m flash_hash_join_tpu_torch.harness.crossover --mode materialize
  python3 -m flash_hash_join_tpu_torch.harness.crossover --mode count \\
      --nb 2.5e6 1e7 --npr 1e7 4e7
  python3 -m flash_hash_join_tpu_torch.harness.crossover --mode materialize \\
      --v-rows 8 512 --npr 1e6 1e7 --values u64
  python3 -m flash_hash_join_tpu_torch.harness.crossover --mode count \\
      --j1 1e5 --device cpu --repeats 1
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys

import numpy as np
import torch

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch import api
from flash_hash_join_tpu_torch.models.workload import j1_suite
from flash_hash_join_tpu_torch.ops import direct_bitmap as db
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.utils import native

STRATEGIES = ("adaptive", "direct", "partitioned")
WIDE_VALUE_MAX = 2**45      # scripts/profile_dense_mat.py --wide
# A materialize's rows are checked up to this many probe rows: past it the
# oracle's rows and the three strategies' read-backs would double a 1e8
# point's time.
CHECK_ROWS_MAX = 40_000_000


@dataclasses.dataclass(frozen=True)
class Point:
    """One point of the sweep: J1 shapes (j1 = n) come from j1_suite, the
    rest draw nb build and npr probe keys uniform over [0, span), the
    build's min and max pinned to 0 and span - 1 so that the rung is the
    span's."""
    mode: str
    nb: int
    npr: int
    span: int
    wide: bool = False
    j1: int = 0
    q: str = ""

    @property
    def case(self) -> str:
        if self.j1:
            return f"J1-{self.j1:.0e}-{self.q}".replace("+", "")
        return f"nb{self.nb}-npr{self.npr}-span{self.span}"


def j1_points(mode: str, ns, wide: bool = False) -> list[Point]:
    pts = []
    for n in ns:
        for q, ratio in (("Q1", 1_000_000), ("Q2", 1_000), ("Q5", 1)):
            nb = max(n // ratio, 1)
            pts.append(Point(mode, nb, n, max(int(nb * 1.1), 2), wide, n, q))
    return pts


def mat_span(v_rows: int) -> int:
    """A span whose value-plane rung is v_rows (0.9 of its slots)."""
    return int(v_rows * db.LANES * 0.9)


def default_points(mode: str) -> list[Point]:
    if mode == "count":
        pts = j1_points("count", (100_000, 1_000_000, 4_000_000, 10_000_000,
                                  20_000_000, 40_000_000, 100_000_000))
        for nb in (2_500_000, 10_000_000, 40_000_000):       # large band
            for npr in (1_000_000, 10_000_000, 40_000_000, 100_000_000):
                pts.append(Point("count", nb, npr, int(nb * 1.1)))
        for edge in (1 << 19, 1 << 20):                      # scan cap
            for span in (edge - 4096, edge + 4096):
                for npr in (1_000_000, 40_000_000):
                    pts.append(Point("count", 40_000, npr, span))
        for nb in (1_000, 100_000, 2_500_000):               # probe floor
            for npr in (10_000, 30_000, 65_536, 130_000, 250_000):
                pts.append(Point("count", nb, npr, int(nb * 1.1)))
        return pts
    pts = []
    for wide in (False, True):
        for v_rows in (8, 16, 64, 128, 256, 512, 1024, 8192):
            span = mat_span(v_rows)
            for npr in (65_000, 250_000, 1_000_000, 4_000_000, 10_000_000,
                        40_000_000, 100_000_000):
                pts.append(Point("materialize", int(span / 1.1), npr, span,
                                 wide))
    return pts + j1_points("materialize", (10_000_000, 40_000_000,
                                           100_000_000))


def grid_points(mode: str, nbs, nprs, spans, v_rows, wides) -> list[Point]:
    """The product grid of the flags: spans from --span, or --v-rows
    (materialize), or 1.1 x nb; nb from --nb, or span / 1.1."""
    if v_rows:
        spans = [mat_span(v) for v in v_rows]
    pairs = ([(nb, s) for nb in nbs for s in spans] if nbs and spans
             else [(nb, max(int(nb * 1.1), 2)) for nb in nbs] if nbs
             else [(max(int(s / 1.1), 1), s) for s in spans])
    return [Point(mode, nb, npr, span, wide) for nb, span in pairs
            for npr in nprs for wide in wides]


def make_data(p: Point, seed: int, j1_cache: dict):
    """(build_keys, build_values, probe_keys) of a point."""
    if p.j1:
        if p.j1 not in j1_cache:
            j1_cache.clear()                   # one n's suite at a time
            j1_cache[p.j1] = {c.name[-2:]: c for c in j1_suite(p.j1, seed)}
        c = j1_cache[p.j1][p.q]
        bv = c.build_values
        if p.wide:
            bv = np.random.default_rng(seed).integers(
                1, WIDE_VALUE_MAX + 1, len(bv), dtype=np.uint64)
        return c.build_keys, bv, c.probe_keys
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, p.span, p.nb, dtype=np.uint64)
    if p.nb >= 2:
        bk[0], bk[-1] = 0, p.span - 1
    bv = rng.integers(1, (WIDE_VALUE_MAX if p.wide else 100) + 1, p.nb,
                      dtype=np.uint64)
    pk = rng.integers(0, p.span, p.npr, dtype=np.uint64)
    return bk, bv, pk


def rung_and_band(mode: str, bk, bv) -> tuple[str, str]:
    rung = api._dense_rung(mode, bk, bv)[0]
    if not rung:
        return "none", "none"
    if mode == "count":
        return (f"d_rows:{rung}",
                "scan" if rung <= bp.MAX_D_ROWS else "large")
    return (f"v_rows:{rung}",
            "scan" if rung <= db.MAT_SCAN_MAX_V_ROWS else "staged")


class WrongResult(AssertionError):
    """A strategy's count or rows differ from the oracle's."""


def time_strategies(mode: str, strategies, bk, bv, pk, *, device,
                    repeats: int, want: int, want_rows=None) -> dict:
    """Each strategy's warm-up call (its route), then `repeats` rounds of
    one call each, in turns so that any drift of the card or the host
    reaches every strategy alike: core = a strategy's least core_seconds;
    then its measure_device_seconds' device seconds.  Every count must
    equal `want` and, with want_rows, the rows of one return_arrays call
    equal them.  A strategy's entry is None where direct does not take
    the keys (ValueError)."""
    fn = ft.join_count if mode == "count" else ft.join_materialize
    runs = {}
    for s in strategies:
        try:
            count, _, info = fn(bk, bv, pk, strategy=s, device=device,
                                return_info=True)
        except ValueError:
            if s != "direct":
                raise
            continue
        runs[s] = dict(route=info["strategy"], counts=[count], cores=[])
    for _ in range(repeats):
        for s, r in runs.items():
            c, secs = fn(bk, bv, pk, strategy=s, device=device)
            r["counts"].append(c)
            r["cores"].append(secs)
    out = dict.fromkeys(strategies)
    for s, r in runs.items():
        c, dev_s, _, _ = ft.measure_device_seconds(
            bk, bv, pk, mode=mode, strategy=s, number=repeats,
            device=device)
        if any(c != want for c in r["counts"] + [c]):
            raise WrongResult(f"{s}: counts {r['counts'] + [c]} != oracle "
                              f"{want}")
        if want_rows is not None:
            _, _, keys, vals = ft.join_materialize(
                bk, bv, pk, strategy=s, device=device, return_arrays=True)
            if not (np.array_equal(keys, want_rows[0])
                    and np.array_equal(vals, want_rows[1])):
                raise WrongResult(f"{s}: rows differ from the oracle's")
        out[s] = dict(route=r["route"], core=min(r["cores"] or [dev_s]),
                      device=dev_s)
    return out


def run_point(p: Point, *, strategies=STRATEGIES, device="cuda",
              repeats: int = 10, seed: int = 0,
              j1_cache: dict | None = None) -> dict:
    """Measure one point; returns its row (the RESULT line's fields)."""
    bk, bv, pk = make_data(p, seed, {} if j1_cache is None else j1_cache)
    want = native.host_join_count(bk, pk)
    want_rows = None
    if p.mode == "materialize" and len(pk) <= CHECK_ROWS_MAX:
        want_rows = native.host_join_materialize(bk, bv, pk)
    span = int(bk.max()) - int(bk.min()) + 1
    rung, band = rung_and_band(p.mode, bk, bv)
    row = dict(mode=p.mode, case=p.case, nb=len(bk), npr=len(pk), span=span,
               rung=rung, band=band, values="u64" if p.wide else "narrow",
               count=want, rows_checked=want_rows is not None)
    times = time_strategies(p.mode, strategies, bk, bv, pk, device=device,
                            repeats=repeats, want=want, want_rows=want_rows)
    if "adaptive" in times:
        row["adaptive_route"] = times["adaptive"]["route"]
    for s, t in times.items():
        row[f"{s}_core_ms"] = None if t is None else t["core"] * 1e3
        row[f"{s}_device_ms"] = None if t is None else t["device"] * 1e3
    d, part = times.get("direct"), times.get("partitioned")
    if part is not None:
        if d is None:
            row.update(winner="partitioned", margin=None)
        else:
            fast, slow = sorted((d["core"], part["core"]))
            row.update(winner="direct" if d["core"] < part["core"]
                       else "partitioned", margin=slow / fast - 1)
            if "adaptive" in times:
                row["adaptive_over_best"] = (times["adaptive"]["core"]
                                             / fast - 1)
    return row


def result_line(row: dict) -> str:
    def fmt(v):
        if v is None:
            return "skip"
        return f"{v:.4f}" if isinstance(v, float) else str(v)
    return "RESULT," + ",".join(f"{k}={fmt(v)}" for k, v in row.items())


def card_line(device) -> str:
    """The card and its power limit as nvidia-smi prints them, or CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "CPU"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(dev)


def run_sweep(points, *, strategies=STRATEGIES, device="cuda",
              repeats: int = 10, seed: int = 0, log=print):
    """Run `points`, logging a RESULT line each; returns (rows, ok): ok is
    False when any count or row differed from the oracle's (that point's
    line is then a WRONG line)."""
    rows, ok, j1_cache = [], True, {}
    for p in points:
        try:
            row = run_point(p, strategies=strategies, device=device,
                            repeats=repeats, seed=seed, j1_cache=j1_cache)
        except WrongResult as e:
            ok = False
            log(f"WRONG,mode={p.mode},case={p.case},{e}")
            continue
        rows.append(row)
        log(result_line(row))
    return rows, ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("count", "materialize"),
                    default="count")
    ap.add_argument("--j1", type=float, nargs="*", default=None,
                    help="J1 shapes (Q1, Q2, Q5) at these probe sizes")
    ap.add_argument("--npr", type=float, nargs="*", default=None)
    ap.add_argument("--nb", type=float, nargs="*", default=None)
    ap.add_argument("--span", type=float, nargs="*", default=None)
    ap.add_argument("--v-rows", type=int, nargs="*", default=None,
                    help="materialize: value-plane rungs (span 0.9 of the "
                         "rung's slots, nb span / 1.1)")
    ap.add_argument("--values", choices=("narrow", "u64", "both"),
                    default="narrow",
                    help="build values below 2^32 (one value plane) or up "
                         "to 2^45 (two) for the grid and --j1 points")
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=STRATEGIES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where each kernel's plain "
                         "PyTorch version runs")
    ap.add_argument("--repeats", type=int, default=10,
                    help="timed calls a strategy after its warm-up call, "
                         "the strategies in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    wides = {"narrow": [False], "u64": [True], "both": [False, True]}[
        args.values]
    ints = lambda xs: [int(x) for x in xs or ()]          # noqa: E731
    points = [pt for n in ints(args.j1) for w in wides
              for pt in j1_points(args.mode, [n], w)]
    if args.npr:
        if not (args.nb or args.span or args.v_rows):
            ap.error("--npr needs --nb, --span or --v-rows")
        points += grid_points(args.mode, ints(args.nb), ints(args.npr),
                              ints(args.span), args.v_rows or [], wides)
    if args.j1 is None and not args.npr:
        points = default_points(args.mode)

    ft.initialize(device=args.device)
    print(f"# crossover mode={args.mode} points={len(points)} "
          f"repeats={args.repeats} seed={args.seed} card: "
          f"{card_line(args.device)}", flush=True)
    rows, ok = run_sweep(points, strategies=args.strategies,
                         device=args.device, repeats=args.repeats,
                         seed=args.seed, log=lambda s: print(s, flush=True))
    print(f"DONE {len(rows)} points, "
          f"{'all exact' if ok else 'WRONG results'}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
