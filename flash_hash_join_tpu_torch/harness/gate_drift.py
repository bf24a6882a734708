"""Gate-drift check of the adaptive dispatcher: the port's twin of the JAX
package's scripts/check_gate_drift.py.

The adaptive tier's direct-vs-partitioned gates (ops/direct_bitmap.py:
ADAPTIVE_MIN_PROBE_ROWS, ADAPTIVE_SCAN_DOMAIN_BITS, LARGE_MIN_PROBE_ROWS /
large_span_wins, MAT_STAGED_MIN_PROBE_ROWS / mat_wins) encode the H100
sweep of harness/crossover.py.  A change to a kernel, to the host work
around one or to the partitioned tier can silently invalidate them.  This
check puts one sentinel point on each side of every gate (a gate the
sweep never found binding: a point at each end of the region it was
measured over) and prints one line a sentinel:

  PASS  the measured winner agrees with the gate's routing decision, or
        the two lie within --tol of each other; adaptive ran the route
        the gate decides; every count equals the C++ host oracle's.
  FAIL  otherwise: rerun the sweep and recalibrate the constant.

then a `total` line; the exit code is 0 only if every line passes.  Each
sentinel sits where the sweep measured a margin of at least 30 %, so the
noise of the cells under 1 ms (10-20 % between turns) cannot flip it; the
one exception, mat_small_in, says why beside SENTINELS.
Direct and the alternative are timed by measure_device_seconds (the least
of 6 calls on the device-resident planes).

Unlike the JAX script, the alternative is `partitioned` in both modes: the
JAX package timed the materialize against `merge`, but the port's adaptive
materialize routes to `partitioned` whenever the gates say no.

Usage: python3 -m flash_hash_join_tpu_torch.harness.gate_drift
           [--tol 0.15] [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import flash_hash_join_tpu_torch as ft
from flash_hash_join_tpu_torch.harness.crossover import Point, card_line, \
    make_data
from flash_hash_join_tpu_torch.ops import direct_bitmap as db
from flash_hash_join_tpu_torch.utils import native

ALT = "partitioned"


@dataclasses.dataclass(frozen=True)
class Sentinel:
    """A point on one side of a gate; `cell` names chip_smoke.py's cell of
    the same J1 shape, whose arrays the smoke passes in."""
    label: str
    gate: str
    point: Point
    cell: str = ""


def _j1(label: str, gate: str, mode: str, n: int, q: str) -> Sentinel:
    nb = max(n // {"Q1": 1_000_000, "Q2": 1_000, "Q5": 1}[q], 1)
    cell = f"{n:.0e}".replace("e+0", "e") + f"-{q}"
    return Sentinel(label, gate, Point(mode, nb, n, max(int(nb * 1.1), 2),
                                       j1=n, q=q), cell)


def _grid(label: str, gate: str, mode: str, nb: int, npr: int, span: int,
          wide: bool = False) -> Sentinel:
    return Sentinel(label, gate, Point(mode, nb, npr, span, wide))


# A label ends in _in where the gate routes direct, _out where it routes
# partitioned.  The sweep's margin at each point (direct / partitioned core
# ms, NVIDIA H100 80GB HBM3, 700.00 W) is in the comment; each is at least
# 30 %, but for mat_small_in: on the direct side of MAT_MIN_PROBE_ROWS no
# point leads by more than 9 %, so that sentinel fails only when
# partitioned gets ahead by more than --tol.
SENTINELS = (
    # the probe floor never binds: the ends of the probe sides measured
    _grid("floor_npr1_in", "ADAPTIVE_MIN_PROBE_ROWS", "count",
          1_000, 1, 1_100),                       # 0.183 / 0.454
    _grid("floor_npr2.5e5_in", "ADAPTIVE_MIN_PROBE_ROWS", "count",
          100_000, 250_000, 110_000),             # 0.307 / 0.640
    # the scan cap never binds: spans past the JAX cap of 2^19 slots
    _grid("scan_2^19+4096_in", "ADAPTIVE_SCAN_DOMAIN_BITS", "count",
          40_000, 40_000_000, (1 << 19) + 4096),  # 0.512 / 1.258
    _grid("scan_2^20-4096_in", "ADAPTIVE_SCAN_DOMAIN_BITS", "count",
          40_000, 1_000_000, (1 << 20) - 4096),   # 0.297 / 0.594
    # the large band never binds: nb >> npr, and J1 1e8 Q5
    _grid("large_nb2.5e6_npr1e4_in", "LARGE_MIN_PROBE_ROWS", "count",
          2_500_000, 10_000, 2_750_000),          # 0.362 / 0.731
    _j1("large_j1_1e8_q5_in", "LARGE_MIN_PROBE_ROWS", "count",
        100_000_000, "Q5"),                       # 2.641 / 21.810
    # narrow values, v_rows <= 64
    _j1("mat_small_out", "MAT_MIN_PROBE_ROWS", "materialize",
        40_000_000, "Q1"),                        # 1.890 / 1.378
    _grid("mat_small_in", "MAT_MIN_PROBE_ROWS", "materialize",
          6_701, 200_000_000, 7_372),             # 4.889 / 5.332
    # narrow values, v_rows >= 128
    _j1("mat_staged_out", "MAT_STAGED_MIN_PROBE_ROWS", "materialize",
        10_000_000, "Q2"),                        # 1.310 / 0.969
    _grid("mat_staged_in", "MAT_STAGED_MIN_PROBE_ROWS", "materialize",
          107_239, 150_000_000, 117_964),         # 4.382 / 5.996
    # u64 values: partitioned at every measured size
    _grid("mat_wide_npr1e6_out", "MAT_WIDE_MIN_PROBE_ROWS", "materialize",
          837, 1_000_000, 921, wide=True),        # 0.999 / 0.439
    _grid("mat_wide_npr1e8_out", "MAT_WIDE_MIN_PROBE_ROWS", "materialize",
          837, 100_000_000, 921, wide=True),      # 3.725 / 2.660
)


def _routes_direct(p: Point) -> bool:
    return db.adaptive_wins(p.mode, p.nb, p.npr, p.span,
                            narrow_values=not p.wide)


def sentinels(quick: bool = False) -> list[Sentinel]:
    """The sentinels; quick halves the probe side of those past 2e7 rows
    where that leaves them on their side of the gate (faster, noisier)."""
    if not quick:
        return list(SENTINELS)
    out = []
    for s in SENTINELS:
        p = s.point
        half = dataclasses.replace(p, npr=p.npr // 2, j1=0)
        if p.npr > 20_000_000 and _routes_direct(half) == _routes_direct(p):
            s = dataclasses.replace(s, point=half, cell="")
        out.append(s)
    return out


def verdict(t_direct: float, t_alt: float, routes_direct: bool,
            tol: float) -> tuple[bool, bool, float]:
    """(ok, direct_wins, margin) of one sentinel from its measured times:
    ok when the faster strategy is the one the gate routes to, or when the
    slower is within `tol` of the faster (margin = |t_direct - t_alt| over
    the faster)."""
    direct_wins = t_direct < t_alt
    margin = abs(t_direct - t_alt) / max(min(t_direct, t_alt), 1e-12)
    return direct_wins == routes_direct or margin <= tol, direct_wins, margin


def run_sentinel(s: Sentinel, *, device, tol: float, data=None) -> dict:
    """Measure one sentinel (data: its (bk, bv, pk), else drawn as the
    sweep draws them, seed 0); returns its row, row["ok"] the verdict."""
    p = s.point
    bk, bv, pk = data if data is not None else make_data(p, 0, {})
    want = native.host_join_count(bk, pk)
    gate = ft.adaptive_strategy(bk, bv, len(pk), mode=p.mode,
                                device=device)
    fn = ft.join_count if p.mode == "count" else ft.join_materialize
    count, _, info = fn(bk, bv, pk, strategy="adaptive", device=device,
                        return_info=True)
    counts, times = [count], {}
    for strategy in ("direct", ALT):
        c, secs, _, _ = ft.measure_device_seconds(
            bk, bv, pk, mode=p.mode, strategy=strategy, number=5,
            device=device)
        counts.append(c)
        times[strategy] = secs
    ok, direct_wins, margin = verdict(times["direct"], times[ALT],
                                      gate == "direct", tol)
    exact = all(c == want for c in counts)
    routed = info["strategy"] == gate
    return dict(label=s.label, gate=s.gate, mode=p.mode, nb=len(bk),
                npr=len(pk), span=int(bk.max()) - int(bk.min()) + 1,
                direct_ms=times["direct"] * 1e3, alt_ms=times[ALT] * 1e3,
                gate_routes=gate, adaptive_route=info["strategy"],
                measured_winner="direct" if direct_wins else ALT,
                margin=margin, exact=exact, ok=ok and exact and routed)


def line(row: dict) -> str:
    return (f"{'PASS' if row['ok'] else 'FAIL'},{row['label']},"
            f"gate={row['gate']},mode={row['mode']},nb={row['nb']},"
            f"npr={row['npr']},span={row['span']},"
            f"direct={row['direct_ms']:.4f}ms,{ALT}={row['alt_ms']:.4f}ms,"
            f"gate_routes={row['gate_routes']},"
            f"adaptive_route={row['adaptive_route']},"
            f"measured_winner={row['measured_winner']},"
            f"margin={row['margin']:.1%},exact={row['exact']}")


def run_checks(*, device="cuda", tol: float = 0.15, quick: bool = False,
               cells: dict | None = None, log=print):
    """Every sentinel's line, then the total line; returns (rows,
    failures).  cells: arrays by chip_smoke.py cell name, used where a
    sentinel's J1 shape is one of them."""
    rows = []
    for s in sentinels(quick):
        c = (cells or {}).get(s.cell)
        data = None if c is None else (c.build_keys, c.build_values,
                                       c.probe_keys)
        rows.append(run_sentinel(s, device=device, tol=tol, data=data))
        log(line(rows[-1]))
    failures = sum(not r["ok"] for r in rows)
    log(f"{'PASS' if failures == 0 else 'FAIL'},total,failures={failures}")
    return rows, failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=0.15,
                    help="relative slack before a disagreement FAILs")
    ap.add_argument("--quick", action="store_true",
                    help="halve the probe side of the sentinels past 2e7 "
                         "rows (faster, noisier)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where each kernel's plain "
                         "PyTorch version runs (the times then say nothing "
                         "of the card)")
    args = ap.parse_args(argv)
    ft.initialize(device=args.device)
    print(f"# gate_drift tol={args.tol} quick={args.quick} card: "
          f"{card_line(args.device)}", flush=True)
    _, failures = run_checks(device=args.device, tol=args.tol,
                             quick=args.quick,
                             log=lambda s: print(s, flush=True))
    sys.exit(0 if failures == 0 else 1)


if __name__ == "__main__":
    main()
