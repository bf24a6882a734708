"""Feasibility model for adaptive strategy selection (port of
flash_hash_join_tpu/models/cost.py).

STRATEGY: the adaptive plan is the constant "partitioned" (the range-table
tier, ops/range_table.py), as in the JAX package; api.py upgrades a count
over a dense key domain to "direct" from the keys.

FEASIBILITY: the device holds the build side with its range table, one
probe chunk's input planes (8 B a row) and the chunk's transients; a
materialize also holds the chunk's four compacted output planes (16 B a
row) and, where K4's plan for the chunk takes its sliced route, that
route's scratch, SLICED_SCRATCH_BYTES a row of a pass of at most PASS_ROWS
rows (probe_scratch_bytes).  A plan that needs more than one chunk streams
them from the host
(api._run_chunked) through a depth-2 pipeline, which also holds the next
chunk's input planes and, for a materialize, the previous chunk's output
planes until they are read back.  No probe side longer than
MAX_CHUNK_ROWS, the longest run on the card, goes in one piece.  The
budget is the card's own memory times HBM_HEADROOM.  The constants are the partitioned tier's peak
RESERVED device memory (torch.cuda.max_memory_reserved: the caching
allocator runs out on what it reserves, not on what is allocated) on an
H100, read by scripts/calibrate_planner.py at the same build side and two
probe sides (BASELINE.json configs #2 and #3): the slope gives the bytes a
probe row, the intercept the bytes a build row; each with a margin
(PERF.md section 2).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.ops.cuda.range_probe import SLICED_SCRATCH_BYTES
from flash_hash_join_tpu_torch.utils.config import JoinConfig

# Share of device memory the planner may fill: the JAX package's 12 GiB of a
# 16 GiB chip.  Kept on the H100: the calibrated constants carry their own
# margin, and a quarter of the card stays free for the caching allocator's
# other pools and the CUDA context.
HBM_HEADROOM = 12 / 16

# NVIDIA H100 80GB HBM3 at 700 W, peak reserved bytes of the partitioned
# tier (scripts/calibrate_planner.py; 1e7 build rows at 1e8 and 1e9 probe
# rows): count 8.00 B a probe row and 70.3 a build row, materialize 33.1
# and 59.5; the constants below are those times 1.10, rounded up.
# Device bytes a build row: input planes, the sort, the range table and
# its directory.
BUILD_BYTES_COUNT = 78
BUILD_BYTES_MATERIALIZE = 66

# Device bytes a probe row while a chunk is in flight, beyond its 8
# input-plane bytes (and, for a materialize, its 16 output-plane bytes):
# K3 keeps nothing a row; K4's mask and value planes are 9.
TRANSIENT_BYTES_COUNT = 1
TRANSIENT_BYTES_MATERIALIZE = 13

# The longest probe side a join has run in one piece on the card: config
# #3's 1e9 rows (chip_smoke.py's config3 phase).  A longer probe side
# streams in chunks of at most this many rows, whatever the budget, until
# a run on the card covers more (a chunk past 2^31 rows would also need
# 64-bit row indices throughout).
MAX_CHUNK_ROWS = 1_000_000_000


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    strategy: str       # always "partitioned"
    gbits: int          # home-group bits for the global-table graph
    probe_chunks: int   # probe chunks that fit device memory


def hbm_budget_bytes(device) -> int:
    """Working-set budget for one join on `device`: its memory (host RAM
    for the CPU) times HBM_HEADROOM."""
    device = torch.device(device)
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * HBM_HEADROOM)


def footprint(n_build: int, mode: str) -> tuple[int, int, int]:
    """(fixed, per_row, pipelined): device bytes of the build side, bytes
    a probe row of a chunk in flight, and bytes a row the depth-2 pipeline
    adds to a stream (the next chunk's input planes and, for a
    materialize, the last one's output planes)."""
    if mode == "materialize":
        return (BUILD_BYTES_MATERIALIZE * n_build,
                8 + 16 + TRANSIENT_BYTES_MATERIALIZE, 8 + 16)
    return BUILD_BYTES_COUNT * n_build, 8 + TRANSIENT_BYTES_COUNT, 8


def probe_scratch_bytes(n_build: int, rows: int, mode: str) -> int:
    """Device bytes a probe chunk of `rows` rows takes beside its per-row
    planes: for a materialize whose K4 plan (ops/cuda/range_probe.plan, on
    the table of n_build keys) takes the sliced route, that route's scratch,
    SLICED_SCRATCH_BYTES a row of one pass of at most PASS_ROWS rows; else
    none."""
    if mode != "materialize":
        return 0
    p = rp.plan(rows, rp.built_table_bytes(n_build),
                rp.directory_bits(n_build))
    return SLICED_SCRATCH_BYTES * p.pass_rows if p.pbits else 0


def _most_rows(avail: int, per_row: int, n_build: int, mode: str) -> int:
    """The most rows c with per_row * c + probe_scratch_bytes(n_build, c)
    <= avail, by bisection: the scratch only grows with c."""
    lo, hi = 0, avail // per_row
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if per_row * mid + probe_scratch_bytes(n_build, mid, mode) <= avail:
            lo = mid
        else:
            hi = mid - 1
    return lo


def plan_probe_chunks(n_build: int, n_probe: int, mode: str,
                      budget_bytes: int) -> int:
    """Number of probe chunks that fit the budget; 1 means single-shot.
    No chunk is longer than MAX_CHUNK_ROWS."""
    fixed, per_row, pipelined = footprint(n_build, mode)
    avail = budget_bytes - fixed
    if avail <= 0:
        raise MemoryError(
            f"build side of {n_build} rows alone exceeds the single-device "
            "memory budget")
    if n_probe <= min(_most_rows(avail, per_row, n_build, mode),
                      MAX_CHUNK_ROWS):
        return 1
    chunk_rows = min(_most_rows(avail, per_row + pipelined, n_build, mode),
                     MAX_CHUNK_ROWS)
    return -(-n_probe // max(chunk_rows, 1))


def choose_plan(n_build: int, n_probe: int, cfg: JoinConfig,
                mode: str, budget_bytes: int) -> JoinPlan:
    """Pick strategy + chunking for a build/probe size pair."""
    return JoinPlan(
        "partitioned",
        cfg.group_bits(n_build),
        plan_probe_chunks(n_build, n_probe, mode, budget_bytes),
    )
