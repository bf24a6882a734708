"""Feasibility model for adaptive strategy selection (port of
flash_hash_join_tpu/models/cost.py).

STRATEGY: the adaptive plan is the constant "partitioned" (the range-table
tier, ops/range_table.py), as in the JAX package; api.py upgrades a count
over a dense key domain to "direct" from the keys.

FEASIBILITY: the device must hold the build side plus one probe chunk and
its transients.  The budget is the card's own memory times the JAX
package's headroom ratio (12 GiB of a 16 GiB v5e = 12/16).  Host-side chunk
streaming is not ported yet: api.py raises NotImplementedError when the
plan asks for more than one chunk.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from flash_hash_join_tpu_torch.utils.config import JoinConfig

# Share of device memory the planner may fill (the JAX package's 12 GiB
# budget on a 16 GiB chip).
HBM_HEADROOM = 12 / 16

# Device bytes per probe row while a chunk is in flight, beyond its 8
# input-plane bytes.  These are the JAX package's TPU v5e calibrations
# (round-3 runs); they still have to be re-measured on the H100.
TRANSIENT_BYTES_COUNT = 40
TRANSIENT_BYTES_MATERIALIZE = 56


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


def plan_probe_chunks(n_build: int, n_probe: int, mode: str,
                      budget_bytes: int) -> int:
    """Number of probe chunks that fit the budget; 1 means single-shot."""
    fixed = 16 * n_build + 16 * n_build  # input planes + range table
    if mode == "materialize":
        fixed += 8 * n_build  # value planes in the table
        per_row = 8 + 16 + TRANSIENT_BYTES_MATERIALIZE
    else:
        per_row = 8 + TRANSIENT_BYTES_COUNT
    avail = budget_bytes - fixed
    if avail <= 0:
        raise MemoryError(
            f"build side of {n_build} rows alone exceeds the single-device "
            "memory budget")
    chunk_rows = avail // per_row
    if chunk_rows >= n_probe:
        return 1
    # A depth-2 chunk pipeline holds the NEXT chunk's input planes
    # (8 B/row) while the current one runs, so chunked plans budget both.
    chunk_rows = avail // (per_row + 8)
    return -(-n_probe // max(chunk_rows, 1))


def choose_plan(n_build: int, n_probe: int, cfg: JoinConfig,
                mode: str, budget_bytes: int) -> JoinPlan:
    """Pick strategy + chunking for a build/probe size pair."""
    return JoinPlan(
        "partitioned",
        cfg.group_bits(n_build),
        plan_probe_chunks(n_build, n_probe, mode, budget_bytes),
    )
