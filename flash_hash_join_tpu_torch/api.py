"""Public API (port of flash_hash_join_tpu/api.py): count and materialize.

The reference module's 13 functions (12 joins and `initialize`) and the
extended API.  Every function takes numpy uint64 arrays (build_keys,
build_values, probe_keys) — lists and other integer dtypes are coerced —
and returns `(count, core_seconds)`.  core_seconds is device time: the host->device
copy is made and synchronised first, then the join's device work and the
read-back of the count are timed with CUDA events on the card
(perf_counter on the CPU).  Materialize with return_arrays also returns
the matched (probe_key, value) rows as uint64 numpy arrays, read back
outside core_seconds; return_info appends a dict (strategy, d_rows —
the direct rung: bitmap rows of a count, value-plane rows of a
materialize —, retried, kernel launches).

Routing of the adaptive plan, decided on the host from the numpy keys:
a dense domain -> `direct`.  Count: build keys below 2^32 spanning at
most MAX_XL_DOMAIN_BITS slots (bitmap kernels K1/K2).  Materialize: build
keys below 2^32, at most MAX_BUILD_ROWS (2^20) build rows and
v_rows_for(span) <= MAT_MAX_V_ROWS (span <= 2^20 slots; value-plane
kernels K7 or K8, then K5), with one value plane when every build
value is below 2^32.  Everything else -> `partitioned` (sorted range
table, K3/K4, and K5 for materialize).  An explicit strategy="direct"
outside those bounds raises ValueError.  The JAX package's extra gates
between direct and partitioned (probe-count floors, the 2^19 scan cap,
large_span_ok / large_span_wins, mat_wins, mat_span_ok) were measured on
a TPU v5e or size its kernels' windows; the perf gates return once
measured on the H100.  The adaptive plan never picks the explicit tiers,
as in the JAX package: `global` (hash_join, hash_join_count and their
_bloom twins, which add the per-group bloom filter; plain torch) and
`vmem` (bucket table, K10/K11); like `merge` they bypass the feasibility
plan.  A nonzero special[3] (build rows the strategy could not place:
bad rows of a direct domain, a full vmem bucket, a chain past the global
walk's bound) reruns the join on `merge`, so every result is exact.
Output order: direct, partitioned, global and vmem emit probe order,
merge (hash, key) order; the row multiset is the same.

`device` defaults to "cuda"; asking for CUDA where it is unavailable
raises.  device="cpu" runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from flash_hash_join_tpu_torch import engine
from flash_hash_join_tpu_torch.models.cost import choose_plan, hbm_budget_bytes
from flash_hash_join_tpu_torch.ops import direct_bitmap as db
from flash_hash_join_tpu_torch.ops.cuda import _build
from flash_hash_join_tpu_torch.ops.cuda import bitmap_probe as bp
from flash_hash_join_tpu_torch.ops.cuda import bucket_probe as bkp
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
from flash_hash_join_tpu_torch.ops.cuda import range_probe as rp
from flash_hash_join_tpu_torch.ops.cuda import stream_compact as sc
from flash_hash_join_tpu_torch.utils import u64
from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG

STRATEGIES = ("adaptive", "direct", "partitioned", "merge", "global", "vmem")
EXPLICIT_TIERS = ("global", "vmem")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _as_u64(arr) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint64:
        arr = arr.astype(np.uint64)
    return arr


def launch_counts() -> dict:
    """Kernel launches so far in this process, by kernel."""
    return {"dense_bitmap": dbm.fused_domain_bitmap_join.launches,
            "scan_domain_count": bp.scan_domain_count.launches,
            "range_probe_count": rp.range_probe_count.launches,
            "range_probe_materialize": rp.range_probe_materialize.launches,
            "range_directory": rp.range_directory.launches,
            "compact": sc.compact_by_mask.launches,
            "probe_gather_bitmap": bp.probe_gather_bitmap.launches,
            "probe_gather_staged": dv.probe_gather_staged.launches,
            "materialize_copy": dv.materialize_copy.launches,
            "probe_count_vmem": bkp.probe_count_vmem.launches,
            "probe_materialize_vmem": bkp.probe_materialize_vmem.launches,
            "concat_ragged_blocks": sc.concat_ragged_blocks.launches}


def _timed(fn, args, dev: torch.device):
    """Run a join function; returns (outputs, count, special[3], seconds)."""
    def run():
        out = fn(*args)
        count, bad = torch.stack([out[0], out[-1][3]]).tolist()
        return out, count, bad

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, count, bad = run()
        end.record()
        end.synchronize()
        return out, count, bad, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out, count, bad = run()
    return out, count, bad, time.perf_counter() - t0


def _graph(mode: str, strategy: str, rung: int = 0,
           narrow_values: bool = False, **tier):
    """The join function; rung is the direct strategy's d_rows (count) or
    v_rows (materialize); tier holds n_build and use_bloom of an explicit
    tier."""
    if mode == "count":
        return engine.count_graph(strategy, rung, **tier)
    if strategy == "direct":
        return engine.materialize_graph(strategy, rung, narrow_values)
    return engine.materialize_graph(strategy, **tier)


def _dense_rung(mode: str, build_keys: np.ndarray,
                build_values: np.ndarray) -> tuple[int, bool]:
    """(rung, narrow_values) of the direct strategy for these build
    columns, rung 0 when the keys are not a dense domain the direct
    kernels take."""
    bk_max = int(build_keys.max())
    span = bk_max - int(build_keys.min()) + 1
    if bk_max >= 2**32:
        return 0, False
    if mode == "count":
        return (db.d_rows_for(span) if span <= db.MAX_XL_DOMAIN_BITS
                else 0), False
    v_rows = db.v_rows_for(span)
    if build_keys.shape[0] > db.MAX_BUILD_ROWS or v_rows > db.MAT_MAX_V_ROWS:
        return 0, False
    return v_rows, int(build_values.max()) < 2**32


def _run_join(build_keys, build_values, probe_keys, *, mode: str,
              strategy: str, device, use_bloom: bool = False,
              return_arrays: bool = False, return_info: bool = False):
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of "
                         f"{STRATEGIES}")
    dev = _device(device)
    build_keys = _as_u64(build_keys)
    build_values = _as_u64(build_values)
    probe_keys = _as_u64(probe_keys)
    if build_keys.shape != build_values.shape:
        raise ValueError("build_keys and build_values must have equal length")
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    arrays = return_arrays and mode == "materialize"
    if nb == 0 or npr == 0:
        empty = np.zeros(0, np.uint64)
        result = (0, 0.0) + ((empty, empty) if arrays else ())
        return result + (None,) if return_info else result

    requested = strategy
    if strategy in ("adaptive", "partitioned"):
        plan = choose_plan(nb, npr, DEFAULT_CONFIG, mode,
                           hbm_budget_bytes(dev))
        if plan.probe_chunks > 1:
            raise NotImplementedError(
                f"{npr} probe rows need {plan.probe_chunks} host-streamed "
                "chunks on this device; chunk streaming is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
        if strategy == "adaptive":
            strategy = plan.strategy

    # Dense-domain upgrade, decided host-side from the numpy keys.
    rung, narrow_values = 0, False
    if requested in ("adaptive", "direct"):
        rung, narrow_values = _dense_rung(mode, build_keys, build_values)
        if rung:
            strategy = "direct"
        elif requested == "direct":
            raise ValueError(
                "direct strategy requires build keys < 2^32 with a dense "
                f"domain (count: span <= {db.MAX_XL_DOMAIN_BITS} slots; "
                f"materialize: at most {db.MAX_BUILD_ROWS} build rows, span "
                f"<= {db.MAT_MAX_V_ROWS * db.LANES} slots) (got nb={nb}, max "
                f"{int(build_keys.max())}, min {int(build_keys.min())})")

    tier = (dict(n_build=nb, use_bloom=use_bloom)
            if strategy in EXPLICIT_TIERS else {})
    args = [*u64.device_planes(build_keys, dev),
            *u64.device_planes(build_values, dev),
            *u64.device_planes(probe_keys, dev), nb, npr]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    before = launch_counts()
    out, count, bad, core_seconds = _timed(
        _graph(mode, strategy, rung, narrow_values, **tier), args, dev)
    retried = bad != 0 and strategy != "merge"
    if retried:
        strategy = "merge"
        out, count, _, core_seconds = _timed(_graph(mode, "merge"), args, dev)
    result = (count, core_seconds)
    if arrays:
        result += (u64.to_numpy_u64(out[1], out[2], count),
                   u64.to_numpy_u64(out[3], out[4], count))
    if not return_info:
        return result
    after = launch_counts()
    return result + (dict(
        strategy=strategy, d_rows=rung if strategy == "direct" else 0,
        retried=retried, use_bloom=use_bloom, nb=nb, npr=npr,
        launches={k: after[k] - before[k] for k in after}),)


# --- reference-parity API (flash_hash_join_tpu/api.py:441-498) -------------
# Bloom changes only the `global` strategy (hash_join*_bloom), which the
# adaptive plan never picks, so the adaptive and radix `_bloom` variants
# equal their plain twins, as in the JAX package.

def adaptive_join(build_keys, build_values, probe_keys, *, device="cuda",
                  return_info: bool = False):
    """Exact first-match materialize with the adaptive plan; returns
    (count, core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="adaptive", device=device,
                     return_info=return_info)


def adaptive_join_bloom(build_keys, build_values, probe_keys, *,
                        device="cuda", return_info: bool = False):
    return adaptive_join(build_keys, build_values, probe_keys,
                         device=device, return_info=return_info)


def adaptive_join_count(build_keys, build_values, probe_keys, *,
                        device="cuda", return_info: bool = False):
    """Exact first-match count with the adaptive plan; returns
    (count, core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy="adaptive", device=device,
                     return_info=return_info)


def adaptive_join_count_bloom(build_keys, build_values, probe_keys, *,
                              device="cuda", return_info: bool = False):
    return adaptive_join_count(build_keys, build_values, probe_keys,
                               device=device, return_info=return_info)


def hash_join(build_keys, build_values, probe_keys, *, device="cuda",
              return_info: bool = False):
    """Materialize on the global hash table; returns (count,
    core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="global", device=device,
                     return_info=return_info)


def hash_join_bloom(build_keys, build_values, probe_keys, *, device="cuda",
                    return_info: bool = False):
    """hash_join with the per-group bloom filter."""
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="global", use_bloom=True,
                     device=device, return_info=return_info)


def hash_join_count(build_keys, build_values, probe_keys, *, device="cuda",
                    return_info: bool = False):
    """Count on the global hash table; returns (count, core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy="global", device=device,
                     return_info=return_info)


def hash_join_count_bloom(build_keys, build_values, probe_keys, *,
                          device="cuda", return_info: bool = False):
    """hash_join_count with the per-group bloom filter."""
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy="global", use_bloom=True, device=device,
                     return_info=return_info)


def hash_join_radix(build_keys, build_values, probe_keys, *, device="cuda",
                    return_info: bool = False):
    """Materialize on the partitioned tier; returns (count, core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy="partitioned",
                     device=device, return_info=return_info)


def hash_join_radix_bloom(build_keys, build_values, probe_keys, *,
                          device="cuda", return_info: bool = False):
    return hash_join_radix(build_keys, build_values, probe_keys,
                           device=device, return_info=return_info)


def hash_join_count_radix(build_keys, build_values, probe_keys, *,
                          device="cuda", return_info: bool = False):
    """Count on the partitioned tier; returns (count, core_seconds)."""
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy="partitioned", device=device,
                     return_info=return_info)


def hash_join_count_radix_bloom(build_keys, build_values, probe_keys, *,
                                device="cuda", return_info: bool = False):
    return hash_join_count_radix(build_keys, build_values, probe_keys,
                                 device=device, return_info=return_info)


def initialize(device="cuda") -> bool:
    """Touch the device, and on a card build and load the kernels, so the
    first join does not pay for them."""
    dev = _device(device)
    if dev.type == "cuda":
        _build.lib()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    return True


# --- extended API -----------------------------------------------------------

def plan_strategy(n_build: int, n_probe: int, mode: str = "count",
                  device="cuda") -> str:
    """The strategy the adaptive plan picks from the shape alone (the
    dense-domain upgrade of a count to "direct" is decided from the keys)."""
    try:
        return choose_plan(n_build, n_probe, DEFAULT_CONFIG, mode,
                           hbm_budget_bytes(_device(device))).strategy
    except MemoryError:
        return "partitioned"


def bloom_is_distinct(n_build: int, n_probe: int, mode: str = "count",
                      strategy: str = "adaptive", device="cuda") -> bool:
    """True when use_bloom=True runs a different join than use_bloom=False
    for this shape and strategy: only on the global tier."""
    if strategy == "adaptive":
        strategy = plan_strategy(n_build, n_probe, mode, device)
    return strategy == "global"


def join_count(build_keys, build_values, probe_keys, *, strategy="adaptive",
               use_bloom: bool = False, device="cuda",
               return_info: bool = False):
    """Count with an explicit strategy: one of STRATEGIES; use_bloom
    applies to "global"."""
    return _run_join(build_keys, build_values, probe_keys, mode="count",
                     strategy=strategy, use_bloom=use_bloom, device=device,
                     return_info=return_info)


def join_materialize(build_keys, build_values, probe_keys, *,
                     strategy="adaptive", use_bloom: bool = False,
                     device="cuda", return_arrays: bool = False,
                     return_info: bool = False):
    """Materialize with an explicit strategy: one of STRATEGIES ("direct"
    raises ValueError when the build keys are not a dense domain it takes;
    use_bloom applies to "global").  return_arrays adds the matched
    (probe_key, value) rows as uint64 numpy arrays."""
    return _run_join(build_keys, build_values, probe_keys,
                     mode="materialize", strategy=strategy,
                     use_bloom=use_bloom, device=device,
                     return_arrays=return_arrays, return_info=return_info)
