"""Public API, count slice (port of the count branch of
flash_hash_join_tpu/api.py).

Every function takes numpy uint64 arrays (build_keys, build_values,
probe_keys) — lists and other integer dtypes are coerced — and returns
`(count, core_seconds)`.  core_seconds is device time: the host->device
copy is made and synchronised first, then the index mapping, the kernels
and the read-back of the count are timed with CUDA events on the card
(perf_counter on the CPU).

Routing of the adaptive count: `direct` (dense-domain bitmap, two CUDA
kernels) whenever the build keys are below 2^32 and their span is at most
MAX_XL_DOMAIN_BITS; `merge` (always exact) otherwise.  The JAX package's
extra gates (probe-count floor, the 2^19 scan cap, large_span_ok /
large_span_wins) choose between direct and its partitioned tier, were
measured on a TPU v5e, and return — measured on the H100 — when the
partitioned tier is ported.  A nonzero special[3] (build rows outside the
domain) reruns the join on merge, so the count is always exact.

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
from flash_hash_join_tpu_torch.ops.cuda import dense_bitmap as dbm
from flash_hash_join_tpu_torch.utils import u64
from flash_hash_join_tpu_torch.utils.config import DEFAULT_CONFIG

STRATEGIES = ("adaptive", "direct", "merge")


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
    return {"dense_bitmap": dbm.fused_bitmap_join.launches,
            "bitmap_probe": bp.probe_count_bitmap.launches}


def _timed(fn, args, dev: torch.device):
    """Run a count function; returns (count, special[3], seconds)."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        count, special = fn(*args)
        count, bad = torch.stack([count, special[3]]).tolist()
        end.record()
        end.synchronize()
        return count, bad, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    count, special = fn(*args)
    count, bad = torch.stack([count, special[3]]).tolist()
    return count, bad, time.perf_counter() - t0


def _run_join(build_keys, build_values, probe_keys, *, strategy: str,
              device, return_info: bool = False):
    if strategy not in STRATEGIES:
        engine.count_graph(strategy)   # raises: unported or unknown
    dev = _device(device)
    build_keys = _as_u64(build_keys)
    build_values = _as_u64(build_values)
    probe_keys = _as_u64(probe_keys)
    if build_keys.shape != build_values.shape:
        raise ValueError("build_keys and build_values must have equal length")
    nb, npr = build_keys.shape[0], probe_keys.shape[0]
    if nb == 0 or npr == 0:
        return (0, 0.0, None) if return_info else (0, 0.0)

    requested = strategy
    if strategy == "adaptive":
        plan = choose_plan(nb, npr, DEFAULT_CONFIG, "count",
                           hbm_budget_bytes(dev))
        if plan.probe_chunks > 1:
            raise NotImplementedError(
                f"{npr} probe rows need {plan.probe_chunks} host-streamed "
                "chunks on this device; chunk streaming is not ported yet "
                "(ROADMAP.md Queue 1 item 6)")
        strategy = plan.strategy

    # Dense-domain upgrade, decided host-side from the numpy keys.
    d_rows = 0
    if requested in ("adaptive", "direct"):
        bk_max = int(build_keys.max())
        span = bk_max - int(build_keys.min()) + 1
        if bk_max < 2**32 and span <= db.MAX_XL_DOMAIN_BITS:
            strategy, d_rows = "direct", db.d_rows_for(span)
        elif requested == "direct":
            raise ValueError(
                "direct strategy requires build keys < 2^32 spanning at most "
                f"{db.MAX_XL_DOMAIN_BITS} slots (got max {bk_max}, span {span})")

    args = [*u64.device_planes(build_keys, dev),
            *u64.device_planes(build_values, dev),
            *u64.device_planes(probe_keys, dev), nb, npr]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    before = launch_counts()
    count, bad, core_seconds = _timed(engine.count_graph(strategy, d_rows),
                                      args, dev)
    retried = bad != 0 and strategy != "merge"
    if retried:
        strategy = "merge"
        count, _, core_seconds = _timed(engine.count_graph("merge"), args, dev)
    if not return_info:
        return count, core_seconds
    after = launch_counts()
    return count, core_seconds, dict(
        strategy=strategy, d_rows=d_rows if strategy == "direct" else 0,
        retried=retried, nb=nb, npr=npr,
        launches={k: after[k] - before[k] for k in after})


def adaptive_join_count(build_keys, build_values, probe_keys, *,
                        device="cuda", return_info: bool = False):
    """Exact first-match count; returns (count, core_seconds), plus an info
    dict (strategy, d_rows, retried, kernel launches) with return_info."""
    return _run_join(build_keys, build_values, probe_keys,
                     strategy="adaptive", device=device,
                     return_info=return_info)


def adaptive_join_count_bloom(build_keys, build_values, probe_keys, *,
                              device="cuda", return_info: bool = False):
    """Same as adaptive_join_count: bloom changes only the global-table
    strategy, which the adaptive plan does not pick."""
    return adaptive_join_count(build_keys, build_values, probe_keys,
                               device=device, return_info=return_info)


def join_count(build_keys, build_values, probe_keys, *, strategy="adaptive",
               device="cuda", return_info: bool = False):
    """Count with an explicit strategy: "adaptive", "direct" or "merge"."""
    return _run_join(build_keys, build_values, probe_keys, strategy=strategy,
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


def plan_strategy(n_build: int, n_probe: int, mode: str = "count",
                  device="cuda") -> str:
    """The strategy the adaptive plan picks from the shape alone (the
    dense-domain upgrade to "direct" is decided from the keys)."""
    try:
        return choose_plan(n_build, n_probe, DEFAULT_CONFIG, mode,
                           hbm_budget_bytes(_device(device))).strategy
    except MemoryError:
        return "merge"
