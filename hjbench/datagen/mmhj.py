"""The main-memory hash-join workloads of Blanas et al. (SIGMOD 2011) as
Balkesen et al. (ICDE 2013) run them: a build relation R whose keys are a
permutation of 1..|R|, and a probe relation S whose keys are drawn
uniformly from R's keys, so every probe row matches exactly one build row.
"""

from __future__ import annotations

import numpy as np


def make(cfg: dict, table: str | None, seed: int):
    """(build_keys, build_values, probe_keys): R's keys, R's payloads
    (uniform 64-bit words) and S's keys."""
    if table not in (None, "R"):
        raise ValueError(f"mmhj has one build table, R (got {table!r})")
    rng = np.random.default_rng(seed)
    nr, ns = cfg["build_rows"], cfg["probe_rows"]
    bk = rng.permutation(nr).astype(np.uint64) + np.uint64(1)
    bv = rng.integers(0, 2**64, nr, dtype=np.uint64)
    # uniform over R's key set, which is exactly 1..|R|
    pk = rng.integers(1, nr + 1, ns, dtype=np.uint64)
    return bk, bv, pk
