"""db-benchmark's join task J1 (h2oai/db-benchmark `_data/join-datagen.R`).

The draw follows join-datagen.R.  split_xlr(n) takes a permutation of
1..1.1n and cuts it into x (its first 0.9n keys), l (the next 0.1n) and
r (the last 0.1n).  A right table of n rows joins on the keys of
split_xlr(n) (small, medium and big on id1, id2 and id3): its key column
is sample_all(x + r, n), and the left table's is sample_all(x + l,
x_rows), where sample_all pads a side's keys with draws from them, with
replacement, up to its rows and shuffles the lot.  So the big table and
x are each a permutation of n keys, and 0.9 of x's rows match.  The
payload is the right table's v2, round(runif(n, max=100), 6), cast to
uint64 as the reference library's benchmark.py casts it.

Not R's own stream: each table draws from a torch Generator seeded from
the seed and the table, on the card where there is one, in a few large
calls.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_all(keys: torch.Tensor, size: int, g: torch.Generator):
    """join-datagen.R's sample_all: keys, padded by draws from them with
    replacement to `size`, in a random order."""
    extra = size - keys.numel()
    if extra < 0:
        raise ValueError(f"{keys.numel()} keys for {size} rows")
    if extra:
        pick = torch.randint(keys.numel(), (extra,), generator=g,
                             device=keys.device)
        keys = torch.cat([keys, keys[pick]])
    return keys[torch.randperm(size, generator=g, device=keys.device)]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def make(cfg: dict, table: str | None, seed: int):
    """(build_keys, build_values, probe_keys) of x joined to `table`, as
    uint64 numpy columns."""
    names = list(cfg["tables"])
    if table not in names:
        raise ValueError(f"j1 table {table!r}; one of {names}")
    n, nx = cfg["tables"][table], cfg["x_rows"]
    x_part, side_part = cfg["split"]          # 0.9, 0.1 of n
    nxk, nside = round(n * x_part), round(n * side_part)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    state = np.random.SeedSequence(seed, spawn_key=(names.index(table),))
    g = torch.Generator(dev)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    key = torch.randperm(nxk + 2 * nside, generator=g, device=dev) + 1
    x, l, r = key[:nxk], key[nxk:nxk + nside], key[nxk + nside:]
    bk = _sample_all(torch.cat([x, r]), n, g)
    v2 = torch.rand(n, generator=g, dtype=torch.float64, device=dev)
    bv = (v2 * cfg["v2_max"]).round(decimals=6).to(torch.int64)
    pk = _sample_all(torch.cat([x, l]), nx, g)
    return _host(bk), _host(bv), _host(pk)
