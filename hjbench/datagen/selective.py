"""A selective join: a build side of uniform keys, and a probe side of which
exactly a `match_share` of the rows finds its key.

Build side: `build_rows` keys uniform below 2^key_bits and values uniform
below 2^63, as the program's models/workload.uniform_case draws them (the
keys are not de-duplicated; at 1e7 keys below 2^62 a repeat is unlikely).
Probe side: round(probe_rows * match_share) hits at distinct positions
uniform over the side, each a build key drawn with replacement; every
other row a key uniform below 2^key_bits that the build side lacks
(datagen/zipf.py's absent_keys).  uniform_case draws its misses from
[2^62, 2^63) instead, a range no build key is in, where a table that knows
its key range rejects every miss without reading it.

Not numpy's stream: every draw comes from one torch Generator seeded from
the seed, on the card where there is one, the probe side in pieces of
PIECE rows written into the numpy column, so that set-up holds a piece and
the hits' positions on the card, not the whole side (a randperm of 1e9 rows
alone takes 8 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from hjbench import catalog

PIECE = 1 << 26


def hit_positions(n: int, k: int, g: torch.Generator, dev) -> torch.Tensor:
    """k distinct positions uniform over [0, n), ascending: uniform draws,
    the repeats drawn again until none is left."""
    pos = torch.empty(0, dtype=torch.int64, device=dev)
    while pos.numel() < k:
        more = torch.randint(0, n, (k - pos.numel(),), generator=g,
                             device=dev)
        pos = torch.unique(torch.cat([pos, more]))
    return pos


def make(cfg: dict, table: str | None, seed: int):
    """(build_keys, build_values, probe_keys) as uint64 numpy columns."""
    if table is not None:
        raise ValueError(f"selective has one build side (got table {table!r})")
    nb, npr, bits = cfg["build_rows"], cfg["probe_rows"], cfg["key_bits"]
    if bits > 62:
        raise ValueError("keys below 2^62 at most: they are drawn as int64")
    absent_keys = catalog.datagen("zipf").absent_keys
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    g = torch.Generator(dev)
    g.manual_seed(int(np.random.SeedSequence(seed).generate_state(
        1, np.uint64)[0]))
    bk = torch.randint(0, 1 << bits, (nb,), generator=g, device=dev)
    bv = torch.empty(nb, dtype=torch.int64, device=dev).random_(
        generator=g)                                     # [0, 2^63)
    hits = round(npr * cfg["match_share"])
    pos = hit_positions(npr, hits, g, dev)
    hit_keys = bk[torch.randint(0, nb, (hits,), generator=g, device=dev)]
    sorted_bk = torch.sort(bk).values
    pk = np.empty(npr, dtype=np.uint64)
    out = torch.from_numpy(pk.view(np.int64))
    edges = torch.searchsorted(pos, torch.arange(0, npr + PIECE, PIECE,
                                                 device=dev)).tolist()
    for i, a in enumerate(range(0, npr, PIECE)):
        piece = absent_keys(min(PIECE, npr - a), sorted_bk, bits, g, dev)
        lo, hi = edges[i], edges[i + 1]
        piece[pos[lo:hi] - a] = hit_keys[lo:hi]
        out[a:a + piece.numel()].copy_(piece)
    return bk.cpu().numpy().view(np.uint64), bv.cpu().numpy().view(
        np.uint64), pk
