"""A Zipf-skewed probe side over unique build keys, with misses: the sizes
and draws of the program's models/workload.zipf_probe_case, copied here so
that the yardstick stays put when the program's generators change, plus
probe rows whose keys the build side does not hold.

Build side: `build_rows` uniform keys below 2^key_bits, sorted and
de-duplicated (as zipf_probe_case does, so the keys arrive in ascending
order), each with a uniform 63-bit value.  Probe side: Zipf ranks with
exponent `zipf_a` (numpy's rejection sampler, Devroye's, the draw of
numpy.random.Generator.zipf) over the build keys in ascending order, a
rank past the last key taking the last key; then a seeded `miss_share` of
the probe rows, at positions uniform over the probe side, get uniform keys
below 2^key_bits that the build side does not hold.

Not numpy's stream: every draw comes from one torch Generator seeded from
the seed, on the card where there is one, in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MAX = float(2**63 - 1)     # numpy's zipf redraws ranks past it


def zipf_ranks(n: int, a: float, g: torch.Generator, dev) -> torch.Tensor:
    """n Zipf(a) ranks >= 1 as float64: numpy's random_zipf, vectorised;
    rejected draws are drawn again until none is left."""
    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    todo = torch.arange(n, device=dev)
    while todo.numel():
        u = 1.0 - torch.rand(todo.numel(), generator=g, dtype=torch.float64,
                             device=dev)
        v = torch.rand(todo.numel(), generator=g, dtype=torch.float64,
                       device=dev)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x <= INT64_MAX) & (x >= 1.0) \
            & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def absent_keys(n: int, keys: torch.Tensor, bits: int, g: torch.Generator,
                dev) -> torch.Tensor:
    """n uniform keys below 2^bits that the ascending `keys` do not hold."""
    out = torch.randint(0, 1 << bits, (n,), generator=g, device=dev)
    while True:
        pos = torch.searchsorted(keys, out).clamp_(max=keys.numel() - 1)
        hit = (keys[pos] == out).nonzero().flatten()
        if not hit.numel():
            return out
        out[hit] = torch.randint(0, 1 << bits, (hit.numel(),), generator=g,
                                 device=dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def make(cfg: dict, table: str | None, seed: int):
    """(build_keys, build_values, probe_keys) as uint64 numpy columns."""
    if table is not None:
        raise ValueError(f"zipf has one build side (got table {table!r})")
    nb, npr, bits = cfg["build_rows"], cfg["probe_rows"], cfg["key_bits"]
    if bits > 62:
        raise ValueError("keys below 2^62 at most: they are drawn as int64")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    g = torch.Generator(dev)
    g.manual_seed(int(np.random.SeedSequence(seed).generate_state(
        1, np.uint64)[0]))
    bk = torch.unique(torch.randint(0, 1 << bits, (nb,), generator=g,
                                    device=dev))          # sorted
    bv = torch.empty(bk.numel(), dtype=torch.int64, device=dev).random_(
        generator=g)                                     # [0, 2^63)
    rank = zipf_ranks(npr, cfg["zipf_a"], g, dev)
    pk = bk[rank.clamp_(max=bk.numel()).to(torch.int64) - 1]
    del rank
    misses = round(npr * cfg["miss_share"])
    at = torch.randperm(npr, generator=g, device=dev)[:misses]
    pk[at] = absent_keys(misses, bk, bits, g, dev)
    return _host(bk), _host(bv), _host(pk)
