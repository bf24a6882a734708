"""Sampled heavy-hitter detection for the distributed hash shuffle (port of
flash_hash_join_tpu/parallel/hotkeys.py).

A Zipf-hot probe key hashes to one home rank; shuffled, its probes would
pile onto that rank, costing it memory and time.  The remedy: replicate
the hot BUILD rows to every rank and keep the hot PROBE rows where they
are.  The hot set is a consensus, from a strided sample:

  1. each rank samples S probe keys (stride n/S);
  2. one all_gather makes the (ranks * S,) sample the same on every rank;
  3. keys covering >= max(ceil(samples / CAP), 2) sampled rows are hot (at
     most CAP keys can reach that share, so CAP slots never truncate the
     qualifying set), in ascending key order.

Same sample, threshold and cap as the JAX package, so the same hot set on
the same shards.  The shuffle here is ragged and drops nothing, so hot
keys are about balance, not exactness.

Membership: the JAX package compares every row with every slot, an
(n, CAP) broadcast; here a row's key is searched among the hot set's
sorted int64 keys (utils/u64.sortable), n log CAP work and an int64 a
row of transients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_hash_join_tpu_torch.utils.u64 import (INT32_MIN, MASK32, narrow,
                                                 sortable)

HOT_CAP = 32          # hot-set slots; threshold = 1/HOT_CAP of the sample
SAMPLES_PER_SHARD = 512


class HotSet(NamedTuple):
    """The replicated hot set: kh, kl (cap,) int32 bit patterns of the
    slots (0 past the used ones), used (cap,) bool, as in the JAX package;
    keys the used slots' sortable int64 keys, ascending."""

    kh: torch.Tensor
    kl: torch.Tensor
    used: torch.Tensor
    keys: torch.Tensor


def detect_hot_keys(mesh, ph, pl, *, cap: int = HOT_CAP,
                    samples_per_shard: int = SAMPLES_PER_SHARD) -> list:
    """The consensus hot set from a strided sample of each rank's probe
    keys (ph[i], pl[i]: the i-th local rank's int32 planes); one HotSet a
    local rank, all equal."""
    samples = []
    for i in range(len(mesh.local)):
        n = ph[i].numel()
        s = min(samples_per_shard, n)
        idx = torch.arange(s, device=ph[i].device) * max(n // max(s, 1), 1)
        # (S, 3): the key words and a valid flag; a short shard pads with
        # invalid rows, so every rank gathers the same shape
        rows = torch.zeros((samples_per_shard, 3), dtype=torch.int32,
                           device=ph[i].device)
        rows[:s, 0], rows[:s, 1], rows[:s, 2] = ph[i][idx], pl[i][idx], 1
        samples.append(rows)
    hot = []
    for i, g in enumerate(mesh.all_gather(samples)):
        g = g[g[:, 2] == 1]
        thresh = max(-(-g.shape[0] // cap), 2)
        keys, runs = torch.unique(sortable(g[:, 0], g[:, 1]),
                                  return_counts=True)
        keys = keys[runs >= thresh][:cap]
        used = torch.arange(cap, device=g.device) < keys.numel()
        words = torch.zeros((2, cap), dtype=torch.int32, device=g.device)
        words[0, :keys.numel()] = (keys >> 32).to(torch.int32) ^ INT32_MIN
        words[1, :keys.numel()] = narrow(keys & MASK32)
        hot.append(HotSet(words[0], words[1], used, keys))
    return hot


def _slots(kh, kl, hot: HotSet):
    """(slot, member): each row's position in the hot set's keys and
    whether its key is there."""
    k = sortable(kh, kl)
    if hot.keys.numel() == 0:
        return torch.zeros_like(k), torch.zeros(k.shape, dtype=torch.bool,
                                                device=k.device)
    slot = torch.searchsorted(hot.keys, k).clamp_(max=hot.keys.numel() - 1)
    return slot, hot.keys[slot] == k


def is_member(kh: torch.Tensor, kl: torch.Tensor, hot: HotSet) -> torch.Tensor:
    """(n,) bool: the row's key is in the hot set."""
    return _slots(kh, kl, hot)[1]


def gather_hot_build_rows(mesh, cols, hot) -> list:
    """Every rank's FIRST build row of each hot key, replicated: cols[i]
    is the i-th local rank's (kh, kl, vh, vl) int32 planes, hot[i] its hot
    set.  First-match dedup needs one row a hot key a rank; in rank order,
    the first is the key's minimum build row.  Returns, a local rank, the
    found rows as (m, 4) int32, rank-major, then in hot-key order."""
    sends = []
    for i, (c, h) in enumerate(zip(cols, hot)):
        n, cap = c[0].numel(), h.used.numel()
        slot, member = _slots(c[0], c[1], h)
        rows = torch.where(member, torch.arange(n, device=slot.device), n)
        first = torch.full((cap,), n, dtype=torch.int64, device=slot.device)
        first.scatter_reduce_(0, slot, rows, "amin")
        found = first < n
        out = torch.zeros((cap, 5), dtype=torch.int32, device=slot.device)
        if n:
            at = first.clamp(max=n - 1)
            out[:, :4] = torch.stack([col[at] for col in c], 1)
        out[:, 4] = found.to(torch.int32)
        sends.append(out)
    return [g[g[:, 4] == 1][:, :4] for g in mesh.all_gather(sends)]
