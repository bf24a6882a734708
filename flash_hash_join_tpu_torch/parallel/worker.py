"""Worker process of a multi-process distributed join: one rank a process
over torch.distributed (parallel/multihost.py), the port's counterpart of
scripts/multihost_worker.py.

    python -m flash_hash_join_tpu_torch.parallel.worker PORT RANK WORLD \
        [--device cuda|cpu] [--case random|uniform|zipf] \
        [--build-rows N] [--probe-rows N] [--timeout S]

Every process makes the same data from one seed (random: 64-bit keys, half
the probes drawn from the build keys; uniform: models/workload.uniform_case
at 50 % match; zipf: zipf_probe_case(a=1.2), every probe a build key),
takes its rank's share and joins across the process boundary.  It checks
the mesh's rank order and process_local_rows' tiling, runs the count twice
(the first call also starts the communicators) and the materialize, and
holds them against an oracle on its own device: the count equals the
probes found among the sorted build keys; the ranks' materialized rows
add up to it, and so do their keys' sum (a multiset checksum); each row's
key is a build key and its value that of the key's minimum build row.  It
prints "MHSTAGES {json}" (each call's seconds and stages, the rows each
rank received) and, last, "MHOK process=RANK world=WORLD device=...
count=N".  A failed check raises, so the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from flash_hash_join_tpu_torch.models.workload import (uniform_case,
                                                       zipf_probe_case)
from flash_hash_join_tpu_torch.parallel.distributed_join import (
    distributed_join_exact)
from flash_hash_join_tpu_torch.parallel.multihost import (
    initialize_multihost, pod_mesh, process_local_rows)
from flash_hash_join_tpu_torch.utils.config import JoinConfig

FLIP = np.int64(np.iinfo(np.int64).min)     # u64 order as signed order


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_case(case: str, nb: int, npr: int):
    """(bk, bv, pk) numpy u64, the same on every process."""
    if case == "uniform":
        c = uniform_case(nb, npr, 0.5)
        return c.build_keys, c.build_values, c.probe_keys
    if case == "zipf":
        c = zipf_probe_case(nb, npr, a=1.2, seed=0, threads=8)
        return c.build_keys, c.build_values, c.probe_keys
    rng = np.random.default_rng(4242)
    bk = rng.integers(0, 2**64, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**64, nb, dtype=np.uint64)
    nm = npr // 2
    pk = np.concatenate([rng.choice(bk, nm),
                         rng.integers(0, 2**64, npr - nm, dtype=np.uint64)])
    rng.shuffle(pk)
    return bk, bv, pk


class Oracle:
    """The build side sorted on `dev` (u64 keys as signed int64, a stable
    sort, so a key's first position is its minimum build row)."""

    def __init__(self, bk, bv, dev):
        keys = torch.from_numpy(bk.view(np.int64)).to(dev) ^ FLIP
        self.keys, self.rows = torch.sort(keys, stable=True)
        self.values = torch.from_numpy(bv.view(np.int64)).to(dev)
        self.dev = dev

    def find(self, u64_keys):
        """(keys as int64, found, the minimum build row of each)."""
        k = torch.from_numpy(u64_keys.view(np.int64)).to(self.dev) ^ FLIP
        at = torch.searchsorted(self.keys, k).clamp_(
            max=max(self.keys.numel() - 1, 0))
        return k, self.keys[at] == k, self.rows[at]


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--case", default="random",
                    choices=("random", "uniform", "zipf"))
    ap.add_argument("--build-rows", type=int, default=2048)
    ap.add_argument("--probe-rows", type=int, default=8192)
    ap.add_argument("--timeout", type=float, default=60.0)
    return ap


def main(argv=None) -> None:
    a = arg_parser().parse_args(argv)
    initialize_multihost(f"localhost:{a.port}", a.world, a.rank,
                         device=a.device, timeout_seconds=a.timeout)
    try:
        mesh = pod_mesh(a.device)
        dev = mesh.device(0)
        require(mesh.size == a.world and mesh.local == (a.rank,),
                f"mesh {mesh} is not rank {a.rank} of {a.world}")
        # the processes' process_local_rows tile [0, n) in rank order
        for n in (1, 7, 1000, 4096):
            got = [None] * a.world
            dist.all_gather_object(got, process_local_rows(n))
            require(sum(c for _, c in got) == n and got == sorted(got),
                    f"process_local_rows({n}) does not tile: {got}")

        t0 = time.perf_counter()
        bk, bv, pk = make_case(a.case, a.build_rows, a.probe_rows)
        report = dict(case=a.case, nb=len(bk), npr=len(pk),
                      generate_seconds=time.perf_counter() - t0)
        cfg = JoinConfig(probe_chunk=1 << 12) if a.case == "random" \
            else JoinConfig()

        def timed(name, **kw):
            t = time.perf_counter()
            res = distributed_join_exact(mesh, bk, bv, pk, cfg=cfg, **kw)
            report[name] = dict(seconds=time.perf_counter() - t,
                                stages=res.info["stages"],
                                build_rows=res.info["build_rows"],
                                probe_rows=res.info["probe_rows"],
                                hot_keys=res.info["hot_keys"],
                                drops=res.info["drops"])
            return res
        count = timed("count_first").count
        require(timed("count").count == count, "the two counts differ")
        res = timed("materialize", use_bloom=True, materialize=True)

        oracle = Oracle(bk, bv, dev)
        k, found, _ = oracle.find(pk)
        want = int(found.sum())
        want_sum = int(k[found].sum())
        del k, found
        require(count == want, f"count {count} != oracle {want}")
        mine = len(res.keys)
        require(res.count == count and mine == res.info["rank_counts"][0],
                f"materialize: {res.count} rows, {mine} here, {res.info}")
        k, found, row = oracle.find(res.keys)
        vals = torch.from_numpy(res.values.view(np.int64)).to(dev)
        require(bool(found.all()), "an output key is not a build key")
        require(torch.equal(oracle.values[row], vals),
                "an output value is not its key's minimum build row's")
        total = torch.tensor([mine, int(k.sum())], device=dev)
        dist.all_reduce(total)
        require(int(total[0]) == count and int(total[1]) == want_sum,
                f"the ranks' rows {total.tolist()} != count {count} and "
                f"its key sum {want_sum}")
        print("MHSTAGES " + json.dumps(report), flush=True)
        print(f"MHOK process={a.rank} world={a.world} device={dev} "
              f"count={count}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
