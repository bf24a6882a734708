"""A dry run of the whole distributed join at a small size (the port's
counterpart of __graft_entry__.dryrun_multichip)."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(n_processes: int, *args, device: str = "cuda",
                timeout: float = 180.0) -> list[str]:
    """Start parallel/worker.py as ranks 0 .. n_processes - 1 on
    localhost, each with `args` after its own; returns their outputs.
    Raises when one fails or outlasts `timeout` seconds (all are then
    killed)."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), *filter(None, [env.get("PYTHONPATH")])])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "flash_hash_join_tpu_torch.parallel.worker",
         str(port), str(rank), str(n_processes), "--device", device,
         *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(n_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"MHOK process={rank} " not in out:
            raise RuntimeError(f"worker {rank} failed ({p.returncode}):\n"
                               f"{out[-3000:]}")
    return outs


def dryrun_multichip(n_devices: int, n_processes: int | None = None, *,
                     device: str = "cuda") -> int:
    """The full distributed join (hot keys, both exchanges, the local
    tables, bloom, materialize) at 512 build and 2048 probe rows a rank,
    checked against numpy; returns the count.  In process: n_devices ranks
    on `device` (data_mesh).  With n_processes (1 included): that
    many worker processes (parallel/worker.py), one rank each, over
    torch.distributed on localhost (NCCL on cards, gloo on the CPU)."""
    nb, npr = 512 * n_devices, 2048 * n_devices
    if n_processes is not None:
        outs = run_workers(n_processes, "--build-rows", 512 * n_processes,
                           "--probe-rows", 2048 * n_processes, device=device)
        counts = {line.split("count=")[1] for out in outs
                  for line in out.splitlines() if "MHOK" in line}
        if len(counts) != 1:
            raise RuntimeError(f"the processes disagree: {counts}")
        count = int(counts.pop())
        print(f"dryrun_multichip({n_processes} processes, {device}): "
              f"count={count} OK")
        return count

    from flash_hash_join_tpu_torch.parallel.distributed_join import (
        distributed_join_exact)
    from flash_hash_join_tpu_torch.parallel.mesh import data_mesh
    from flash_hash_join_tpu_torch.utils.config import JoinConfig
    mesh = data_mesh(n_devices, device=device)
    rng = np.random.default_rng(1)
    bk = rng.integers(0, 2**63, nb, dtype=np.uint64)
    bv = rng.integers(0, 2**63, nb, dtype=np.uint64)
    pk = np.concatenate([rng.choice(bk, npr // 2),
                         rng.integers(0, 2**63, npr - npr // 2,
                                      dtype=np.uint64)])
    res = distributed_join_exact(mesh, bk, bv, pk,
                                 cfg=JoinConfig(probe_chunk=1 << 10),
                                 use_bloom=True, materialize=True)
    expected = int(np.isin(pk, np.unique(bk)).sum())
    if res.count != expected or sum(res.info["rank_counts"]) != res.count:
        raise RuntimeError(f"dryrun: count {res.count}, rank counts "
                           f"{res.info['rank_counts']}, oracle {expected}")
    print(f"dryrun_multichip({mesh}): count={res.count} OK")
    return res.count
