"""Multi-process initialisation and the process-group mesh (port of
flash_hash_join_tpu/parallel/multihost.py).

One rank a process over torch.distributed: NCCL when the rank's device is
a card, gloo on the CPU.  Nothing tells a program of a cluster, so the
coordinator's address, the world size and the rank are passed in (or read
from torch's own RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
environment).  One card cannot host two NCCL ranks: on cards the world is
at most the number of cards, one rank each (LOCAL_RANK, default the rank,
picks the card).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from flash_hash_join_tpu_torch.parallel.mesh import GroupMesh

TIMEOUT_SECONDS = 300


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device="cuda",
                         timeout_seconds: float = TIMEOUT_SECONDS) -> None:
    """init_process_group for this process: coordinator_address
    "host:port" (a free port), num_processes the world size, process_id
    this process's rank; without them, torch's environment variables.  On
    a card the process's card is set first (LOCAL_RANK, default the rank
    modulo the cards), then NCCL starts; on the CPU, gloo.  A failed start
    raises."""
    kind = torch.device(device).type
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        timeout=datetime.timedelta(seconds=timeout_seconds), **kwargs)


def pod_mesh(device="cuda") -> GroupMesh:
    """The mesh of every process of the group, in rank order (host-major
    when ranks are numbered host by host).  This process's rank is on its
    current card, or the CPU; the other ranks are listed on card r modulo
    this host's cards (hosts alike).  The world must be a power of two."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if torch.device(device).type != "cuda":
        return GroupMesh(["cpu"] * world, rank)
    devices = [torch.device("cuda", r % torch.cuda.device_count())
               for r in range(world)]
    devices[rank] = torch.device("cuda", torch.cuda.current_device())
    return GroupMesh(devices, rank)


def process_local_rows(n_global: int) -> tuple[int, int]:
    """(start, count) of this process's row range, ceil(n / processes)
    rows a process, for feeding each process its own rows."""
    p, np_ = dist.get_rank(), dist.get_world_size()
    per = -(-n_global // np_)
    start = min(p * per, n_global)
    return start, min(per, n_global - start)
