"""Ranks and their collectives for the distributed tier (port of
flash_hash_join_tpu/parallel/mesh.py).

A `Mesh` is an ordered list of rank devices.  The join code is written
once against per-rank tensor lists, one entry for each rank this process
drives (`mesh.local`), and three collectives:

  all_to_all  ragged: each rank sends `send_splits[d]` rows to rank d;
  all_gather  every rank's equal-shaped tensor, concatenated in rank order;
  sum         the ranks' scalars added up, as a host int.

A rank's own work between collectives goes through `mesh.map(fn)`.

Two implementations:
  * `Mesh`: one process drives every rank, as JAX's single controller
    does.  A transfer is `tensor.to(dst, non_blocking=True)`: NVLink P2P
    between cards, a device-local copy where ranks share a card.  The ranks
    may repeat a device (`["cuda:0"] * 4`, `["cpu"] * 8`), the counterpart
    of the JAX package's virtual devices.  `map(fn, threaded=True)`
    drives the ranks of distinct cards from a thread a card, for the work
    that runs outside the interpreter lock: the host split and copy of the
    shards, and the read-back.
  * `GroupMesh`: one rank a process over `torch.distributed` (NCCL on
    cards, gloo on the CPU; parallel/multihost.py builds it):
    `all_to_all_single` with split sizes, `all_gather_into_tensor`,
    `all_reduce`.

The rank count is a power of two: a row's destination rank is a bit-slice
of its key's hash (parallel/shuffle.py).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.distributed as dist

from flash_hash_join_tpu_torch.utils.streams import copy_stream


def _power_of_two(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the rank count must be a power of two, got {n}")


def _indexed(dev: torch.device) -> torch.device:
    """A card named without an index is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Pending:
    """An exchange in flight: wait() returns the received tensors, one a
    local rank, ready for the compute stream of its device."""

    def __init__(self, outs, done):
        self._outs, self._done = outs, done

    def wait(self) -> list:
        self._done()
        return self._outs


class Mesh:
    """Ranks driven by this one process: rank r lives on devices[r]."""

    def __init__(self, devices):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        self.size = len(self.devices)
        _power_of_two(self.size)
        self.local = tuple(range(self.size))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({[str(d) for d in self.devices]})"

    def device(self, i: int) -> torch.device:
        """The device of the i-th local rank."""
        return self.devices[self.local[i]]

    def guard(self, i: int):
        """Make the i-th local rank's card the current one: the kernels'
        library launches on the current card."""
        dev = self.device(i)
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def map(self, fn, *, threaded: bool = False) -> list:
        """[fn(i) for each local rank i], each call under the rank's guard
        and on the caller's current stream of its card, in rank order.
        threaded: the ranks of distinct devices run in threads, one a
        device, a device's ranks in turn.  Only for work that leaves the
        interpreter lock for long: the global walk's thousands of small
        launches, a host sync each iteration, ran 2-3x slower so on four
        cards than in one thread (PERF.md, PR 12)."""
        groups = {}
        for i in range(len(self.local)):
            groups.setdefault(self.device(i), []).append(i)
        streams = {d: torch.cuda.current_stream(d) for d in groups
                   if d.type == "cuda"}

        def run(dev, ranks):
            on_stream = (torch.cuda.stream(streams[dev]) if dev in streams
                         else contextlib.nullcontext())
            out = []
            with on_stream:
                for i in ranks:
                    with self.guard(i):
                        out.append(fn(i))
            return out
        if not threaded or len(groups) == 1:
            return [r for i in range(len(self.local))
                    for r in run(self.device(i), [i])]
        out, errors = [None] * len(self.local), []

        def run_into(dev):
            try:
                for i, r in zip(groups[dev], run(dev, groups[dev])):
                    out[i] = r
            except BaseException as e:      # raised again in the caller
                errors.append(e)
        threads = [threading.Thread(target=run_into, args=(d,))
                   for d in groups]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out

    def synchronize(self) -> None:
        for dev in set(self.devices[r] for r in self.local):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def all_to_all(self, sends, send_splits, recv_splits) -> _Pending:
        """Rank s sends rows [offset, offset + send_splits[s][d]) of
        sends[s] to rank d, offsets in rank order; rank d receives them
        from every rank in rank order (recv_splits[d][s] rows from rank s).
        On cards the copies run on each card's copy stream
        (utils/streams.py), behind the compute streams, so the caller may
        compute while they run; wait() makes the compute streams wait."""
        cards = sorted({d.index for d in self.devices if d.type == "cuda"})
        copies = {i: copy_stream(i) for i in cards}
        for i in cards:
            copies[i].wait_stream(torch.cuda.current_stream(i))
        for t in sends:
            if t.is_cuda:
                t.record_stream(copies[t.device.index])
        bounds = [np.cumsum([0, *sp]) for sp in send_splits]
        outs = []
        with contextlib.ExitStack() as on_copy:
            for i in cards:     # every card's current stream: its copy stream
                on_copy.enter_context(torch.cuda.stream(copies[i]))
            for d, dev in enumerate(self.devices):
                pieces = [sends[s][bounds[s][d]:bounds[s][d + 1]].to(
                    dev, non_blocking=True) for s in range(self.size)]
                outs.append(torch.cat(pieces))
        events = {}
        for i in cards:
            events[i] = torch.cuda.Event()
            events[i].record(copies[i])

        def done():
            for i, ev in events.items():
                compute = torch.cuda.current_stream(i)
                compute.wait_event(ev)
            for out in outs:
                if out.is_cuda:
                    out.record_stream(torch.cuda.current_stream(out.device))
        return _Pending(outs, done)

    def all_gather(self, ts) -> list:
        """Every rank's tensor (all shaped alike), concatenated along dim
        0 in rank order, on each local rank's device."""
        return [torch.cat([t.to(dev) for t in ts]) for dev in self.devices]

    def sum(self, ts) -> int:
        """The ranks' 0-d integer tensors added up."""
        return int(sum(int(t) for t in ts))


class GroupMesh(Mesh):
    """One rank a process of the default torch.distributed group: this
    process drives rank `rank`, on devices[rank]."""

    def __init__(self, devices, rank: int):
        super().__init__(devices)
        self.local = (rank,)

    def all_to_all(self, sends, send_splits, recv_splits) -> _Pending:
        send, = sends
        out = send.new_empty((sum(recv_splits[0]), *send.shape[1:]))
        work = dist.all_to_all_single(out, send.contiguous(), recv_splits[0],
                                      send_splits[0], async_op=True)
        return _Pending([out], work.wait)

    def all_gather(self, ts) -> list:
        t, = ts
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous())
        return [out]

    def sum(self, ts) -> int:
        t, = ts
        t = t.detach().clone().to(torch.int64)
        dist.all_reduce(t)
        return int(t)


def data_mesh(n_devices: int | None = None, *, devices=None,
              device="cuda") -> Mesh:
    """An in-process mesh.  devices lists the ranks' devices and may
    repeat one.  Otherwise n_devices ranks on distinct devices of the
    type of `device`: cards cuda:0 .. cuda:n-1 (default: the largest power
    of two <= torch.cuda.device_count()), or n_devices ranks on the CPU
    (default 1).  Asking for more distinct cards than exist raises, as does
    a rank count that is not a power of two."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             "devices listed")
        return Mesh(devices)
    dev = torch.device(device)
    if dev.type == "cpu":
        return Mesh(["cpu"] * (1 if n_devices is None else n_devices))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("device='cuda' but no CUDA card is available; "
                           "pass device='cpu' or devices=[...]")
    if n_devices is None:
        n_devices = 1 << (have.bit_length() - 1)
    if n_devices > have:
        raise ValueError(f"{n_devices} distinct cards asked for, {have} "
                         "present; list devices=[...] to put ranks on one "
                         "card")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)])
