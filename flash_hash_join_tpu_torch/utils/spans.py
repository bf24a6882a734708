"""Spans and call counts: the package's one tracing mechanism.

`span(name)` marks a stretch of host work.  It always adds one to the
count kept for `name`; only while a torch.profiler runs does it also
record a host event of that name (torch's `_RecordFunctionFast`, scope
FUNCTION, as aten ops have).  Such an event lies on the profiler's clock
beside the card's kernels and puts nothing on the card: a
`record_function` range (USER_SCOPE) would be mirrored there as a
`gpu_user_annotation` op.  With no profiler running a span costs one dict
increment and one check; it never synchronises, allocates or reads a
device value.  Counts are kept per process; the increment has no lock:
under the interpreter lock the eval loop does not switch threads between
its read and its store (the distributed ranks span from a thread a card;
tests/test_torch_spans.py holds this).

The spans, with their parent and what each covers:

  fhj.api.route          none: routing in api._route, the plan and gates
  fhj.api.h2d            none or fhj.api.chunk: the device_planes copies,
                         a streamed chunk's copy
  fhj.api.chunk          none: one streamed chunk of api._run_chunked
  fhj.api.readback       none: to_numpy_u64 of the matched rows
  fhj.join               none or fhj.api.chunk: one whole join, a call of
                         a function engine.count_graph / materialize_graph
                         returns
  fhj.direct             fhj.join: K1 / K2; the value planes with K7 / K8
  fhj.partitioned.build  fhj.join: the table's sorted keys and values
                         (the build kernel, or the plain sort, stack and
                         gather) and the directory
  fhj.partitioned.probe  fhj.join: K3 / K4 by either route (a chunked
                         count's loop too)
  fhj.global.build       fhj.join: the global build, kernel or plain
  fhj.global.walk        fhj.join: the global walk, the restore included
  fhj.global.prune       fhj.global.walk: a count's bloom prune, a pass
                         at a time (the card's 1-level route; on the CPU
                         each chunk of the plain walk)
  fhj.vmem               fhj.join: the whole vmem tier, its compaction too
  fhj.merge              fhj.join: the whole merge tier, its compaction too
  fhj.compact            fhj.join, fhj.vmem or fhj.merge: compact_by_mask
                         of ops/compact.py, K5 or (FHJ_COMPACT=stream) the
                         blockwise sort and K6, with their scratch and
                         torch ops
  fhj.k.<key>            its tier's span: one wrapper call that launches
                         on the card (card only); <key> is the wrapper's
                         key in api.launch_counts()

The distributed ranks (parallel/) call the tiers' functions, not the
engine's: their spans are fhj.global.*, fhj.compact and fhj.merge with no
fhj.join above them.
"""

from __future__ import annotations

import contextlib

import torch

API_ROUTE = "fhj.api.route"
API_H2D = "fhj.api.h2d"
API_CHUNK = "fhj.api.chunk"
API_READBACK = "fhj.api.readback"
JOIN = "fhj.join"
DIRECT = "fhj.direct"
PARTITIONED_BUILD = "fhj.partitioned.build"
PARTITIONED_PROBE = "fhj.partitioned.probe"
GLOBAL_BUILD = "fhj.global.build"
GLOBAL_WALK = "fhj.global.walk"
GLOBAL_PRUNE = "fhj.global.prune"
VMEM = "fhj.vmem"
MERGE = "fhj.merge"
COMPACT = "fhj.compact"

KERNEL_PREFIX = "fhj.k."
K_DENSE_BITMAP = "fhj.k.dense_bitmap"
K_SCAN_DOMAIN_COUNT = "fhj.k.scan_domain_count"
K_RANGE_PROBE_COUNT = "fhj.k.range_probe_count"
K_RANGE_PROBE_MATERIALIZE = "fhj.k.range_probe_materialize"
K_RANGE_DIRECTORY = "fhj.k.range_directory"
K_COMPACT = "fhj.k.compact"
K_PROBE_GATHER_BITMAP = "fhj.k.probe_gather_bitmap"
K_PROBE_GATHER_STAGED = "fhj.k.probe_gather_staged"
K_MATERIALIZE_COPY = "fhj.k.materialize_copy"
K_PROBE_COUNT_VMEM = "fhj.k.probe_count_vmem"
K_PROBE_MATERIALIZE_VMEM = "fhj.k.probe_materialize_vmem"
K_CONCAT_RAGGED_BLOCKS = "fhj.k.concat_ragged_blocks"
K_GLOBAL_WALK_COUNT = "fhj.k.global_walk_count"
K_GLOBAL_WALK_MATERIALIZE = "fhj.k.global_walk_materialize"
K_GLOBAL_BUILD = "fhj.k.global_build"
K_RANGE_BUILD = "fhj.k.range_build"
K_GLOBAL_PRUNE = "fhj.k.global_prune"
K_RANGE_PROBE_SLICED = "fhj.k.range_probe_sliced"

# the wrappers' launch spans, in launch_counts()'s order
KERNELS = (K_DENSE_BITMAP, K_SCAN_DOMAIN_COUNT, K_RANGE_PROBE_COUNT,
           K_RANGE_PROBE_MATERIALIZE, K_RANGE_DIRECTORY, K_COMPACT,
           K_PROBE_GATHER_BITMAP, K_PROBE_GATHER_STAGED, K_MATERIALIZE_COPY,
           K_PROBE_COUNT_VMEM, K_PROBE_MATERIALIZE_VMEM,
           K_CONCAT_RAGGED_BLOCKS, K_GLOBAL_WALK_COUNT,
           K_GLOBAL_WALK_MATERIALIZE, K_GLOBAL_BUILD, K_RANGE_BUILD,
           K_GLOBAL_PRUNE, K_RANGE_PROBE_SLICED)
NAMES = (API_ROUTE, API_H2D, API_CHUNK, API_READBACK, JOIN, DIRECT,
         PARTITIONED_BUILD, PARTITIONED_PROBE, GLOBAL_BUILD, GLOBAL_WALK,
         GLOBAL_PRUNE, VMEM, MERGE, COMPACT, *KERNELS)

NONE = contextlib.nullcontext()     # no span: what span() gives, unrecorded
_counts = dict.fromkeys(NAMES, 0)
_profiling = torch._C._autograd._profiler_enabled
_event = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager over the work of span `name` (one of NAMES)."""
    _counts[name] += 1
    if _profiling():
        return _event(name)
    return NONE


def counts() -> dict:
    """The spans opened so far in this process, by name."""
    return dict(_counts)


def reset() -> None:
    """Zero every count (for tests)."""
    for name in _counts:
        _counts[name] = 0
