"""The port's coverage of the JAX package, name by name.

Every public top-level function and class of every module of
flash_hash_join_tpu/ (read with ast, so nothing of JAX is imported) has an
entry in COVERAGE: its counterpart in flash_hash_join_tpu_torch as
"module:attr" (relative to the port's package), or one of REASONS where
the port has none.  A new JAX name without an entry, a counterpart that
does not resolve, or a "never_called" name that gains a caller fails here.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_coverage.py -q
"""

import ast
import importlib
import inspect
import pathlib
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "flash_hash_join_tpu"
PORT = "flash_hash_join_tpu_torch"

REASONS = {
    "tpu_layout": "a helper of the TPU layout (the probe window, tiles, "
                  "lane-columns, Mosaic's compaction variants); the Hopper "
                  "kernels address rows directly (ops/range_table.py)",
    "window_gate": "a gate that keeps a TPU kernel's window or sort block "
                   "in bounds; the port's kernels have no window "
                   "(ops/direct_bitmap.py)",
    "xla_compile_cache": "the XLA AOT compile cache; the port runs eagerly "
                         "and builds its kernels once a process",
    "renamed_inside": "a helper folded into the port function named beside "
                      "it",
    "never_called": "no caller anywhere in the JAX package (checked)",
}


def _same(path: str, *names: str) -> dict:
    """Names ported under the same name into the port's module of the same
    path."""
    module = path[:-3].replace("/", ".")
    return {f"{path}:{name}": f"{module}:{name}" for name in names}


COVERAGE = {
    **_same("api.py", "adaptive_join", "adaptive_join_bloom",
            "adaptive_join_count", "adaptive_join_count_bloom", "hash_join",
            "hash_join_bloom", "hash_join_radix", "hash_join_radix_bloom",
            "hash_join_count", "hash_join_count_bloom",
            "hash_join_count_radix", "hash_join_count_radix_bloom",
            "initialize", "plan_strategy", "bloom_is_distinct",
            "measure_device_seconds", "distributed_join_count",
            "distributed_join_materialize", "join_count", "join_materialize"),
    "engine.py:join_count_graph": "engine:global_count_graph",
    "engine.py:join_materialize_graph": "engine:global_materialize_graph",
    **_same("engine.py", "merge_count_graph", "merge_materialize_graph",
            "direct_count_graph"),
    "engine.py:vmem_count_graph": "engine:count_graph",
    "engine.py:vmem_materialize_graph": "engine:materialize_graph",
    "engine.py:direct_materialize_graph": "engine:materialize_graph",
    "engine.py:JoinEngine": "xla_compile_cache",
    "engine.py:default_engine": "xla_compile_cache",
    **_same("models/cost.py", "JoinPlan", "plan_probe_chunks", "choose_plan"),
    "models/cost.py:table_bytes": "never_called",
    **_same("models/workload.py", "JoinCase", "j1_suite", "uniform_case",
            "zipf_probe_case"),
    **_same("ops/aggregate.py", "GroupByResult", "hash_aggregate"),
    **_same("ops/bucket_table.py", "r_slots_for", "BucketTable",
            "build_bucket_table", "bucket_join_count",
            "bucket_join_materialize"),
    "ops/bucket_table.py:max_build_rows": "never_called",
    **_same("ops/compact.py", "compact_by_mask"),
    **_same("ops/direct_bitmap.py", "d_rows_for", "v_rows_for", "mat_wins",
            "direct_join_materialize", "direct_join_count",
            "large_span_wins", "direct_join_count_large"),
    "ops/direct_bitmap.py:sort_block_for": "window_gate",
    "ops/direct_bitmap.py:mat_span_ok": "window_gate",
    "ops/direct_bitmap.py:large_span_ok": "window_gate",
    **_same("ops/filter.py", "eq_u64", "lt_u64", "gt_u64", "le_u64",
            "ge_u64", "between_u64", "filter_columns"),
    **_same("ops/hash_table.py", "HashTable", "home_group", "build_table",
            "probe_count", "probe_materialize"),
    "ops/hash_table.py:probe_count_chunk": (
        "renamed_inside", "ops.hash_table:probe_count"),
    "ops/hash_table.py:probe_materialize_chunk": (
        "renamed_inside", "ops.hash_table:probe_materialize"),
    **_same("ops/hashing.py", "fmix32", "hash_u64", "bloom_word"),
    **_same("ops/merge_join.py", "merge_join_count",
            "merge_join_materialize"),
    # the eleven functions that reach pl.pallas_call: the kernel wrappers
    # of PERF.md §6's table, K1-K11
    "ops/pallas/dense_bitmap.py:fused_bitmap_join":
        "ops.cuda.dense_bitmap:fused_domain_bitmap_join",
    "ops/pallas/bitmap_probe.py:probe_count_bitmap":
        "ops.cuda.bitmap_probe:scan_domain_count",
    "ops/pallas/range_probe.py:range_probe_count":
        "ops.cuda.range_probe:range_probe_count",
    "ops/pallas/range_probe.py:range_probe_materialize":
        "ops.cuda.range_probe:range_probe_materialize",
    "ops/pallas/stream_compact.py:pack_concat_blocks":
        "ops.cuda.stream_compact:compact_by_mask",
    "ops/pallas/stream_compact.py:concat_ragged_blocks":
        "ops.cuda.stream_compact:concat_ragged_blocks",
    "ops/pallas/bitmap_probe.py:probe_gather_bitmap":
        "ops.cuda.bitmap_probe:probe_gather_bitmap",
    "ops/pallas/dense_values.py:probe_gather_staged":
        "ops.cuda.dense_values:probe_gather_staged",
    "ops/pallas/dense_values.py:materialize_copy":
        "ops.cuda.dense_values:materialize_copy",
    "ops/pallas/bucket_probe.py:probe_count_vmem":
        "ops.cuda.bucket_probe:probe_count_vmem",
    "ops/pallas/bucket_probe.py:probe_materialize_vmem":
        "ops.cuda.bucket_probe:probe_materialize_vmem",
    "ops/pallas/stream_compact.py:compact_by_mask_stream":
        "ops.compact:compact_by_mask_stream",
    "ops/pallas/stream_compact.py:compact_by_mask_pack": "tpu_layout",
    "ops/pallas/stream_compact.py:compact_by_mask_fast": "tpu_layout",
    **_same("ops/range_table.py", "RangeTable", "build_range_table",
            "range_join_count", "range_join_count_chunked",
            "range_join_materialize"),
    **{f"ops/range_table.py:{name}": "tpu_layout"
       for name in ("n_super_rows", "blockwise_window", "blockwise_ok",
                    "default_C", "default_tile_m", "small_mode",
                    "plan_window", "normalized_w_mult")},
    **_same("ops/segmented.py", "seg_ends", "seg_starts", "segmented_scan",
            "add_u64", "min_u64", "max_u64"),
    "ops/segmented.py:or_u32": "never_called",
    **_same("ops/sort.py", "sort_u64", "PartitionResult",
            "radix_partition_by_hash"),
    **_same("parallel/distributed_join.py", "DistJoinResult",
            "distributed_join_exact", "shard_columns"),
    "parallel/distributed_join.py:build_distributed_join":
        "parallel.distributed_join:distributed_join_exact",
    **_same("parallel/hotkeys.py", "HotSet", "detect_hot_keys", "is_member",
            "gather_hot_build_rows"),
    **_same("parallel/mesh.py", "data_mesh"),
    **_same("parallel/multihost.py", "initialize_multihost", "pod_mesh",
            "process_local_rows"),
    **_same("parallel/shuffle.py", "dest_device", "hash_shuffle"),
    **_same("utils/config.py", "next_pow2", "JoinConfig"),
    **_same("utils/native.py", "get_lib", "host_join_count",
            "host_join_materialize", "load_csv_u64"),
    **_same("utils/u64.py", "split_u64", "join_u64"),
}


def _modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        yield path.relative_to(JAX_PKG).as_posix(), ast.parse(
            path.read_text())


def _public_names() -> set:
    """'path:name' of every public top-level def and class of the JAX
    package."""
    return {f"{rel}:{node.name}" for rel, tree in _modules()
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")}


def _pallas_functions() -> set:
    """'path:name' of the top-level functions whose body reaches
    pl.pallas_call."""
    return {f"{rel}:{node.name}" for rel, tree in _modules()
            for node in tree.body if isinstance(node, ast.FunctionDef)
            and any(isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                    for n in ast.walk(node))}


def _target(entry):
    """The port's 'module:attr' an entry names, or None."""
    if isinstance(entry, tuple):
        return entry[1]
    return entry if ":" in entry else None


def _resolve(target: str):
    module, attr = target.split(":")
    return getattr(importlib.import_module(f"{PORT}.{module}"), attr)


def test_every_public_jax_name_has_an_entry():
    names = _public_names()
    assert len(names) > 100
    assert sorted(names - COVERAGE.keys()) == []      # JAX names unmapped
    assert sorted(COVERAGE.keys() - names) == []      # stale entries
    for key, entry in COVERAGE.items():
        reason = entry[0] if isinstance(entry, tuple) else entry
        assert _target(entry) or reason in REASONS, key
        assert isinstance(entry, str) or reason == "renamed_inside", key
    assert COVERAGE["ops/range_table.py:range_join_count_chunked"] == (
        "ops.range_table:range_join_count_chunked")


def _launch_spans(fn) -> set:
    """The launch spans (utils/spans.py's K_* names) a wrapper opens."""
    from flash_hash_join_tpu_torch.utils import spans
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return {getattr(spans, n.attr) for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "spans" and n.attr.startswith("K_")}


def test_every_counterpart_resolves_and_kernels_map_to_wrappers():
    for key, entry in COVERAGE.items():
        target = _target(entry)
        if target:
            assert callable(_resolve(target)), key
    # each TPU kernel maps to a CUDA wrapper that counts its launches: one
    # launch span of its own, a key of launch_counts()
    from flash_hash_join_tpu_torch.utils import spans
    pallas = _pallas_functions()
    assert len(pallas) == 11
    launch_spans = set()
    for key in pallas:
        target = _target(COVERAGE[key])
        assert target.startswith("ops.cuda."), key
        opened = _launch_spans(_resolve(target))
        assert len(opened) == 1 and opened <= set(spans.KERNELS), key
        launch_spans |= opened
    assert len({_target(COVERAGE[k]) for k in pallas}) == 11
    assert len(launch_spans) == 11
    # a name designed away has no namesake in the port's module of its path
    for key, entry in COVERAGE.items():
        if entry in ("tpu_layout", "window_gate", "xla_compile_cache"):
            path, name = key.split(":")
            module = path[:-3].replace("/", ".").replace("ops.pallas.",
                                                         "ops.cuda.")
            assert not hasattr(importlib.import_module(f"{PORT}.{module}"),
                               name), key


def test_never_called_names_have_no_caller_in_the_jax_package():
    never = {key.split(":")[1] for key, entry in COVERAGE.items()
             if entry == "never_called"}
    assert never == {"table_bytes", "max_build_rows", "or_u32"}
    used = set()
    for _, tree in _modules():
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                used.add(node.attr)
            elif isinstance(node, ast.alias):
                used.add(node.name.split(".")[-1])
    assert sorted(never & used) == []
