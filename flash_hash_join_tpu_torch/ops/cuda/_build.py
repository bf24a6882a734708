"""Build and load the package's CUDA kernels.

`nvcc` compiles every ``csrc/*.cu`` for ``sm_90a`` (Hopper) at first use,
into ``csrc/build/``: one nvcc process per source, all started together,
then one link into a shared library with a plain C interface.  A source
newer than the library triggers a rebuild.  The library is loaded with
ctypes: pointers and the stream are ``c_void_p``, sizes ``c_int`` /
``c_int64``, and every entry point returns ``cudaGetLastError()`` after its
launches, which `check` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and the
machines that run them have no nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
LIB_PATH = BUILD_DIR / "libfhj_cuda.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    # kh, kl, nb, ph, pl, np, bitmap, d_rows, scratch, stream
    "fhj_fused_domain_bitmap_join": [_P, _P, _I64, _P, _P, _I64, _P, _I64,
                                     _P, _P],
    # kh, kl, nb, ph, pl, np, bitmap, d_rows, scratch, stream
    "fhj_scan_domain_count": [_P, _P, _I64, _P, _P, _I64, _P, _I, _P, _P],
    # bitmap, p0, p1, v_rows, ph, pl, n, np_valid, lo, hit, o0, o1, stream
    "fhj_scan_domain_gather": [_P, _P, _P, _I, _P, _P, _I64, _I64, _P, _P, _P,
                               _P, _P],
    # bitmap, p0, p1, v_rows, ph, pl, n, np_valid, lo, hit, o0, o1, stream
    "fhj_staged_domain_gather": [_P, _P, _P, _I, _P, _P, _I64, _I64, _P, _P,
                                 _P, _P, _P],
    # src, dst, n, stream
    "fhj_materialize_copy": [_P, _P, _I64, _P],
    # keys, nb, p, dir, dir_bytes, shift, stream
    "fhj_range_directory": [_P, _I64, _I, _P, _I, _P, _P],
    # keys, nb, dir, dir_bytes, shift, ph, pl, np, count, stream
    "fhj_range_probe_count": [_P, _I64, _P, _I, _P, _P, _P, _I64, _P, _P],
    # keys, nb, dir, dir_bytes, shift, values, ph, pl, n, np_valid, hit, vh,
    # vl, stream
    "fhj_range_probe_materialize": [_P, _I64, _P, _I, _P, _P, _P, _P, _I64,
                                    _I64, _P, _P, _P, _P],
    # keys, nb, dir, dir_bytes, shift, p, values, ph, pl, n, np_valid, hit,
    # vh, vl, pbits, pass_rows, blocks, scratch, scratch_bytes, stream
    "fhj_range_probe_sliced": [_P, _I64, _P, _I, _P, _I, _P, _P, _P, _I64,
                               _I64, _P, _P, _P, _I, _I64, _I, _P, _I64, _P],
    "fhj_compact_tile_rows": [],
    # mask, n, n_planes, in0..in3, out0..out3, n_out, scratch, scratch_words,
    # stream
    "fhj_compact_by_mask": [_P, _I64, _I, *[_P] * 8, _I64, _P, _I64, _P],
    # counts, count_bytes, nblocks, block_elems, n_planes, in0..in3,
    # out0..out3, scratch, scratch_words, stream
    "fhj_concat_ragged_blocks": [_P, _I, _I64, _I64, _I, *[_P] * 8, _P, _I64,
                                 _P],
    # tk_hi, tk_lo, r_slots, keys, ph, pl, np, pre_shift, count, stream
    "fhj_bucket_probe_count": [_P, _P, _I, _P, _P, _P, _I64, _I, _P, _P],
    # tk_hi, tk_lo, tv_hi, tv_lo, r_slots, keys, vals, ph, pl, n, np_valid,
    # pre_shift, hit, vh, vl, stream
    "fhj_bucket_probe_materialize": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I64,
                                     _I64, _I, _P, _P, _P, _P],
    # tk_hi, tk_lo, tv_hi, tv_lo, r_slots, keys, vals, stream
    "fhj_bucket_major": [_P, _P, _P, _P, _I, _P, _P, _P],
    # keys, bloom, special, total_groups, group_size, gbits, pre_shift,
    # bloom_k, max_iters, ph, pl, np_valid, count, stats, pbits, pass_rows,
    # blocks, scratch, scratch_bytes, survivors, stream
    "fhj_global_walk_count": [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _P, _P,
                              _I64, _P, _P, _I, _I64, _I, _P, _I64, _P, _P],
    # bloom, words, n_words, special, gbits, pre_shift, bloom_k, ph, pl, n,
    # sh, sl, rows, count, stats, stream
    "fhj_global_prune": [_P, _P, _I64, _P, _I, _I, _I, _P, _P, _I64, _P, _P,
                         _P, _P, _P, _P],
    # keys, vals, bloom, special, total_groups, group_size, gbits,
    # pre_shift, bloom_k, max_iters, ph, pl, n, np_valid, hit, vh, vl, stats,
    # pbits, pass_rows, blocks, scratch, scratch_bytes, stream
    "fhj_global_walk_materialize": [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I,
                                    _P, _P, _I64, _I64, _P, _P, _P, _P, _I,
                                    _I64, _I, _P, _I64, _P],
    # kh, kl, vh, vl, n_valid, gbits, group_size, total_groups, pre_shift,
    # bloom_k, max_iters, keys, vals, bloom, bloom_words, with_bloom,
    # special, scratch, scratch_bytes, levels, bits0, bits1, blocks0,
    # blocks1, stream
    "fhj_global_build": [_P, _P, _P, _P, _I64, _I, _I, _I64, _I, _I, _I, _P,
                         _P, _P, _I64, _I, _P, _P, _I64, _I, _I, _I, _I, _I,
                         _P],
    # kh, kl, vh, vl, n, with_values, out, buf, scratch, scratch_bytes,
    # stream
    "fhj_range_build": [_P, _P, _P, _P, _I64, _I, _P, _P, _P, _I64, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    """nvcc on PATH, else the one under CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{CSRC} at first use and need the CUDA toolkit")
    return nvcc


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; returns their joined output, raises
    with the output of every one that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}"
              for cmd, p, out in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> str:
    """Compile the kernels into LIB_PATH; returns nvcc's output (ptxas
    register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{tag}.tmp"
    try:
        report = _run_all([[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)]
                           for s, o in zip(srcs, objs)])
        report += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                             *map(str, objs)]])
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return report


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            loaded = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            loaded.fhj_global_build_scratch_bytes.argtypes = [_I64, _I, _I,
                                                              _I, _I, _I, _I]
            loaded.fhj_global_build_scratch_bytes.restype = ctypes.c_int64
            # gbits, pbits, pass_rows, blocks, materialize
            loaded.fhj_global_walk_scratch_bytes.argtypes = [_I, _I, _I64,
                                                             _I, _I]
            loaded.fhj_global_walk_scratch_bytes.restype = ctypes.c_int64
            # p, pbits, pass_rows, blocks
            loaded.fhj_range_probe_sliced_scratch_bytes.argtypes = [_I, _I,
                                                                    _I64, _I]
            loaded.fhj_range_probe_sliced_scratch_bytes.restype = ctypes.c_int64
            loaded.fhj_range_build_scratch_bytes.argtypes = [_I64]
            loaded.fhj_range_build_scratch_bytes.restype = ctypes.c_int64
            loaded.fhj_error_string.argtypes = [ctypes.c_int]
            loaded.fhj_error_string.restype = ctypes.c_char_p
            _lib = loaded
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib().fhj_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
