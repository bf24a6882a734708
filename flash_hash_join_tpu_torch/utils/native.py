"""ctypes binding of the port's C++ host runtime (csrc/host_runtime.cpp):
the exact first-match join oracle and the CSV column loader that the
harness (harness/benchmark.py, harness/fuzz_join.py) checks and loads with.

The counterpart of the JAX package's utils/native.py, with the same
functions and signatures, built from the port's own copy of the source.
The library is built by g++ at first use into csrc/build/libfhj_host.so,
or, where the package directory is read-only, into ~/.cache/fhj_native
(FHJ_CACHE_DIR) as libfhj_host_torch.so, a name of its own so that it never
overwrites the JAX package's library there.  A failed build raises with
g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host_runtime.cpp")

_lock = threading.Lock()
_lib = None


def _so_path() -> str:
    d = os.path.join(_PKG, "csrc", "build")
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(d, ".w")
        with open(probe, "w"):
            pass
        os.remove(probe)
        return os.path.join(d, "libfhj_host.so")
    except OSError:                   # a read-only install
        d = os.path.expanduser(os.environ.get("FHJ_CACHE_DIR",
                                              "~/.cache/fhj_native"))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "libfhj_host_torch.so")


def _build(so: str) -> None:
    """Compile the source into `so`: into a temporary file beside it,
    renamed over it, so that a process loading the library while another
    builds it never reads a half-written file."""
    if not os.path.exists(_SRC):
        raise FileNotFoundError(
            f"C++ host-runtime source missing: {_SRC} (pyproject "
            "package-data ships flash_hash_join_tpu_torch/csrc/*.cpp)")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               _SRC, "-o", tmp]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"g++ failed ({out.returncode}): "
                               f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first when missing or older than its
    source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(so)):
            _build(so)
        lib = ctypes.CDLL(so)
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.fhj_oracle_join_count.restype = ctypes.c_int64
        lib.fhj_oracle_join_count.argtypes = [
            u64p, ctypes.c_int64, u64p, ctypes.c_int64, ctypes.c_int32]
        lib.fhj_oracle_join_materialize.restype = ctypes.c_int64
        lib.fhj_oracle_join_materialize.argtypes = [
            u64p, u64p, ctypes.c_int64, u64p, ctypes.c_int64, u64p, u64p]
        lib.fhj_load_csv_u64.restype = ctypes.c_int64
        lib.fhj_load_csv_u64.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, u64p, ctypes.c_int64,
            ctypes.c_int32]
        lib.fhj_version.restype = ctypes.c_int32
        lib.fhj_version.argtypes = []
        _lib = lib
        return _lib


def host_join_count(build_keys: np.ndarray, probe_keys: np.ndarray,
                    nthreads: int = 0) -> int:
    """Probe rows whose key is in the build side (nthreads 0: one a core)."""
    lib = get_lib()
    bk = np.ascontiguousarray(build_keys, np.uint64)
    pk = np.ascontiguousarray(probe_keys, np.uint64)
    return int(lib.fhj_oracle_join_count(bk, len(bk), pk, len(pk), nthreads))


def host_join_materialize(build_keys, build_values, probe_keys):
    """The matched (probe_key, build_value) rows in probe order, the first
    build row of a key winning."""
    lib = get_lib()
    bk = np.ascontiguousarray(build_keys, np.uint64)
    bv = np.ascontiguousarray(build_values, np.uint64)
    pk = np.ascontiguousarray(probe_keys, np.uint64)
    if bk.shape != bv.shape:
        raise ValueError("build_keys and build_values must have equal length")
    ok = np.empty(len(pk), np.uint64)
    ov = np.empty(len(pk), np.uint64)
    n = int(lib.fhj_oracle_join_materialize(bk, bv, len(bk), pk, len(pk),
                                            ok, ov))
    return ok[:n], ov[:n]


def load_csv_u64(path: str, column: int, max_rows: int = 1 << 28,
                 nthreads: int = 0) -> np.ndarray:
    """Parse one numeric uint64 column (0-indexed) from a headered CSV."""
    lib = get_lib()
    out = np.empty(max_rows, np.uint64)
    n = int(lib.fhj_load_csv_u64(os.fsencode(path), column, out, max_rows,
                                 nthreads))
    if n == -1:
        raise FileNotFoundError(path)
    if n == -2:
        raise ValueError(f"non-numeric or missing column {column} in {path}")
    if n == -3:
        raise ValueError(f"{path} exceeds max_rows={max_rows}")
    return out[:n].copy()
