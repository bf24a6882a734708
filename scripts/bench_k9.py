#!/usr/bin/env python3
"""K9 (materialize_copy) of this checkout beside another checkout's K9 and
torch's clone, on one NVIDIA card.

    python3 scripts/bench_k9.py --against DIR

DIR is the root of another checkout (for example the parent commit, unpacked
with `git archive`).  Each checkout's csrc/dense_values.cu is built alone
with the package's nvcc flags into build/bench_k9/, and its
fhj_materialize_copy is called through ctypes ("against", "this"); this
checkout's wrapper ops/cuda/dense_values.materialize_copy ("wrapper", the
path's call, with its Python host work) and torch's clone ("clone") are
timed beside them.  At 1e8 and 4e7 int32 words, every copy first checked
equal to its source, then in turns clone, against, this, wrapper, wrapper,
this, against, clone, twice; each turn read by both of chip_smoke.py's
timers, cuda_ms (a lone call between two CUDA events) and cuda_ms_b2b (runs
of calls back to back).  Prints one JSON line a size, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(tree: Path, label: str) -> ctypes.CDLL:
    """tree's csrc/dense_values.cu as a shared library of its own."""
    from flash_hash_join_tpu_torch.ops.cuda import _build
    out = ROOT / "build" / "bench_k9"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{label}.so"
    src = tree / "flash_hash_join_tpu_torch" / "csrc" / "dense_values.cu"
    subprocess.run([_build._nvcc(), *_build.COMPILE_FLAGS, "-shared", "-o",
                    str(lib), str(src)], capture_output=True, text=True,
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.fhj_materialize_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int64, ctypes.c_void_p]
    cdll.fhj_materialize_copy.restype = ctypes.c_int
    return cdll


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, required=True,
                        help="root of the checkout to compare with")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_k9.py: needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import HBM_BYTES_PER_S, cuda_ms, cuda_ms_b2b
    from flash_hash_join_tpu_torch.ops.cuda import dense_values as dv
    libs = {"against": build(args.against.resolve(), "against"),
            "this": build(ROOT, "this")}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)

    for n in (100_000_000, 40_000_000):
        src = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                            device="cuda", generator=gen)
        dst = torch.empty_like(src)

        def raw(lib):
            def go():
                err = lib.fhj_materialize_copy(src.data_ptr(), dst.data_ptr(),
                                               n, stream)
                if err:
                    raise RuntimeError(f"fhj_materialize_copy: error {err}")
            return go

        runs = {"clone": src.clone, "against": raw(libs["against"]),
                "this": raw(libs["this"]),
                "wrapper": lambda: dv.materialize_copy(src)}
        for name in ("against", "this"):
            dst.zero_()
            runs[name]()
            if not torch.equal(dst, src):
                raise RuntimeError(f"{name}'s K9 differs at n={n}")
        if not torch.equal(runs["wrapper"](), src):
            raise RuntimeError(f"the wrapper's copy differs at n={n}")
        lone = {k: [] for k in runs}
        b2b = {k: [] for k in runs}
        for _ in range(2):
            for name in ("clone", "against", "this", "wrapper", "wrapper",
                         "this", "against", "clone"):
                lone[name].append(cuda_ms(runs[name]))
                b2b[name].append(cuda_ms_b2b(runs[name]))
        print(json.dumps({"words": n,
                          "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
                          "lone_ms": lone, "b2b_ms": b2b}), flush=True)
        del src, dst, runs
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
