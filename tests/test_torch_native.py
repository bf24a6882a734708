"""The port's C++ host runtime (flash_hash_join_tpu_torch/utils/native.py,
csrc/host_runtime.cpp) against the JAX package's (flash_hash_join_tpu/
utils/native.py) and numpy, on the same seeded inputs: the first-match
count, the materialized rows in probe order (the first build row of a key
winning) and the CSV column loader, its error cases included.

Tolerance: exact equality (integer counts and uint64 rows).
"""

import os

import numpy as np
import pytest

from flash_hash_join_tpu.utils import native as jax_native
from flash_hash_join_tpu_torch.utils import native

M64 = 2**64 - 1


@pytest.fixture(scope="module", autouse=True)
def libs():
    """Both libraries built (g++ at first use); skip without a toolchain."""
    try:
        native.get_lib()
        jax_native.get_lib()
    except (OSError, RuntimeError, FileNotFoundError) as e:
        pytest.skip(f"no C++ toolchain: {e}")


def _case(kind: str):
    rng = np.random.default_rng(7)
    if kind == "random":
        bk = rng.integers(0, 100_000, 50_000, dtype=np.uint64)
        pk = rng.integers(0, 100_000, 200_000, dtype=np.uint64)
    elif kind == "edges":            # keys 0 and 2^64-1 on both sides
        bk = np.array([0, 5, M64, 2**32 - 1, 2**63], np.uint64)
        pk = np.array([0, 0, M64, 7, 2**32 - 1, M64 - 1, 2**63], np.uint64)
    elif kind == "duplicates":       # every key repeated, values differ
        bk = rng.integers(0, 300, 5_000, dtype=np.uint64)
        pk = rng.integers(0, 400, 20_000, dtype=np.uint64)
    elif kind == "empty_build":
        bk = np.zeros(0, np.uint64)
        pk = rng.integers(0, 10, 100, dtype=np.uint64)
    else:                            # empty_probe
        bk = rng.integers(0, 10, 100, dtype=np.uint64)
        pk = np.zeros(0, np.uint64)
    bv = rng.integers(0, 2**64, bk.size, dtype=np.uint64)
    return bk, bv, pk


KINDS = ["random", "edges", "duplicates", "empty_build", "empty_probe"]


def _numpy_rows(bk, bv, pk):
    """Rows in probe order, the minimum build row of a key winning."""
    uniq, first = np.unique(bk, return_index=True)
    hit = np.isin(pk, uniq)
    keys = pk[hit]
    return keys, bv[first[np.searchsorted(uniq, keys)]]


@pytest.mark.parametrize("kind", KINDS)
def test_count_matches_jax_and_numpy(kind):
    bk, _, pk = _case(kind)
    want = int(np.isin(pk, np.unique(bk)).sum())
    for nthreads in (0, 1, 3):
        assert native.host_join_count(bk, pk, nthreads=nthreads) == want
    assert jax_native.host_join_count(bk, pk) == want


@pytest.mark.parametrize("kind", KINDS)
def test_materialize_matches_jax_and_numpy(kind):
    bk, bv, pk = _case(kind)
    keys, vals = native.host_join_materialize(bk, bv, pk)
    want_keys, want_vals = _numpy_rows(bk, bv, pk)
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(vals, want_vals)
    jkeys, jvals = jax_native.host_join_materialize(bk, bv, pk)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(vals, jvals)
    assert keys.dtype == vals.dtype == np.uint64


def test_materialize_first_build_row_wins():
    bk = np.array([4, 9, 4, 4, 9], np.uint64)
    bv = np.array([10, 20, 30, 40, 50], np.uint64)
    pk = np.array([9, 4, 1, 4], np.uint64)
    keys, vals = native.host_join_materialize(bk, bv, pk)
    assert keys.tolist() == [9, 4, 4] and vals.tolist() == [20, 10, 10]


def test_materialize_rejects_unequal_build_columns():
    with pytest.raises(ValueError, match="equal length"):
        native.host_join_materialize(np.arange(3, dtype=np.uint64),
                                     np.arange(2, dtype=np.uint64),
                                     np.arange(3, dtype=np.uint64))


def _write(tmp_path, text, name="t.csv"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


CSV_CASES = {
    "plain": ("id1,v2\n1,2\n3,4\n", [[1, 3], [2, 4]]),
    "no_trailing_newline": ("k,v\n1,2\n3,4", [[1, 3], [2, 4]]),
    "quoted_and_spaces": ('a,b\n"1",2\n 3 ,4\n"5" ,6\n', [[1, 3, 5],
                                                          [2, 4, 6]]),
    "crlf": ("a,b\r\n1,2\r\n3,4\r\n", [[1, 3], [2, 4]]),
    "u64_edges": (f"a,b\n0,{M64}\n{M64},0\n", [[0, M64], [M64, 0]]),
    "header_only": ("a,b\n", [[], []]),
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_csv_loader_matches_jax(tmp_path, name):
    text, want = CSV_CASES[name]
    path = _write(tmp_path, text)
    for col, expected in enumerate(want):
        got = native.load_csv_u64(path, col)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, np.array(expected, np.uint64))
        np.testing.assert_array_equal(got, jax_native.load_csv_u64(path, col))


def test_csv_loader_large_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**63, 100_000, dtype=np.uint64)
    b = rng.integers(0, 1000, 100_000, dtype=np.uint64)
    path = str(tmp_path / "big.csv")
    with open(path, "w") as f:
        f.write("id1,s,v2\n")
        f.writelines(f"{x},id{x % 7},{y}\n" for x, y in zip(a, b))
    for col, want in ((0, a), (2, b)):
        got = native.load_csv_u64(path, col, nthreads=4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jax_native.load_csv_u64(path, col))


ERROR_CASES = {
    "missing_file": (None, 0, 10, FileNotFoundError),
    "non_numeric_first": ("k,v\nx,2\n", 0, 10, ValueError),
    "non_numeric_prefix": ("a,b\nx1,2\n3,4\n", 0, 10, ValueError),
    "missing_column": ("a,b,c\n1,2,3\n4,5\n", 2, 10, ValueError),
    "past_u64": (f"a\n{2**64}\n", 0, 10, ValueError),
    "past_max_rows": ("a\n1\n2\n3\n", 0, 2, ValueError),
}


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_csv_loader_errors_match_jax(tmp_path, name):
    text, col, max_rows, exc = ERROR_CASES[name]
    path = (str(tmp_path / "missing.csv") if text is None
            else _write(tmp_path, text))
    for mod in (native, jax_native):
        with pytest.raises(exc):
            mod.load_csv_u64(path, col, max_rows)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    so = str(tmp_path / "lib.so")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native._build(so)
    assert not os.path.exists(so)
    assert os.listdir(tmp_path) == ["broken.cpp"]      # no temporary left


def test_read_only_package_builds_under_its_own_name(tmp_path, monkeypatch):
    not_a_dir = tmp_path / "pkg"
    not_a_dir.write_text("")                 # makedirs under it fails
    monkeypatch.setattr(native, "_PKG", str(not_a_dir))
    monkeypatch.setenv("FHJ_CACHE_DIR", str(tmp_path / "cache"))
    assert native._so_path() == str(tmp_path / "cache" /
                                    "libfhj_host_torch.so")


def test_library_version():
    assert native.get_lib().fhj_version() == 1
