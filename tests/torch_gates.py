"""The port's adaptive gates (flash_hash_join_tpu_torch/ops/direct_bitmap.py)
opened for a test: every eligible dense build then goes direct, as it did
before the gates were measured.  The gates read their constants at call
time, so patching the module is enough."""

from flash_hash_join_tpu_torch.ops import direct_bitmap as tdb

PROBE_FLOORS = ("ADAPTIVE_MIN_PROBE_ROWS", "LARGE_MIN_PROBE_ROWS",
                "MAT_MIN_PROBE_ROWS", "MAT_STAGED_MIN_PROBE_ROWS",
                "MAT_WIDE_MIN_PROBE_ROWS")


def open_gates(monkeypatch) -> None:
    for name in PROBE_FLOORS:
        monkeypatch.setattr(tdb, name, 0)
    monkeypatch.setattr(tdb, "ADAPTIVE_SCAN_DOMAIN_BITS", tdb.MAX_DOMAIN_BITS)
