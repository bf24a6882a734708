"""The bloom prune kernel's share of its roofline, in %: its least bytes at
the card's HBM peak, over the summed device time a join of the ops named
prune_kernel (csrc/hash_walk.cu; its memsets are not counted).

Least bytes (least_bytes): each probe row's two key words, 8 bytes, read
once, at bloom-c3's probe_rows a join.  Left out: the bloom words, read at
random but from L2 (33.6 MB at 2^22 groups), and the survivors' writes,
8 bytes each for the ~6 % of the rows that pass at a 5 % match.

The bytes are bloom-c3's: the reader reads the cell bloom-c3.count-bloom
alone, and raises where the trace's bytes a join are not that cell's, so
that a cell of another size cannot report its time against them."""

from hjbench import catalog
from hjbench.peaks import HBM_BYTES_PER_S

CONFIG, TRAFFIC = "bloom-c3", "count-bloom"
PATTERNS = (r"prune_kernel",)


def least_bytes(cfg: dict) -> float:
    """The bytes a prune of the whole probe side has to read."""
    return 8.0 * cfg["probe_rows"]


def cell_bytes_per_join(cfg: dict, traffic: dict) -> float:
    """The bytes a join of bloom-c3.count-bloom by its traffic's byte model
    (a count: no match bytes), as the harness gives them to the trace."""
    b = traffic["bytes"]
    return cfg["build_rows"] * b["build_row"] + cfg["probe_rows"] * b[
        "probe_row"]


def read(t):
    ms = t.ms_per_join(PATTERNS)
    if ms is None:
        return None
    cfg = catalog.config(catalog.manifest(), CONFIG)
    want = cell_bytes_per_join(cfg, catalog.traffic(TRAFFIC))
    if t.bytes_per_join != want:
        raise ValueError(
            f"global.prune.roofline reads {CONFIG}.{TRAFFIC} alone: this "
            f"trace's {t.bytes_per_join} bytes a join are not its {want}")
    return 100.0 * (least_bytes(cfg) / HBM_BYTES_PER_S) / (ms / 1e3)
