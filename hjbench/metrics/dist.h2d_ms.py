"""The distributed tier's host-to-device copies a call, in ms, summed over
the cell's cards and divided by them (parallel/distributed_join.
shard_columns: each rank's pageable copy of its split column pieces)."""

PATTERNS = (r"^Memcpy HtoD",)


def read(t):
    return t.card_ms_per_join(PATTERNS)
