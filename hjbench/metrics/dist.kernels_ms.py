"""The distributed tier's kernels and memsets a call, in ms, summed over
the cell's cards and divided by them: the ranks' hot-key sample and masks
(parallel/hotkeys.py), the exchange's destinations and packing
(parallel/shuffle.py), the `global` tier's table builds and walks a rank,
every device op but a copy."""

PATTERNS = (r"^(?!Memcpy)",)


def read(t):
    return t.card_ms_per_join(PATTERNS)
