"""The `partitioned` tier's table sort a join, in ms (ops/range_table.py:
torch's stable sort of the sortable build keys, which runs CUB's radix
sort on the card)."""

PATTERNS = (r"RadixSort", r"radixSort")


def read(t):
    return t.ms_per_join(PATTERNS)
