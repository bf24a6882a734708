"""The join's least bytes at the card's HBM peak, over the device time a
join takes, in %.  Least bytes: each input byte read once and each output
byte written once, by the traffic file's byte model; the device time: the
summed durations of the device ops a join.  It does not depend on which
kernels do the work."""

from hjbench.peaks import HBM_BYTES_PER_S


def read(t):
    seconds = t.op_seconds()
    if not seconds or not t.joins:
        return None
    return 100.0 * (t.bytes_per_join / HBM_BYTES_PER_S) / (seconds / t.joins)
