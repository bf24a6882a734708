"""The share of the traced window in which no device operation ran, in %:
1 - (union of the device ops' intervals / the window)."""


def read(t):
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.ops else None
