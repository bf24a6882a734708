"""The share of the traced window in which no device operation ran, in %,
the mean over the cell's cards of each card's 1 - (union of its device
ops' intervals / the window).  On one card: 1 - busy / window."""


def read(t):
    if not t.ops:
        return None
    return sum(100.0 * (1.0 - b / t.window_s)
               for b in t.card_busy_s()) / t.cards
