"""Published peaks of the card, copied from chip_smoke.py (HBM_BYTES_PER_S)
so that the yardstick stays put when the program's scripts change.

NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full
power limit of 700 W; a run writes the card's power limit beside it.
"""

HBM_BYTES_PER_S = 3.35e12
