"""The harness's drivers: how a cell's window calls the program.

A traffic file names its driver (`"driver"`, default `resident`); the
driver is drivers/<name>.py, whose `Driver(bk, bv, pk, traffic, dev=,
cards=, seed=, mark=)` does the set-up that follows the columns (its
warm-up included) and whose `window(seconds, span)` runs the measured
closed loop and returns (counts, attempted, failed, wall seconds); then
`kept` (rows for the check), `facts()` (the result line's facts, `route`
among them) and `release()`.  A later benchmark adds a driver as a file
of its own.
"""
