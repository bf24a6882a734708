"""Device idle time a join spent inside the program, in ms: the window's
idle gaps (no device op running) intersected with the fhj.join spans."""

from hjbench.spans import dispatch_idle_ms


def read(t):
    return dispatch_idle_ms(t)
