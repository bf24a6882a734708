"""The program's host time a join, in ms: the fhj.join spans' durations
(flash_hash_join_tpu_torch/engine.py: each call of a join function, from
its first Python line to its return, every launch of the join in it)."""

from hjbench.spans import dispatch_host_ms


def read(t):
    return dispatch_host_ms(t)
