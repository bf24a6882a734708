"""Device operations (kernels, memsets, copies) a join: what the engine's
dispatch and the wrappers enqueue, torch's own sorts and memsets among
them (api.launch_counts() sees only the port's wrappers)."""


def read(t):
    return len(t.ops) / t.joins if t.ops and t.joins else None
