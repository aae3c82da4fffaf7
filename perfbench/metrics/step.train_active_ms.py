"""Card-active time a replayed train step: the union of the profiler's
device intervals over the traced steps, divided by their number."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr.busy_s * 1e3 / ctx["traced_steps"]
