"""Algorithm 1 on the serving path: the total length of the engine's
``engine.controller`` spans (the signals from the newest telemetry row and
the controller's step) over the number of ``engine.decode_tick`` spans, in
ms."""
from perfbench.lib import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ticks = len(spans.spans(tr, "engine.decode_tick"))
    control = spans.spans(tr, "engine.controller")
    if not ticks or not control:
        return None
    return sum(t - s for s, t in control) / ticks / 1e3
