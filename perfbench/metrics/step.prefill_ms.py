"""The prefill's time, the mean of ``phase_ms["prefill"]`` over the
window."""
from perfbench.lib.stats import mean


def read(ctx):
    end = ctx["window"][1]
    return mean(ms for t in ctx["ticks"] if t["end"] <= end for ms in t["prefill_ms"])
