"""The decode step's time, the mean of ``phase_ms["decode"]`` (CUDA events
around the decode graph's replay, ended by a synchronisation) over the
window."""
from perfbench.lib.stats import mean


def read(ctx):
    end = ctx["window"][1]
    return mean(ms for t in ctx["ticks"] if t["end"] <= end for ms in t["decode_ms"])
