"""The serving engine's host time a tick: the wall clock around a tick's
submits and decode tick, less its prefill and decode phases' CUDA-event
times (``ServingEngine.phase_ms``); the mean over the window's ticks."""
from perfbench.lib.stats import mean


def read(ctx):
    end = ctx["window"][1]
    return mean(t["host_ms"] for t in ctx["ticks"] if t["end"] <= end)
