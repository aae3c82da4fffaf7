"""The trainer's host time a step: the wall time of the loop body less the
time from the step's call to ``float(loss)`` returning; the mean over the
window's steps."""
from perfbench.lib.stats import mean


def read(ctx):
    start, end = ctx["window"]
    s = ctx["steps"]
    return mean((s.end[i] - s.start[i] - s.step_s[i]) * 1e3
                for i in range(ctx["first"], len(s.loss)) if s.end[i] <= end)
