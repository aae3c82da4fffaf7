"""Tokens of every train step of the window whose loss reached the host
before the window's end, divided by the time from the window's start to
the last of those losses (a step still running at the end is neither work
nor time of the rate)."""
from perfbench.lib.stats import window_steps


def read(ctx):
    n, seconds = window_steps(ctx)
    return n * ctx["tokens_per_step"] / seconds if n else None
