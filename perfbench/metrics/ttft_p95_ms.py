"""95th percentile, over every request sent in the window, of the time from
its sending to its first token on the host; a request not prefilled by the
window's end counts as missing (infinite)."""
import math

from perfbench.lib.stats import percentile


def read(ctx):
    start, end = ctx["window"]
    ttft = [(s.first - s.sent) * 1e3 if s.first <= end else math.inf
            for s in ctx["sent"] if start <= s.sent < end]
    return percentile(ttft, 95)
