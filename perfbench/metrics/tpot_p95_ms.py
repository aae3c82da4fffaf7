"""95th percentile, over every request completed in the window, of (last
token - first token) / (tokens - 1) on the host clock."""
from perfbench.lib.stats import percentile


def read(ctx):
    start, end = ctx["window"]
    return percentile([(s.last - s.first) * 1e3 / (len(s.tokens) - 1)
                       for s in ctx["sent"] if start <= s.last <= end], 95)
