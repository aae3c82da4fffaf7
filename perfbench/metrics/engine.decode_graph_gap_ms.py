"""The decode graph's own gaps and the wake-up from its synchronisation:
the device's idle time under an ``engine.decode`` span from the span's
first kernel to its end, the median over the spans, in ms. The copy of the
graph's inputs and the graph's launch, before its first kernel, are left
out: under the profiler the launch holds the host for milliseconds. The
median, since the profiler now and then stalls a replay for milliseconds
at no fixed kernel."""
import statistics

from perfbench.lib import spans


def read(ctx):
    gaps = spans.graph_gaps(ctx["trace"], "engine.decode")
    return statistics.median(gaps) / 1e3 if gaps else None
