"""Self-observability for the repro pipeline: metrics + spans.

The paper's argument is that fleets burn energy in states nobody measures;
this package makes sure *our own* engine is not a black box.  Default-off,
near-free when disabled, and guaranteed not to change any result
(bit-identical frontiers with obs on or off).

Quick start::

    import repro_torch.obs as obs

    obs.enable()
    with obs.span("sweep"):
        frontier = run_sweep(store)
    print(obs.format_span_tree())               # human stage tree
    print(obs.stage_totals(obs.spans()))        # span name -> count, seconds

Layout: :mod:`~repro_torch.obs.metrics` (registry: counters / gauges /
log-bucket histograms) and :mod:`~repro_torch.obs.spans` (hierarchical
traces).
"""
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, counter, default_buckets,
                                     disable, enable, enabled, fallback, gauge,
                                     observe)
from repro_torch.obs.spans import (SpanNode, SpanRecord, clear_spans,
                                   dump_spans_jsonl, format_span_tree,
                                   load_spans_jsonl, span, span_tree, spans,
                                   stage_totals)


def reset() -> None:
    """Clear all recorded metrics and spans (does not change enabled)."""
    REGISTRY.reset()
    clear_spans()


__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SpanNode", "SpanRecord", "clear_spans", "counter", "default_buckets",
    "disable", "dump_spans_jsonl", "enable", "enabled", "fallback",
    "format_span_tree", "gauge", "load_spans_jsonl", "observe", "reset",
    "span", "span_tree", "spans", "stage_totals",
]
