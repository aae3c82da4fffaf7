"""Self-observability for the repro pipeline: metrics + spans + exporters.

The paper's argument is that fleets burn energy in states nobody measures;
this package makes sure *our own* engine is not a black box.  Default-off,
near-free when disabled, and guaranteed not to change any result
(bit-identical frontiers with obs on or off).

Quick start::

    import repro_torch.obs as obs

    obs.enable()
    with obs.span("sweep"):
        frontier = run_sweep(store)
    print(obs.stage_report())                  # human stage tree
    obs.write_textfile("reports/metrics.prom")  # Prometheus exposition

Layout: :mod:`~repro_torch.obs.metrics` (registry: counters / gauges /
log-bucket histograms), :mod:`~repro_torch.obs.spans` (hierarchical
traces + process-pool transport), :mod:`~repro_torch.obs.prom` (text
exposition, linter, stdlib HTTP endpoint), :mod:`~repro_torch.obs.report`
(stage-tree reports).
"""
from repro_torch.obs.metrics import (DEGRADATION_FAMILIES, IR_APPEND_FAMILIES,
                                     LIVE_FAMILIES, REGISTRY, Counter, Gauge,
                                     Histogram, MetricsRegistry, counter,
                                     default_buckets, disable, enable, enabled,
                                     fallback, gauge, init_degradation_metrics,
                                     init_ir_append_metrics, init_live_metrics,
                                     observe)
from repro_torch.obs.prom import (lint_exposition, render_prometheus,
                                  start_http_server, write_textfile)
from repro_torch.obs.report import stage_breakdown, stage_report
from repro_torch.obs.spans import (SpanNode, SpanRecord, absorb,
                                   call_with_obs, clear_spans,
                                   dump_spans_jsonl, format_span_tree,
                                   load_spans_jsonl, span, span_tree, spans,
                                   stage_totals, worker_token)


def reset() -> None:
    """Clear all recorded metrics and spans (does not change enabled)."""
    REGISTRY.reset()
    clear_spans()


__all__ = [
    "DEGRADATION_FAMILIES", "IR_APPEND_FAMILIES", "LIVE_FAMILIES",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SpanNode", "SpanRecord", "absorb", "call_with_obs", "clear_spans",
    "counter", "default_buckets", "disable", "dump_spans_jsonl", "enable",
    "enabled", "fallback", "format_span_tree", "gauge",
    "init_degradation_metrics", "init_ir_append_metrics",
    "init_live_metrics", "lint_exposition", "load_spans_jsonl", "observe",
    "render_prometheus", "reset", "span", "span_tree", "spans",
    "stage_breakdown", "stage_report", "stage_totals", "start_http_server",
    "worker_token", "write_textfile",
]
