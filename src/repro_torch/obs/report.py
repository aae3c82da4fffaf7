"""Human/JSON reports over the recorded spans + metrics.

:func:`stage_breakdown` is a JSON-able per-stage timing table (span name ->
count, total seconds); :func:`stage_report` is the stage tree with a
one-line metrics inventory, for a terminal.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.spans import (SpanRecord, format_span_tree, spans,
                             stage_totals)


def stage_breakdown(records: Sequence[SpanRecord] | None = None) -> dict:
    """JSON-able per-stage summary: span name -> count/total seconds,
    sorted by total time descending."""
    totals = stage_totals(spans() if records is None else records)
    stages = {
        name: {"count": int(agg["count"]),
               "total_s": round(agg["total_s"], 6)}
        for name, agg in sorted(totals.items(),
                                key=lambda kv: -kv[1]["total_s"])
    }
    return {"stages": stages, "n_spans": len(records if records is not None
                                             else spans())}


def stage_report(records: Sequence[SpanRecord] | None = None,
                 registry: MetricsRegistry | None = None,
                 min_dur_s: float = 0.0) -> str:
    """Stage tree plus a one-line metrics inventory."""
    registry = REGISTRY if registry is None else registry
    tree = format_span_tree(spans() if records is None else records,
                            min_dur_s=min_dur_s)
    names = registry.names()
    footer = f"[obs] {len(names)} metric families recorded"
    return (tree + "\n" + footer) if tree else footer
