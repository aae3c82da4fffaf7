"""Process-wide metrics registry: counters, gauges, log-bucket histograms.

The registry is the numeric half of the self-observability layer (spans are
the other half, :mod:`repro_torch.obs.spans`).  Contract:

* **Default-off.**  The module-level helpers (:func:`counter`,
  :func:`gauge`, :func:`observe`) are gated on :func:`enabled` and return
  immediately when observability is off — one attribute load and a branch,
  so instrumented hot paths stay near-free in production.
* **Bit-identical results.**  Instrumentation only *records*; it never
  feeds back into any computation, so every pipeline output is identical
  with obs on or off.

Histogram bucket edges are a fixed log-scale ladder (:func:`default_buckets`)
so histograms from different runs compare bucket-wise.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Iterator

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def default_buckets() -> tuple[float, ...]:
    """Fixed log-scale histogram edges: 31 upper bounds at ratio 10^(1/3)
    (~2.15x per step) spanning 1e-6 .. 1e4 — wide enough for microsecond
    kernel spans and multi-hour analyze stages alike.  A pure function of
    constants, so the edges are bit-stable across runs and processes
    (worker histograms merge bucket-wise; see ``MetricsRegistry.merge``).
    """
    return tuple(10.0 ** (k / 3.0) for k in range(-18, 13))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class Gauge:
    """Last-write-wins point-in-time value."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Fixed-bucket histogram; per-bucket counts are *non*-cumulative in
    memory and cumulated only at exposition time (Prometheus ``le`` form)."""

    kind = "histogram"
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: tuple[float, ...] | None = None) -> None:
        self.edges = tuple(edges) if edges is not None else default_buckets()
        if list(self.edges) != sorted(self.edges):
            raise ValueError("histogram bucket edges must be sorted")
        # one slot per edge plus the +Inf overflow slot
        self.counts = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.edges, value)] += 1
        self.sum += value
        self.count += 1


class _Family:
    """All label-variants of one metric name."""

    __slots__ = ("name", "kind", "help", "metrics")

    def __init__(self, name: str, kind: str, help: str) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        # label tuple (sorted (k, v) pairs) -> metric instance
        self.metrics: dict[tuple[tuple[str, str], ...],
                           Counter | Gauge | Histogram] = {}


class MetricsRegistry:
    """Mapping of metric families, safe for concurrent readers (the HTTP
    exporter thread) against a single writer (the pipeline)."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------------- access
    def _get(self, name: str, kind: str, help: str,
             labels: dict[str, object], factory):
        fam = self._families.get(name)
        if fam is None:
            if not _NAME_RE.match(name):
                raise ValueError(f"invalid metric name: {name!r}")
            with self._lock:
                fam = self._families.setdefault(name, _Family(name, kind, help))
        if fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, not {kind}")
        if help and not fam.help:
            fam.help = help
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        metric = fam.metrics.get(key)
        if metric is None:
            with self._lock:
                metric = fam.metrics.setdefault(key, factory())
        return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets))

    def family(self, name: str) -> _Family | None:
        return self._families.get(name)

    def collect(self) -> Iterator[_Family]:
        """Families in name order (snapshot of the family list)."""
        for name in sorted(self._families):
            yield self._families[name]

    def names(self) -> list[str]:
        return sorted(self._families)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # --------------------------------------------- worker-process transport
    def dump(self) -> list[dict]:
        """Picklable snapshot for shipping worker-side metrics back to the
        parent process (see :func:`repro_torch.obs.spans.call_with_obs`)."""
        out = []
        for fam in self.collect():
            for key, metric in sorted(fam.metrics.items()):
                entry = {"name": fam.name, "kind": fam.kind, "help": fam.help,
                         "labels": dict(key)}
                if fam.kind == "histogram":
                    entry["edges"] = metric.edges
                    entry["counts"] = list(metric.counts)
                    entry["sum"] = metric.sum
                    entry["count"] = metric.count
                else:
                    entry["value"] = metric.value
                out.append(entry)
        return out

    def merge(self, entries: list[dict]) -> None:
        """Fold a :meth:`dump` from another process into this registry:
        counters and histograms add, gauges last-write-win."""
        for e in entries:
            labels = e.get("labels", {})
            if e["kind"] == "counter":
                self.counter(e["name"], e.get("help", ""), **labels).inc(
                    e["value"])
            elif e["kind"] == "gauge":
                self.gauge(e["name"], e.get("help", ""), **labels).set(
                    e["value"])
            else:
                h = self.histogram(e["name"], e.get("help", ""),
                                   buckets=tuple(e["edges"]), **labels)
                if tuple(h.edges) != tuple(e["edges"]):
                    raise ValueError(
                        f"histogram {e['name']!r}: bucket edges differ "
                        "between processes")
                for i, c in enumerate(e["counts"]):
                    h.counts[i] += c
                h.sum += e["sum"]
                h.count += e["count"]


#: The process-wide default registry. Everything in ``repro_torch`` records here.
REGISTRY = MetricsRegistry()


class _ObsState:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = False


STATE = _ObsState()


def enable() -> None:
    """Turn recording on (module helpers + spans)."""
    STATE.enabled = True


def disable() -> None:
    STATE.enabled = False


def enabled() -> bool:
    return STATE.enabled


# ------------------------------------------------------------------ helpers
# Gated one-liners for instrumentation sites: near-free when disabled.

def counter(name: str, amount: float = 1.0, help: str = "", **labels) -> None:
    if not STATE.enabled:
        return
    REGISTRY.counter(name, help, **labels).inc(amount)


def gauge(name: str, value: float, help: str = "", **labels) -> None:
    if not STATE.enabled:
        return
    REGISTRY.gauge(name, help, **labels).set(value)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    if not STATE.enabled:
        return
    REGISTRY.histogram(name, help, **labels).observe(value)


# ------------------------------------------------- degradation-ladder metrics
#: the robustness layer's metric families (name, kind, help) — preregistered
#: zero-valued by :func:`init_degradation_metrics` so expositions always
#: carry them even on fault-free runs.
DEGRADATION_FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("repro_fallbacks_total", "counter",
     "degradation-ladder transitions, labelled {from, to, reason}"),
    ("repro_shards_quarantined_total", "counter",
     "telemetry shards skipped or quarantined, by reason"),
    ("repro_shards_repaired_total", "counter",
     "telemetry shards repaired by the hygiene layer, by reason"),
    ("repro_partition_retries_total", "counter",
     "pool partition attempts that crashed/hung and were retried or degraded"),
    ("repro_coverage_fraction", "gauge",
     "rows analyzed / rows on disk for the last run, by stage"),
)


def fallback(frm: str, to: str, reason: str, amount: float = 1.0) -> None:
    """Record one degradation-ladder transition (``repro_fallbacks_total``):
    compact -> row, sidecar -> rebuild, pool -> in_process, manifest ->
    rescan, and the live tick ladder's rungs. ``from`` is a Python keyword,
    hence the dict unpacking. Gated like every module helper — free when obs is off."""
    if not STATE.enabled:
        return
    REGISTRY.counter(
        "repro_fallbacks_total", DEGRADATION_FAMILIES[0][2],
        **{"from": frm, "to": to, "reason": reason}).inc(amount)


def init_degradation_metrics() -> None:
    """Pre-register the robustness families (zero-valued, unlabelled) so a
    fault-free exposition still exposes them — dashboards and linters can
    then assert on presence instead of guessing whether a zero means 'no
    faults' or 'not instrumented'."""
    _init_families(DEGRADATION_FAMILIES)


# ------------------------------------------------- live-controller metrics
#: the live fleet controller's families (name, kind, help) — emitted by
#: :mod:`repro_torch.live`, preregistered zero-valued by
#: :func:`init_live_metrics` (the histogram zero-registers too, exposing
#: empty ``_bucket``/``_sum``/``_count`` samples).
LIVE_FAMILIES: tuple[tuple[str, str, str], ...] = (
    ("repro_live_ticks_total", "counter",
     "live controller ticks, labelled {result} (refreshed/idle/stale)"),
    ("repro_live_staleness_seconds", "histogram",
     "seconds from shard landing to the refreshed knee being published"),
    ("repro_live_checkpoint_writes_total", "counter",
     "live controller checkpoints committed (atomic rename)"),
    ("repro_live_checkpoint_restores_total", "counter",
     "live controller restarts resumed from a valid checkpoint"),
    ("repro_live_coalesced_shards_total", "counter",
     "pending shards beyond the first folded into one extend (backpressure)"),
    ("repro_live_tick_retries_total", "counter",
     "tick attempts that failed and were retried on the same ladder rung"),
    ("repro_live_deadline_misses_total", "counter",
     "tick attempts abandoned at the per-tick deadline"),
)


def init_live_metrics() -> None:
    """Pre-register the live-controller families (zero-valued) so an
    exposition from a run that never ticked still exposes them."""
    _init_families(LIVE_FAMILIES)


def _init_families(families: tuple[tuple[str, str, str], ...]) -> None:
    if not STATE.enabled:
        return
    for name, kind, help_text in families:
        if kind == "counter":
            REGISTRY.counter(name, help_text)
        elif kind == "histogram":
            REGISTRY.histogram(name, help_text)
        else:
            REGISTRY.gauge(name, help_text)
