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
def fallback(frm: str, to: str, reason: str, amount: float = 1.0) -> None:
    """Record one degradation-ladder transition (``repro_fallbacks_total``):
    compact -> row, sidecar -> rebuild, manifest -> rescan. ``from`` is a
    Python keyword, hence the dict unpacking. Gated like every module
    helper — free when obs is off."""
    if not STATE.enabled:
        return
    REGISTRY.counter(
        "repro_fallbacks_total",
        "degradation-ladder transitions, labelled {from, to, reason}",
        **{"from": frm, "to": to, "reason": reason}).inc(amount)
