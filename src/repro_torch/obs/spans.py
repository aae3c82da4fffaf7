"""Hierarchical wall-clock spans: the trace half of the observability layer.

``span(name)`` is a context manager that records a :class:`SpanRecord`
(start time, duration, parent link) into a process-local buffer.  Nesting is
tracked per-thread with an explicit stack; span ids are ``"{pid:x}-{seq}"``
so traces from process-pool workers re-parent cleanly into the parent
process's trace (see :func:`call_with_obs` / :func:`absorb`, which
``map_shard_partitions`` and ``replay_ir`` use to carry worker spans and
metrics home).

While ``torch.profiler`` is running, a span also opens
``torch.profiler.record_function(name)``, so it lands in the exported Chrome
trace as a ``user_annotation`` event on the device kernels' clock, nested
under whatever span or annotation is open. A :class:`SpanRecord`'s
``t_start`` is already on that clock up to the trace's base:
:func:`trace_us` places it there. The serving engine, the trainer and the
data pipeline open their spans under the prefixes ``engine.``, ``trainer.``
and ``data.``.

When observability is disabled and no profiler runs, ``span()`` returns a
shared no-op context manager after one check of each (well under a
microsecond, no allocation, no ``record_function``) — cheap enough to leave
in every stage of the pipeline and in the serving tick permanently. Nothing imports torch
here: while torch is not loaded no profiler can be running, and the
what-if pool's workers import no torch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys
import threading
import time
from typing import Callable, Sequence

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.metrics import REGISTRY, STATE


@dataclasses.dataclass
class SpanRecord:
    """One finished span. ``t_start`` is wall-clock (``time.time``) so spans
    from different processes order sensibly; ``dur_s`` is measured with
    ``time.perf_counter`` for resolution."""

    span_id: str
    parent_id: str | None
    name: str
    t_start: float
    dur_s: float
    pid: int
    attrs: dict


_SPANS: list[SpanRecord] = []
_TLS = threading.local()
_SEQ_LOCK = threading.Lock()
_SEQ = 0
# Parent span id inherited from another process (set in pool workers so the
# worker's root span hangs off the submitting span in the parent trace).
_ROOT_PARENT: str | None = None


def _next_id() -> str:
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        return f"{os.getpid():x}-{_SEQ}"


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class _NoopSpan:
    """Shared do-nothing span returned when observability is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``) is
    recording in this process."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "attrs", "record", "span_id", "parent_id", "_t0", "_t_wall",
                 "_annotation")

    def __init__(self, name: str, attrs: dict, record: bool, annotate: bool) -> None:
        self.name = name
        self.attrs = attrs
        self.record = record
        self._annotation = (sys.modules["torch"].profiler.record_function(name)
                            if annotate else None)

    def set(self, **attrs) -> None:
        """Attach attributes discovered while the span is open."""
        self.attrs.update(attrs)

    def __enter__(self):
        # the annotation opens first and closes last, so the record's
        # interval lies inside the trace event's
        if self._annotation is not None:
            self._annotation.__enter__()
        if self.record:
            stack = _stack()
            self.parent_id = stack[-1] if stack else _ROOT_PARENT
            self.span_id = _next_id()
            stack.append(self.span_id)
            self._t_wall = time.time()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.record:
            dur = time.perf_counter() - self._t0
            stack = _stack()
            if stack and stack[-1] == self.span_id:
                stack.pop()
            _SPANS.append(SpanRecord(self.span_id, self.parent_id, self.name,
                                     self._t_wall, dur, os.getpid(), self.attrs))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """Open a span: recorded when obs is enabled, annotated into the
    profiler's trace while a profiler runs, else the shared no-op."""
    annotate = profiling()
    if not (STATE.enabled or annotate):
        return _NOOP
    return _Span(name, attrs, STATE.enabled, annotate)


def trace_us(record: SpanRecord, base_time_ns: int) -> float:
    """``record``'s start on an exported Chrome trace's clock: µs after the
    trace's ``baseTimeNanoseconds``, as its events' ``ts``."""
    return record.t_start * 1e6 - base_time_ns / 1e3


def spans() -> list[SpanRecord]:
    """Snapshot of all spans recorded (and absorbed) so far."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


# ------------------------------------------------------------------ export
def dump_spans_jsonl(path: str | pathlib.Path) -> pathlib.Path:
    """Write one JSON object per span — loadable with
    :func:`load_spans_jsonl` and re-assemblable with :func:`span_tree`."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for s in _SPANS:
            fh.write(json.dumps(dataclasses.asdict(s)) + "\n")
    return path


def load_spans_jsonl(path: str | pathlib.Path) -> list[SpanRecord]:
    out = []
    for line in pathlib.Path(path).read_text().splitlines():
        if line.strip():
            out.append(SpanRecord(**json.loads(line)))
    return out


@dataclasses.dataclass
class SpanNode:
    span: SpanRecord
    children: list["SpanNode"]


def span_tree(records: Sequence[SpanRecord] | None = None) -> list[SpanNode]:
    """Reassemble the hierarchy: roots (no resolvable parent) in start
    order, children under their parents in start order."""
    records = _SPANS if records is None else records
    nodes = {r.span_id: SpanNode(r, []) for r in records}
    roots: list[SpanNode] = []
    for r in sorted(records, key=lambda r: (r.t_start, r.span_id)):
        node = nodes[r.span_id]
        parent = nodes.get(r.parent_id) if r.parent_id else None
        (parent.children if parent is not None else roots).append(node)
    return roots


def stage_totals(records: Sequence[SpanRecord] | None = None
                 ) -> dict[str, dict[str, float]]:
    """Aggregate spans by name: ``{name: {"count", "total_s"}}`` — the
    per-stage breakdown attached to bench JSON."""
    records = _SPANS if records is None else records
    out: dict[str, dict[str, float]] = {}
    for r in records:
        agg = out.setdefault(r.name, {"count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += r.dur_s
    return out


def format_span_tree(records: Sequence[SpanRecord] | None = None,
                     min_dur_s: float = 0.0) -> str:
    """Human-readable stage tree, e.g.::

        whatif.evaluate backend=torch configs=200   3.10s
          ir.build                                  1.92s
          backend.pack streams=318                  0.41s
    """
    lines: list[str] = []

    def walk(node: SpanNode, depth: int) -> None:
        r = node.span
        if r.dur_s >= min_dur_s:
            attrs = " ".join(f"{k}={v}" for k, v in sorted(r.attrs.items()))
            label = "  " * depth + r.name + (f" {attrs}" if attrs else "")
            lines.append(f"{label:<56s} {r.dur_s:9.3f}s")
        for child in node.children:
            walk(child, depth + 1)

    for root in span_tree(records):
        walk(root, 0)
    return "\n".join(lines)


# --------------------------------------------- process-pool span transport
def worker_token(name: str = "worker") -> dict | None:
    """Context to ship to a pool worker so its spans/metrics rejoin this
    process's trace.  ``None`` (obs disabled) makes :func:`call_with_obs`
    a plain passthrough."""
    if not STATE.enabled:
        return None
    stack = _stack()
    return {"name": name, "parent_id": stack[-1] if stack else None}


def call_with_obs(token: dict | None, fn: Callable, *args):
    """Run ``fn(*args)`` in a (fresh) worker process, recording under
    ``token``'s parent span; returns ``(result, payload)`` where payload
    carries the worker's spans and metrics (``None`` when obs is off).

    Must stay module-level so pool submissions pickle.
    """
    if token is None:
        return fn(*args), None
    global _ROOT_PARENT
    # spawn/forkserver children start with obs off and empty buffers; enable
    # for the duration of the call and ship everything back explicitly.
    prev_enabled, prev_root = STATE.enabled, _ROOT_PARENT
    _metrics.enable()
    _ROOT_PARENT = token.get("parent_id")
    try:
        with span(token.get("name", "worker")):
            result = fn(*args)
        payload = {"spans": list(_SPANS), "metrics": REGISTRY.dump()}
    finally:
        _ROOT_PARENT = prev_root
        STATE.enabled = prev_enabled
    if not prev_enabled:
        # fresh worker: drop buffers we just shipped (workers are reused
        # across submissions within one pool)
        clear_spans()
        REGISTRY.reset()
    return result, payload


def absorb(payload: dict | None) -> None:
    """Parent side: fold a worker payload into this process's trace and
    registry. Worker span ids are pid-prefixed, so no collisions."""
    if payload is None:
        return
    _SPANS.extend(payload["spans"])
    REGISTRY.merge(payload["metrics"])
