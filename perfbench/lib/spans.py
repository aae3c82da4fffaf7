"""The program's own spans and marks in a traced window: the device's idle
time under the serving engine's spans, and the train step's parts between
the marks its step function launches.

The program opens its spans through ``repro_torch.obs.span``, which, while
the profiler runs, annotates the trace as the harness's spans do:
``engine.*`` in the serving engine (``engine.submit`` over ``engine.stage``,
``engine.prefill``, ``engine.splice_cache`` and ``engine.first_token``;
``engine.decode_tick`` over ``engine.stage``, ``engine.decode``,
``engine.read_tokens`` and ``engine.controller``), ``trainer.*`` and
``data.*`` in the trainer. No program span is named as a harness span.
Its train step launches four empty kernels, one a mark, named
``repro::mark_forward``, ``repro::mark_backward``, ``repro::mark_update`` and
``repro::mark_done``, which its graph's capture records, so every replay
carries them. Idle is the window less the union of the device operations;
times are the trace's µs. A phase's graph is timed from its first kernel:
before it lie the copy of the graph's inputs and, under the profiler, the
graph's launch, which the profiler itself holds for milliseconds. A
function returns None where what it reads is missing, as in a run of a
program without such spans or marks.
"""
from __future__ import annotations

import bisect
import re

from perfbench.lib.trace import union

#: the train step's marks, in the order a step launches them
MARKS = ("forward", "backward", "update", "done")
MARK = re.compile(r"repro::mark_(forward|backward|update|done)\b")
#: the engine's spans that time a phase on the card (a graph's replay and
#: its synchronisation); every other ``engine.*`` span is host work
PHASES = ("engine.prefill", "engine.decode")
#: the trace's names of its copies and sets, which are not a graph's kernels
COPIES = ("Memcpy", "Memset")


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def overlap(a: list, b: list) -> float:
    """The length of the intersection of two :func:`merged` lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def minus(a: list, b: list) -> list[tuple[float, float]]:
    """``a`` less ``b``, both :func:`merged` lists, as one."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append((lo, b[k][0]))
            lo = max(lo, b[k][1])
            k += 1
        if hi > lo:
            out.append((lo, hi))
    return out


def idle(trace) -> list[tuple[float, float]]:
    """The window less the union of the device operations."""
    return minus([trace.window], merged((s, t) for _, s, t in trace.ops))


def spans(trace, *names: str) -> list[tuple[float, float]]:
    """The intervals of the spans named ``names``."""
    return [(s, t) for n, s, t in trace.spans if n in names]


def engine_spans(trace) -> list[tuple[float, float]]:
    return [(s, t) for n, s, t in trace.spans if n.startswith("engine.")]


def graph_gaps(trace, name: str) -> list[float] | None:
    """The idle µs under each span ``name`` that holds a kernel, from its
    first kernel to its end: the graph's own gaps and the wake-up from its
    synchronisation."""
    if trace is None:
        return None
    starts = sorted(s for n, s, _ in trace.ops if not n.startswith(COPIES))
    gaps = []
    for lo, hi in spans(trace, name):
        i = bisect.bisect_left(starts, lo)
        if i < len(starts) and starts[i] < hi:
            gaps.append(hi - starts[i] - busy(trace, starts[i], hi))
    return gaps


def host_idle(trace) -> float | None:
    """The idle µs under the engine's spans outside its phases, a decode
    tick."""
    if trace is None:
        return None
    ticks = len(spans(trace, "engine.decode_tick"))
    if not ticks:
        return None
    host = minus(merged(engine_spans(trace)), merged(spans(trace, *PHASES)))
    return overlap(idle(trace), host) / ticks


def steps(trace, n: int) -> list[dict[str, float]] | None:
    """Each traced step's marks, {mark: its start}, when the trace holds
    ``n`` steps of the four marks each, in order; else None."""
    if trace is None:
        return None
    found = sorted((s, m.group(1)) for name, s, _ in trace.ops
                   for m in [MARK.search(name)] if m)
    if n <= 0 or [k for _, k in found] != list(MARKS) * n:
        return None
    return [{k: s for s, k in found[i:i + len(MARKS)]}
            for i in range(0, len(found), len(MARKS))]


def busy(trace, lo: float, hi: float) -> float:
    """The union of the device operations clipped to [lo, hi), in µs."""
    return union((max(s, lo), min(t, hi)) for _, s, t in trace.ops if s < hi and t > lo)


def part_ms(ctx, first: str, last: str) -> float | None:
    """The device's busy time a traced step between the marks ``first`` and
    ``last``, in ms."""
    marked = steps(ctx["trace"], ctx["traced_steps"])
    if marked is None:
        return None
    tr = ctx["trace"]
    return sum(busy(tr, m[first], m[last]) for m in marked) / len(marked) / 1e3
