"""The traced run's profile: the harness's own spans and the device's
operations from ``torch.profiler``, reduced to busy time, idle gaps and
kernel times.

The drivers wrap each call into the program in :meth:`Tracer.span`, and the
profiled stretch of the window in the span ``window``. The profile is
exported as a Chrome trace into a temporary directory, read back and
deleted. Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; their timestamps share the host's clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"


def union(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def short_name(name: str) -> str:
    """A device operation's name without its return type, arguments and
    template arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


class Trace:
    """A reduced profile: ``window`` (start, end) in µs, ``ops`` the device
    operations inside it (name, start, end), ``spans`` the harness's spans
    (name, start, end)."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not win:
            raise RuntimeError("the profile holds no window span")
        lo = float(win[0]["ts"])
        hi = lo + float(win[0]["dur"])
        self.window = (lo, hi)
        self.ops = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
                s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
                if t > lo and s < hi:
                    self.ops.append((e["name"], max(s, lo), min(t, hi)))
        self.spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in events if e.get("cat") == "user_annotation"
                      and e["name"] != WINDOW and e.get("ph") == "X"]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union((s, t) for _, s, t in self.ops) / 1e6

    def kernel(self, pattern: str, within: str | None = None) -> tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        ``pattern``, only those inside a ``within`` span when given."""
        spans = sorted((s, t) for n, s, t in self.spans if n == within) if within else None
        n, total = 0, 0.0
        for name, s, t in self.ops:
            if pattern not in name:
                continue
            if spans is not None and not any(a <= s and t <= b for a, b in spans):
                continue
            n += 1
            total += t - s
        return n, total / 1e6

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, s, t in self.ops:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (t - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle time inside the window, summed by the innermost harness span
        open on the host when each gap began ("host" where none was)."""
        gaps, end = [], self.window[0]
        for _, s, t in sorted(self.ops, key=lambda o: o[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        by: dict[str, float] = {}
        for lo, hi in gaps:
            open_ = [(s, n) for n, s, t in self.spans if s <= lo < t]
            label = max(open_)[1] if open_ else "host"
            by[label] = by.get(label, 0.0) + (hi - lo) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Tracer:
    """Spans around the program's calls and, when ``enabled``, the profiler
    over the stretch between :meth:`start` and :meth:`stop`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._prof = None
        self._window = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self, sync) -> None:
        """End the profiled stretch after ``sync()`` has waited for the
        device, and reduce the profile."""
        if self._prof is None:
            return
        sync()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.trace = Trace(events)
