"""Sustained-interval extraction over classified state series (paper §2.2, §4.4).

The paper counts an execution-idle interval only when the low-activity
condition holds *continuously* for at least ``min_duration_s`` (5 s baseline;
1 s permissive / 10 s conservative in Table 2).
Intervals shorter than the threshold are re-labelled as part of the
surrounding execution (ACTIVE) for accounting purposes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.states import DeviceState


@dataclasses.dataclass(frozen=True)
class Interval:
    """A maximal run of one state. ``start``/``end`` are sample indices,
    end-exclusive; with 1 Hz sampling they equal seconds."""

    state: DeviceState
    start: int
    end: int

    @property
    def duration(self) -> int:
        return self.end - self.start

    def __post_init__(self) -> None:
        if self.end <= self.start:
            raise ValueError(f"empty interval [{self.start}, {self.end})")


def runs(states: np.ndarray) -> Iterator[Interval]:
    """Yield maximal constant runs of a state series."""
    states = np.asarray(states)
    if states.size == 0:
        return
    change = np.flatnonzero(np.diff(states)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [states.size]])
    for s, e in zip(starts, ends):
        yield Interval(DeviceState(int(states[s])), int(s), int(e))


@dataclasses.dataclass
class RunCarry:
    """Trailing run of a chunked state stream, not yet known to be maximal.
    ``start`` is a global sample index; ``state`` is -1 when no run is
    pending."""

    state: int = -1
    start: int = 0
    length: int = 0


def runs_streaming(
    states: np.ndarray,
    carry: RunCarry,
    offset: int,
) -> tuple[list[tuple[int, int, int]], RunCarry]:
    """Boundary-aware run decomposition of one chunk.

    Returns ``(completed, carry_out)``: the ``(state, global_start,
    global_end)`` maximal runs finished within this chunk, in time order, and
    the new trailing run.
    """
    states = np.asarray(states)
    n = states.shape[0]
    if n == 0:
        return [], carry
    change = np.flatnonzero(np.diff(states)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])

    completed: list[tuple[int, int, int]] = []
    first = 0
    if carry.length:
        if carry.state == int(states[0]):
            if starts.size == 1:        # whole chunk continues the carry
                return [], RunCarry(carry.state, carry.start, carry.length + n)
            completed.append((carry.state, carry.start, offset + int(ends[0])))
            first = 1
        else:                           # carry ended exactly at the boundary
            completed.append((carry.state, carry.start, carry.start + carry.length))
    for i in range(first, starts.size - 1):
        completed.append((int(states[starts[i]]),
                          offset + int(starts[i]), offset + int(ends[i])))
    last = starts.size - 1
    carry_out = RunCarry(int(states[starts[last]]), offset + int(starts[last]),
                         int(ends[last] - starts[last]))
    return completed, carry_out


def extract_intervals(
    states: np.ndarray,
    state: DeviceState = DeviceState.EXECUTION_IDLE,
    min_duration_s: float = 5.0,
    dt_s: float = 1.0,
) -> list[Interval]:
    """All maximal runs of ``state`` lasting at least ``min_duration_s``."""
    min_samples = int(np.ceil(min_duration_s / dt_s))
    return [r for r in runs(states) if r.state == state and r.duration >= min_samples]


def apply_min_duration(
    states: np.ndarray,
    min_duration_s: float = 5.0,
    dt_s: float = 1.0,
    short_relabel: DeviceState = DeviceState.ACTIVE,
) -> np.ndarray:
    """Return a copy of ``states`` where EXECUTION_IDLE runs shorter than the
    sustain threshold are relabelled (conservative accounting, §2.2).

    Deep-idle runs are never relabelled — they are not transient DVFS events.
    """
    out = np.asarray(states).copy()
    min_samples = int(np.ceil(min_duration_s / dt_s))
    for r in runs(out):
        if r.state == DeviceState.EXECUTION_IDLE and r.duration < min_samples:
            out[r.start : r.end] = int(short_relabel)
    return out


def duration_percentiles(
    intervals: list[Interval], percentiles=(50, 90, 99), dt_s: float = 1.0
) -> dict[float, float]:
    """Duration percentiles in seconds over a set of intervals (Fig 8)."""
    if not intervals:
        return {float(p): float("nan") for p in percentiles}
    durations = np.array([iv.duration * dt_s for iv in intervals], dtype=np.float64)
    return {float(p): float(np.percentile(durations, p)) for p in percentiles}


def interval_count(states: np.ndarray, min_duration_s: float = 5.0, dt_s: float = 1.0) -> int:
    return len(extract_intervals(states, DeviceState.EXECUTION_IDLE, min_duration_s, dt_s))
