"""Order statistics the end-to-end metrics take over all of a window's
samples."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it. Missing samples
    count as ``math.inf``."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def mean(values) -> float | None:
    xs = list(values)
    return sum(xs) / len(xs) if xs else None


def window_steps(ctx) -> tuple[int, float]:
    """(the train steps that started in the window and whose loss reached
    the host by its end, the seconds from the window's start to the last of
    those losses)."""
    start, end = ctx["window"]
    s = ctx["steps"]
    done = [i for i in range(ctx["first"], len(s.loss))
            if s.start[i] >= start and s.loss_at[i] <= end]
    return (len(done), s.loss_at[done[-1]] - start) if done else (0, 0.0)
