"""A kernel's share of its roofline in a traced window."""
from __future__ import annotations


def share(trace, pattern: str, within: str, per_call: list) -> float | None:
    """The sum of the bounds of the launches of the kernel named by
    ``pattern`` inside ``within`` spans over the sum of their device times,
    in percent. ``per_call`` is the bound of each launch one call of the
    step makes; a traced launch is charged their mean, so a launch the
    profiler did not record costs neither bound nor time. None when none was
    traced."""
    n, seconds = trace.kernel(pattern, within)
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * n * sum(w.bound_s for w in per_call) / len(per_call) / seconds
