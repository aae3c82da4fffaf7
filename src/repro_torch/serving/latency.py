"""Request/latency bookkeeping for serving experiments."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    req_id: int
    arrival_s: float
    prompt_tokens: int
    output_tokens: int
    device: int = -1
    start_s: float = -1.0
    finish_s: float = -1.0

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

@dataclasses.dataclass(frozen=True)
class LatencyStats:
    n: int
    mean_s: float
    p50_s: float
    p95_s: float
    p99_s: float

    @staticmethod
    def of(requests: list[Request]) -> "LatencyStats":
        done = [r for r in requests if r.finish_s >= 0]
        if not done:
            return LatencyStats(0, float("nan"), float("nan"), float("nan"),
                                float("nan"))
        lat = np.array([r.latency_s for r in done])
        return LatencyStats(
            n=len(done),
            mean_s=float(lat.mean()),
            p50_s=float(np.percentile(lat, 50)),
            p95_s=float(np.percentile(lat, 95)),
            p99_s=float(np.percentile(lat, 99)),
        )


def inter_arrival_cdf(requests: list[Request]) -> np.ndarray:
    """Sorted per-device inter-arrival gaps (Fig 6)."""
    gaps: list[float] = []
    by_device: dict[int, list[float]] = {}
    for r in requests:
        by_device.setdefault(r.device, []).append(r.arrival_s)
    for arr in by_device.values():
        arr.sort()
        gaps.extend(np.diff(arr))
    return np.sort(np.asarray(gaps))
