"""Per-job execution-idle analysis of one telemetry frame (paper §2.1–2.2).

The subset of the JAX package's pipeline that a serving run needs:
classify each 1 Hz sample, integrate power per state, and list the
sustained execution-idle intervals.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.energy import EnergyBreakdown, integrate
from repro_torch.core.intervals import Interval, extract_intervals
from repro_torch.core.states import (ClassifierConfig, DEFAULT_CLASSIFIER,
                                     DeviceState, classify_series)
from repro_torch.telemetry.records import TelemetryFrame


@dataclasses.dataclass(frozen=True)
class JobAnalysis:
    job_id: int
    duration_s: float
    states: np.ndarray
    breakdown: EnergyBreakdown
    intervals: list[Interval]

    @property
    def exec_idle_time_fraction(self) -> float:
        return self.breakdown.exec_idle_time_fraction

    @property
    def exec_idle_energy_fraction(self) -> float:
        return self.breakdown.exec_idle_energy_fraction


def classify_frame(frame: TelemetryFrame,
                   config: ClassifierConfig = DEFAULT_CLASSIFIER) -> np.ndarray:
    return classify_series(
        frame["program_resident"].astype(bool),
        frame.activity_pct(),
        frame.comm_gbs(),
        config,
    )


def analyze_job(frame: TelemetryFrame,
                job_id: int,
                min_duration_s: float = 5.0,
                config: ClassifierConfig = DEFAULT_CLASSIFIER) -> JobAnalysis:
    states = classify_frame(frame, config)
    breakdown = integrate(states, frame["power"], min_duration_s=min_duration_s)
    intervals = extract_intervals(states, DeviceState.EXECUTION_IDLE, min_duration_s)
    return JobAnalysis(job_id=job_id, duration_s=float(len(frame)),
                       states=states, breakdown=breakdown, intervals=intervals)
