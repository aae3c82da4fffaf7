"""GPU operating-state taxonomy and the execution-idle classifier (paper §2.2).

Three states, mutually exclusive and collectively exhaustive:

* ``DEEP_IDLE``       — no program resident; device at baseline power.
* ``EXECUTION_IDLE``  — a program is resident, yet every available compute- and
                        memory-activity signal is below ``activity_threshold``
                        (default 5%) AND every available communication signal is
                        below ``comm_threshold_gbs`` (default 1 GB/s),
                        simultaneously.
* ``ACTIVE``          — a program is resident and at least one signal exceeds
                        its threshold.

Signals that are unavailable on a given platform are *omitted from the rule*
rather than treated as violated (paper §2.2).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

import numpy as np


class DeviceState(enum.IntEnum):
    """Operating state of one accelerator during one telemetry sample."""

    DEEP_IDLE = 0
    EXECUTION_IDLE = 1
    ACTIVE = 2


#: Signals treated as "compute or memory activity", in percent [0, 100].
COMPUTE_MEMORY_SIGNALS: tuple[str, ...] = (
    "sm",        # streaming-multiprocessor / scalar-core activity
    "tensor",    # tensor-core / MXU activity
    "fp16",
    "fp32",
    "fp64",
    "dram",      # memory-subsystem activity
)

#: Algorithm 1's split of the activity signals: ``a_comp`` is the max over
#: the compute counters, ``a_mem`` is dram. Derived from
#: COMPUTE_MEMORY_SIGNALS so the classifier, the step controller
#: (core.controller) and its vectorized re-derivation (repro_torch.whatif)
#: can never drift apart when the Table-1 schema grows.
COMPUTE_SIGNALS: tuple[str, ...] = tuple(
    s for s in COMPUTE_MEMORY_SIGNALS if s != "dram")

#: Signals treated as "communication", in GB/s.
COMMUNICATION_SIGNALS: tuple[str, ...] = (
    "pcie_tx",
    "pcie_rx",
    "nvlink_tx",
    "nvlink_rx",
    "ici_tx",    # TPU inter-chip interconnect (framework-native analogue)
    "ici_rx",
)


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    """Thresholds of the §2.2 execution-idle rule."""

    activity_threshold_pct: float = 5.0
    comm_threshold_gbs: float = 1.0
    compute_memory_signals: tuple[str, ...] = COMPUTE_MEMORY_SIGNALS
    communication_signals: tuple[str, ...] = COMMUNICATION_SIGNALS

    def validate(self) -> None:
        if not (0.0 <= self.activity_threshold_pct <= 100.0):
            raise ValueError("activity_threshold_pct must be in [0, 100]")
        if self.comm_threshold_gbs < 0:
            raise ValueError("comm_threshold_gbs must be >= 0")


DEFAULT_CLASSIFIER = ClassifierConfig()


def _available(sample: Mapping[str, object], key: str) -> bool:
    value = sample.get(key)
    if value is None:
        return False
    if isinstance(value, float) and np.isnan(value):
        return False
    return True


def classify_sample(
    sample: Mapping[str, object],
    config: ClassifierConfig = DEFAULT_CLASSIFIER,
) -> DeviceState:
    """Classify one telemetry sample (a mapping of signal name -> value).

    The sample must carry ``program_resident`` (bool). Missing activity /
    communication signals are omitted from the rule per the paper.
    """
    config.validate()
    if not sample.get("program_resident", False):
        return DeviceState.DEEP_IDLE

    for key in config.compute_memory_signals:
        if _available(sample, key) and float(sample[key]) >= config.activity_threshold_pct:
            return DeviceState.ACTIVE
    for key in config.communication_signals:
        if _available(sample, key) and float(sample[key]) >= config.comm_threshold_gbs:
            return DeviceState.ACTIVE
    return DeviceState.EXECUTION_IDLE


def classify_series(
    program_resident: np.ndarray,
    activity_pct: Mapping[str, np.ndarray] | None = None,
    comm_gbs: Mapping[str, np.ndarray] | None = None,
    config: ClassifierConfig = DEFAULT_CLASSIFIER,
) -> np.ndarray:
    """Vectorized classifier over aligned 1 Hz series.

    Args:
        program_resident: bool array [T] — a job's program is loaded.
        activity_pct: dict of signal name -> float array [T] in percent.
            NaN entries mean "signal unavailable at that sample".
        comm_gbs: dict of signal name -> float array [T] in GB/s.

    Returns:
        int array [T] of :class:`DeviceState` values.
    """
    config.validate()
    resident = np.asarray(program_resident, dtype=bool)
    n = resident.shape[0]
    active = np.zeros(n, dtype=bool)

    def _accumulate(signals: Mapping[str, np.ndarray] | None, names: Sequence[str], thr: float) -> None:
        nonlocal active
        if not signals:
            return
        for name in names:
            series = signals.get(name)
            if series is None:
                continue
            arr = np.asarray(series, dtype=np.float64)
            if arr.shape[0] != n:
                raise ValueError(f"signal {name!r} length {arr.shape[0]} != {n}")
            with np.errstate(invalid="ignore"):
                active |= np.nan_to_num(arr, nan=-np.inf) >= thr

    _accumulate(activity_pct, config.compute_memory_signals, config.activity_threshold_pct)
    _accumulate(comm_gbs, config.communication_signals, config.comm_threshold_gbs)

    out = np.full(n, int(DeviceState.DEEP_IDLE), dtype=np.int8)
    out[resident & active] = int(DeviceState.ACTIVE)
    out[resident & ~active] = int(DeviceState.EXECUTION_IDLE)
    return out


def state_time_fractions(states: np.ndarray, dt_s: float = 1.0) -> dict[DeviceState, float]:
    """Fraction of total sampled time spent in each state."""
    states = np.asarray(states)
    total = states.size * dt_s
    if total == 0:
        return {s: 0.0 for s in DeviceState}
    return {s: float(np.sum(states == int(s)) * dt_s / total) for s in DeviceState}


def in_execution_mask(states: np.ndarray) -> np.ndarray:
    """Samples counted in the paper's *in-execution* denominator (§4):
    execution-idle + active; deep-idle excluded."""
    states = np.asarray(states)
    return (states == int(DeviceState.EXECUTION_IDLE)) | (states == int(DeviceState.ACTIVE))
