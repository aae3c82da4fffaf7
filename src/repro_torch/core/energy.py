"""Energy accounting over telemetry series (paper §2.2, §4).

Power is integrated per-sample (1 Hz board power, as NVML would report).
The paper's headline metrics are *in-execution fractions*: the denominator is
execution-idle + active time/energy only; deep-idle (unallocated or program
absent) is excluded (§4, "In-execution fractions").

This is the sample path of the JAX package's integrator (the run-table path
and the config axis are left out): same run decomposition, same summation
order, so breakdowns agree bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.intervals import Interval, RunCarry, runs_streaming
from repro_torch.core.states import DeviceState


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Time (s) and energy (J) per state, plus in-execution fractions."""

    time_s: dict[DeviceState, float]
    energy_j: dict[DeviceState, float]

    @property
    def total_time_s(self) -> float:
        return float(sum(self.time_s.values()))

    @property
    def total_energy_j(self) -> float:
        return float(sum(self.energy_j.values()))

    def time_fraction(self, state: DeviceState) -> float:
        t = self.total_time_s
        return self.time_s[state] / t if t else 0.0

    def energy_fraction(self, state: DeviceState) -> float:
        e = self.total_energy_j
        return self.energy_j[state] / e if e else 0.0

    @property
    def in_execution_time_s(self) -> float:
        return self.time_s[DeviceState.EXECUTION_IDLE] + self.time_s[DeviceState.ACTIVE]

    @property
    def in_execution_energy_j(self) -> float:
        return self.energy_j[DeviceState.EXECUTION_IDLE] + self.energy_j[DeviceState.ACTIVE]

    @property
    def exec_idle_time_fraction(self) -> float:
        t = self.in_execution_time_s
        return self.time_s[DeviceState.EXECUTION_IDLE] / t if t else 0.0

    @property
    def exec_idle_energy_fraction(self) -> float:
        e = self.in_execution_energy_j
        return self.energy_j[DeviceState.EXECUTION_IDLE] / e if e else 0.0


class StreamingIntegrator:
    """Boundary-aware ``integrate`` + ``extract_intervals`` over one stream.

    Feed time-ordered chunks via :meth:`update`; :meth:`finalize` returns the
    :class:`EnergyBreakdown` and the sustained EXECUTION_IDLE
    :class:`Interval` list. Each maximal run's energy is one ``np.sum`` over
    the run's full power samples (a run spanning chunks is held until it
    closes), so every chunking gives the same result bit for bit. Runs longer
    than ``max_pending_samples`` collapse their prefix into a partial sum.
    """

    def __init__(self, min_duration_s: float | None = 5.0, dt_s: float = 1.0,
                 max_pending_samples: int = 1 << 22):
        self.dt_s = dt_s
        self.min_samples = (0 if min_duration_s is None
                            else int(np.ceil(min_duration_s / dt_s)))
        self.max_pending_samples = max_pending_samples
        self._carry = RunCarry()
        self._pending: list[np.ndarray] = []   # [1, k] power of the pending run
        self._pending_n = 0
        self._collapsed = np.zeros(1)          # prefix sum of an over-long run
        self._time: dict[DeviceState, int] = {s: 0 for s in DeviceState}
        self._energy: dict[DeviceState, np.ndarray] = {
            s: np.zeros(1) for s in DeviceState}
        self._intervals: list[Interval] = []
        self.n_samples = 0

    def _close_run(self, state: int, start: int, end: int,
                   energy: np.ndarray) -> None:
        n = end - start
        final = DeviceState(state)
        if state == int(DeviceState.EXECUTION_IDLE):
            if n < self.min_samples:
                final = DeviceState.ACTIVE      # conservative relabel (§2.2)
            else:
                self._intervals.append(
                    Interval(DeviceState.EXECUTION_IDLE, start, end))
        self._time[final] += n
        self._energy[final] += energy

    def _pending_energy(self, extra: np.ndarray | None) -> np.ndarray:
        pieces = self._pending + (
            [extra] if extra is not None and extra.shape[-1] else [])
        if not pieces:
            arr_sum = 0.0
        elif len(pieces) == 1:
            arr_sum = np.sum(pieces[0], axis=-1)
        else:
            arr_sum = np.sum(np.concatenate(pieces, axis=-1), axis=-1)
        e = self._collapsed + arr_sum
        self._pending = []
        self._pending_n = 0
        self._collapsed = np.zeros(1)
        return e

    def update(self, states: np.ndarray, power_w: np.ndarray) -> None:
        states = np.asarray(states)
        power_w = np.asarray(power_w, dtype=np.float64)
        if states.shape != power_w.shape:
            raise ValueError(f"states {states.shape} vs power {power_w.shape}")
        power_w = power_w[None, :]
        if states.size == 0:
            return
        offset = self.n_samples
        completed, carry = runs_streaming(states, self._carry, offset)
        for state, start, end in completed:
            if start < offset:          # run includes carried-in samples
                energy = self._pending_energy(
                    power_w[:, :max(end - offset, 0)])
            else:
                energy = power_w[:, start - offset:end - offset].sum(axis=-1)
            self._close_run(state, start, end, energy)
        self._carry = carry
        if carry.length:
            piece = np.array(power_w[:, max(carry.start - offset, 0):])
            if piece.shape[-1]:
                self._pending.append(piece)
                self._pending_n += piece.shape[-1]
            if self._pending_n > self.max_pending_samples:
                self._collapsed += np.sum(
                    np.concatenate(self._pending, axis=-1), axis=-1)
                self._pending = []
                self._pending_n = 0
        self.n_samples += states.size

    def finalize(self) -> tuple[EnergyBreakdown, list[Interval]]:
        """Flush the trailing run; return the breakdown and intervals."""
        if self._carry.length:
            energy = self._pending_energy(None)
            self._close_run(self._carry.state, self._carry.start,
                            self._carry.start + self._carry.length, energy)
            self._carry = RunCarry()
        breakdown = EnergyBreakdown(
            time_s={s: float(self._time[s] * self.dt_s) for s in DeviceState},
            energy_j={s: float(self._energy[s][0] * self.dt_s)
                      for s in DeviceState},
        )
        return breakdown, self._intervals


def integrate(
    states: np.ndarray,
    power_w: np.ndarray,
    dt_s: float = 1.0,
    min_duration_s: float | None = 5.0,
) -> EnergyBreakdown:
    """Integrate power over a classified series.

    Args:
        states: int array [T] of DeviceState values.
        power_w: float array [T] of board power in watts.
        dt_s: sample spacing.
        min_duration_s: if given, EXECUTION_IDLE runs shorter than this are
            conservatively relabelled ACTIVE before accounting (§2.2).
    """
    si = StreamingIntegrator(min_duration_s=min_duration_s, dt_s=dt_s)
    si.update(states, power_w)
    breakdown, _ = si.finalize()
    return breakdown
