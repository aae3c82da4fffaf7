"""Energy accounting over telemetry series (paper §2.2, §4).

Power is integrated per-sample (1 Hz board power, as NVML would report).
The paper's headline metrics are *in-execution fractions*: the denominator is
execution-idle + active time/energy only; deep-idle (unallocated or program
absent) is excluded (§4, "In-execution fractions").
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.intervals import Interval, RunCarry, runs_streaming
from repro_torch.core.states import DeviceState


JOULES_PER_KWH = 3.6e6
US_CENTS_PER_KWH = 13.6          # paper footnote 3
CO2E_LBS_PER_KWH = (0.82, 0.89)  # paper footnote 3
LBS_PER_METRIC_TON = 2204.62


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

    # ------------------------------------------------------------------ #
    # Whole-window fractions (Fig 3b uses these, denominator = everything)
    # ------------------------------------------------------------------ #
    def time_fraction(self, state: DeviceState) -> float:
        t = self.total_time_s
        return self.time_s[state] / t if t else 0.0

    def energy_fraction(self, state: DeviceState) -> float:
        e = self.total_energy_j
        return self.energy_j[state] / e if e else 0.0

    # ------------------------------------------------------------------ #
    # In-execution fractions (§4 headline metrics; deep-idle excluded)
    # ------------------------------------------------------------------ #
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


class BatchedStreamingIntegrator:
    """Boundary-aware energy integration over one stream, with a leading
    **config axis**: one shared classified-state series, ``n_configs``
    counterfactual power series integrated in a single pass.

    Feed time-ordered chunks via :meth:`update` with ``states [T]`` and
    ``power_w [n_configs, T]``; :meth:`finalize` returns one
    :class:`EnergyBreakdown` per config plus the shared sustained
    EXECUTION_IDLE :class:`Interval` list. Because every config sees the
    same state series, the run decomposition (the expensive, Python-level
    part) happens once; each run's energy is one ``np.sum(..., axis=-1)``
    over the config axis. Results are *bit-identical*, per config, to
    ``n_configs`` independent :class:`StreamingIntegrator` instances — and
    to every chunking of the same series — because:

    * run decomposition is chunking-invariant (:func:`runs_streaming` carries
      the trailing run across boundaries), so the §2.2 sustain rule sees the
      same maximal runs regardless of where chunks split;
    * each run's energy is ``np.sum`` over the run's full power samples —
      pending samples of an unfinished run are retained until the run closes,
      so the summation tree only depends on the run itself, and NumPy's
      pairwise reduction over the (contiguous) last axis applies the same
      summation tree per row as the 1-D sum of that row;
    * per-state totals accumulate run energies in time order, which is the
      same sequence of (elementwise) additions under any chunking.

    Retained pending samples are bounded by the longest constant-state run.
    As a safety valve, runs longer than ``max_pending_samples`` collapse their
    prefix into a partial sum (only such pathological runs can then differ
    from the monolithic result, in the last ulp).
    """

    def __init__(self, n_configs: int = 1, min_duration_s: float | None = 5.0,
                 dt_s: float = 1.0, max_pending_samples: int = 1 << 22):
        self.n_configs = n_configs
        self.dt_s = dt_s
        self.min_samples = (0 if min_duration_s is None
                            else int(np.ceil(min_duration_s / dt_s)))
        self.max_pending_samples = max_pending_samples
        self._carry = RunCarry()
        self._pending: list[np.ndarray] = []   # [C, k] power of the pending run
        self._pending_n = 0
        self._collapsed = np.zeros(n_configs)  # prefix sum of an over-long run
        self._run_energy: np.ndarray | None = None  # update_runs trailing run
        self._time: dict[DeviceState, int] = {s: 0 for s in DeviceState}
        self._energy: dict[DeviceState, np.ndarray] = {
            s: np.zeros(n_configs) for s in DeviceState}
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
        self._collapsed = np.zeros(self.n_configs)
        return e

    def update(self, states: np.ndarray, power_w: np.ndarray) -> None:
        if self._run_energy is not None:
            raise ValueError("update cannot follow update_runs() on one "
                             "integrator: trailing-run state differs")
        states = np.asarray(states)
        power_w = np.asarray(power_w, dtype=np.float64)
        if power_w.ndim == 1:
            power_w = power_w[None, :]
        if power_w.shape != (self.n_configs, states.shape[0]):
            raise ValueError(
                f"power {power_w.shape} vs expected "
                f"({self.n_configs}, {states.shape[0]})")
        if states.size == 0:
            return
        offset = self.n_samples
        completed, carry = runs_streaming(states, self._carry, offset)
        for state, start, end in completed:
            if start < offset:          # run includes carried-in samples
                energy = self._pending_energy(
                    power_w[:, :max(end - offset, 0)])
            else:
                # .sum() is np.sum minus the dispatch wrapper — same ufunc
                # reduction bit for bit, and this is the hot loop (one call
                # per maximal run per stream)
                energy = power_w[:, start - offset:end - offset].sum(axis=-1)
            self._close_run(state, start, end, energy)
        self._carry = carry
        if carry.length:
            # copy (not view) so chunk buffers can be released
            piece = np.array(power_w[:, max(carry.start - offset, 0):])
            if piece.shape[-1]:
                self._pending.append(piece)
                self._pending_n += piece.shape[-1]
            # valve on retained ELEMENTS (samples x configs): a [C, k]
            # pending block costs C times the scalar design's memory, so a
            # wide config axis must trip the collapse proportionally earlier
            if self._pending_n * self.n_configs > self.max_pending_samples:
                self._collapsed += np.sum(
                    np.concatenate(self._pending, axis=-1), axis=-1)
                self._pending = []
                self._pending_n = 0
        self.n_samples += states.size

    def update_runs(self, states: np.ndarray, energy: np.ndarray,
                    lengths: np.ndarray) -> None:
        """Run-weighted update: fold pre-aggregated runs instead of samples.

        The run-level IR fast path (:mod:`repro_torch.whatif.ir`) feeds this with
        ``states [R]`` (one state per run, consecutive duplicates allowed —
        e.g. runs split on an orthogonal flag), ``energy [n_configs, R]``
        (each run's power *sum* in W·samples, one row per config) and
        ``lengths [R]`` (samples per run). Consecutive equal-state runs are
        merged — including a trailing run carried across calls — so the
        §2.2 sustain rule sees the same maximal runs :meth:`update` would
        see on the expanded per-sample series: per-state *times* and the
        sustained-interval list are **bit-identical** to the sample path
        (integer sample counts), per-state *energies* agree up to float
        summation order (the per-run sums arrive pre-reduced).

        Do not mix with :meth:`update` on one instance: the two paths carry
        different trailing-run state.
        """
        if self._pending or (self._carry.length and self._run_energy is None):
            raise ValueError("update_runs cannot follow update() on one "
                             "integrator: trailing-run state differs")
        states = np.asarray(states)
        lengths = np.asarray(lengths, dtype=np.int64)
        energy = np.asarray(energy, dtype=np.float64)
        if energy.ndim == 1:
            energy = energy[None, :]
        if energy.shape != (self.n_configs, states.shape[0]):
            raise ValueError(f"energy {energy.shape} vs expected "
                             f"({self.n_configs}, {states.shape[0]})")
        if states.shape[0] != lengths.shape[0]:
            raise ValueError(
                f"states {states.shape} vs lengths {lengths.shape}")
        if states.size == 0:
            return
        change = np.flatnonzero(np.diff(states)) + 1
        starts = np.concatenate([[0], change])
        m_state = states[starts]
        m_len = np.add.reduceat(lengths, starts)
        m_energy = np.add.reduceat(energy, starts, axis=1)
        offsets = np.concatenate([[0], np.cumsum(m_len)])
        gpos = self.n_samples           # global index of this call's sample 0
        n_m = m_state.shape[0]
        i0 = 0
        if self._run_energy is not None and self._carry.state == int(m_state[0]):
            # trailing run continues: extend it in place
            self._carry.length += int(m_len[0])
            self._run_energy = self._run_energy + m_energy[:, 0]
            i0 = 1
        if i0 < n_m:
            self._flush_run_carry()     # old carry ended at a state change
            last = n_m - 1
            if i0 < last:
                # bulk-close every new maximal run except the trailing one:
                # per-state time/energy accumulate by masked sums (times are
                # exact integer sums; energy grouping differs from the
                # sample path only in float association)
                cs = m_state[i0:last].astype(np.int64)
                cl = m_len[i0:last]
                ce = m_energy[:, i0:last]
                cstart = gpos + offsets[i0:last]
                exec_i = int(DeviceState.EXECUTION_IDLE)
                final = np.where((cs == exec_i) & (cl < self.min_samples),
                                 int(DeviceState.ACTIVE), cs)
                for s in DeviceState:
                    mask = final == int(s)
                    if mask.any():
                        self._time[s] += int(cl[mask].sum())
                        self._energy[s] = (self._energy[s]
                                           + ce[:, mask].sum(axis=1))
                for i in np.flatnonzero((cs == exec_i)
                                        & (cl >= self.min_samples)):
                    self._intervals.append(Interval(
                        DeviceState.EXECUTION_IDLE, int(cstart[i]),
                        int(cstart[i] + cl[i])))
            self._carry = RunCarry(int(m_state[last]),
                                   gpos + int(offsets[last]),
                                   int(m_len[last]))
            self._run_energy = m_energy[:, last].copy()
        self.n_samples += int(offsets[-1])

    def _flush_run_carry(self) -> None:
        if self._run_energy is None:
            return
        self._close_run(self._carry.state, self._carry.start,
                        self._carry.start + self._carry.length,
                        self._run_energy)
        self._carry = RunCarry()
        self._run_energy = None

    def finalize_batch(self) -> tuple[list[EnergyBreakdown], list[Interval]]:
        """Flush carried state; one :class:`EnergyBreakdown` per config."""
        self._flush_run_carry()
        if self._carry.length:
            energy = self._pending_energy(None)
            self._close_run(self._carry.state, self._carry.start,
                            self._carry.start + self._carry.length, energy)
            self._carry = RunCarry()
        breakdowns = [
            EnergyBreakdown(
                time_s={s: float(self._time[s] * self.dt_s)
                        for s in DeviceState},
                energy_j={s: float(self._energy[s][c] * self.dt_s)
                          for s in DeviceState},
            )
            for c in range(self.n_configs)
        ]
        return breakdowns, self._intervals


class StreamingIntegrator(BatchedStreamingIntegrator):
    """Boundary-aware ``integrate`` + ``extract_intervals`` over one stream.

    The single-config view of :class:`BatchedStreamingIntegrator` (which see
    for the bit-identity contract): feed time-ordered chunks of a single
    (job, host, device) stream via :meth:`update` with 1-D ``power_w``;
    :meth:`finalize` returns the :class:`EnergyBreakdown` and the sustained
    EXECUTION_IDLE :class:`Interval` list. Results are *bit-identical* for
    every chunking of the same series, including the monolithic single-chunk
    case (:func:`integrate` is this class applied once).
    """

    def __init__(self, min_duration_s: float | None = 5.0, dt_s: float = 1.0,
                 max_pending_samples: int = 1 << 22):
        super().__init__(n_configs=1, min_duration_s=min_duration_s,
                         dt_s=dt_s, max_pending_samples=max_pending_samples)

    def update(self, states: np.ndarray, power_w: np.ndarray) -> None:
        states = np.asarray(states)
        power_w = np.asarray(power_w, dtype=np.float64)
        if states.shape != power_w.shape:
            raise ValueError(f"states {states.shape} vs power {power_w.shape}")
        super().update(states, power_w)

    def finalize(self) -> tuple[EnergyBreakdown, list[Interval]]:
        breakdowns, intervals = self.finalize_batch()
        return breakdowns[0], intervals


def integrate(
    states: np.ndarray,
    power_w: np.ndarray,
    dt_s: float = 1.0,
    min_duration_s: float | None = 5.0,
) -> EnergyBreakdown:
    """Integrate power over a classified series.

    Single-chunk application of :class:`StreamingIntegrator`, so monolithic
    and chunked analyses share one accounting implementation (and agree
    bit-for-bit).

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


def integrate_runs_with_intervals(
    states: np.ndarray,
    energy: np.ndarray,
    lengths: np.ndarray,
    min_samples: int,
    dt_s: float = 1.0,
) -> tuple[list[EnergyBreakdown], list[Interval]]:
    """Integrate pre-aggregated runs, keeping the sustained-interval list.

    Single-call application of
    :meth:`BatchedStreamingIntegrator.update_runs` — the run-level IR's
    accounting primitive (``states [R]``, ``energy [C, R]`` per-run power
    sums in W·samples, ``lengths [R]``). Per-state times, interval bounds
    and counts are bit-identical to sample-level integration of the
    expanded series; energies agree up to float summation order. The
    interval sample indices are stream-local (sample 0 = the first run's
    first sample), exactly like a single-stream :func:`integrate` pass.
    """
    energy = np.asarray(energy, dtype=np.float64)
    if energy.ndim == 1:
        energy = energy[None, :]
    bi = BatchedStreamingIntegrator(n_configs=energy.shape[0],
                                    min_duration_s=None, dt_s=dt_s)
    bi.min_samples = int(min_samples)
    bi.update_runs(states, energy, lengths)
    return bi.finalize_batch()


def integrate_runs(
    states: np.ndarray,
    energy: np.ndarray,
    lengths: np.ndarray,
    min_samples: int,
    dt_s: float = 1.0,
) -> list[EnergyBreakdown]:
    """Breakdown-only view of :func:`integrate_runs_with_intervals`."""
    breakdowns, _ = integrate_runs_with_intervals(
        states, energy, lengths, min_samples, dt_s)
    return breakdowns


def merge(breakdowns: list[EnergyBreakdown]) -> EnergyBreakdown:
    """Aggregate per-device/per-job breakdowns into a fleet breakdown."""
    time_s = {s: 0.0 for s in DeviceState}
    energy_j = {s: 0.0 for s in DeviceState}
    for b in breakdowns:
        for s in DeviceState:
            time_s[s] += b.time_s[s]
            energy_j[s] += b.energy_j[s]
    return EnergyBreakdown(time_s=time_s, energy_j=energy_j)


def energy_kwh(energy_j: float) -> float:
    return energy_j / JOULES_PER_KWH


def cost_usd(energy_j: float, cents_per_kwh: float = US_CENTS_PER_KWH) -> float:
    return energy_kwh(energy_j) * cents_per_kwh / 100.0


def co2e_metric_tons(energy_j: float) -> tuple[float, float]:
    """(low, high) CO2e estimate per paper footnote 3."""
    kwh = energy_kwh(energy_j)
    lo, hi = CO2E_LBS_PER_KWH
    return kwh * lo / LBS_PER_METRIC_TON, kwh * hi / LBS_PER_METRIC_TON


def tdp_upper_bound_j(tdp_w: float, window_s: float, n_devices: int = 1) -> float:
    """Energy had the fleet run at TDP continuously (Fig 3a comparison)."""
    return tdp_w * window_s * n_devices


def fraction_of_tdp(total_energy_j: float, tdp_w: float, window_s: float, n_devices: int) -> float:
    return total_energy_j / tdp_upper_bound_j(tdp_w, window_s, n_devices)
