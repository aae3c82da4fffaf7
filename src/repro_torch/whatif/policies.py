"""Candidate execution-idle mitigation policies for counterfactual replay.

Each policy answers, per telemetry sample of one (job, host, device) stream:
*what would the device have done under this mitigation*, expressed as a
counterfactual board power (and optionally residency) series plus a modeled
performance penalty. Policies are **vectorized** and **streaming**: ``apply``
consumes time-ordered segments of any size and carries state across segment
boundaries, so a replay over 1-row chunks, storage shards, or the whole
stream produces the exact same decision sequence.

The policy set mirrors the paper's mitigation space:

* :class:`DownscalePolicy` — Algorithm 1 (§5.3) frequency control, a
  vectorized re-derivation of
  :class:`repro_torch.core.controller.ExecutionIdleController` whose decision
  sequence is verified identical to the step-by-step controller
  (tests/test_whatif.py);
* :class:`ParkingPolicy` — §5.1 consolidation: k-of-n devices serve, the
  rest park their execution-idle time at deep-idle power, paying a
  model-reload tax per wake (the "Model Parking Tax" trade-off);
* :class:`PowerCapPolicy` — board power capping with a cube-law slowdown on
  capped active samples (deadline-aware frequency-scaling baseline);
* :class:`NoOpPolicy` — the recorded fleet, unchanged (frontier origin);
* :class:`CompositePolicy` — any sequence of the above applied in order
  (e.g. park the n-k inactive devices, downscale the rest), a first-class
  policy in the :mod:`repro_torch.whatif.effects` algebra.

Every policy validates its knobs at construction — a malformed grid point
raises a ``ValueError`` naming the knob, instead of failing deep inside the
replay.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.core.energy import EnergyBreakdown, integrate_runs
from repro_torch.core.imbalance import PoolConfig
from repro_torch.core.power_model import ClockLevel, PlatformSpec
from repro_torch.core.states import (COMMUNICATION_SIGNALS, COMPUTE_SIGNALS,
                                     DeviceState)
from repro_torch.telemetry.records import TelemetryFrame
from repro_torch.whatif.effects import (BatchEffect, SegmentEffect, compose,
                                        effect_view, identity_effect,
                                        policy_event_channels, policy_event_prices)


def _threshold_params(config: ControllerConfig) -> dict:
    """Signal-threshold knobs shared by every policy's ``describe()`` —
    ``describe()`` doubles as the merge-compatibility key, so every knob
    that changes decisions must appear in it."""
    return {
        "interval_eps_s": config.interval_eps_s,
        "activity_threshold": config.activity_threshold,
        "comm_threshold_gbs": config.comm_threshold_gbs,
    }


def low_activity_series(seg: TelemetryFrame, config: ControllerConfig) -> np.ndarray:
    """Vectorized Algorithm-1 low-activity predicate over one segment.

    Matches :meth:`ExecutionIdleController._low_activity` exactly when the
    controller is fed the same samples with activity as fractions
    (percent / 100) and NaN (signal unavailable) replaced by 0.0.

    Memoized per segment object and threshold pair: a sweep feeds the same
    segment to every grid config, and most configs share
    thresholds, so the ~12 full-array passes run once, not once per config.
    """
    key = (config.activity_threshold, config.comm_threshold_gbs)
    cache = getattr(seg, "_low_cache", None)
    if cache is None:
        cache = seg._low_cache = {}
    cached = cache.get(key)
    if cached is not None:
        return cached
    n = len(seg)
    comp = np.zeros(n)
    for k in COMPUTE_SIGNALS:
        comp = np.maximum(comp, np.nan_to_num(seg[k], nan=0.0))
    mem = np.nan_to_num(seg["dram"], nan=0.0)
    comm = np.zeros(n)
    for k in COMMUNICATION_SIGNALS:
        comm = np.maximum(comm, np.nan_to_num(seg[k], nan=0.0))
    low = ((comp / 100.0 < config.activity_threshold)
           & (mem / 100.0 < config.activity_threshold)
           & (comm < config.comm_threshold_gbs))
    cache[key] = low
    return low


@runtime_checkable
class Policy(Protocol):
    """What the replayer needs from a mitigation policy."""

    @property
    def name(self) -> str: ...
    def describe(self) -> dict: ...
    def init_carry(self) -> Any: ...
    def apply(self, seg: TelemetryFrame, plat: PlatformSpec, carry: Any,
              dt_s: float = 1.0) -> tuple[SegmentEffect, Any]: ...
    def event_penalty_s(self, plat: PlatformSpec) -> float: ...


# --------------------------------------------------------------------------- #
# No-op baseline
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class NoOpPolicy:
    """The recorded fleet, unchanged — anchors the frontier at (0, 0)."""

    @property
    def name(self) -> str:
        return "noop"

    def describe(self) -> dict:
        return {"policy": self.name}

    def init_carry(self) -> None:
        return None

    def apply(self, seg: TelemetryFrame, plat: PlatformSpec, carry: None,
              dt_s: float = 1.0) -> tuple[SegmentEffect, None]:
        n = len(seg)
        return SegmentEffect(
            power_w=np.asarray(seg["power"], dtype=np.float64),
            resident=None,
            throttled=np.zeros(n, dtype=bool),
        ), None

    def event_penalty_s(self, plat: PlatformSpec) -> float:
        return 0.0


# --------------------------------------------------------------------------- #
# Algorithm-1 downscaling, vectorized
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class DownscaleCarry:
    """Controller state carried across segment boundaries.

    ``c`` is the consecutive low-activity accumulator *as the step controller
    would hold it* (left-fold float additions of ``interval_eps_s``), so the
    trigger comparison ``c > X`` lands on the same sample for every chunking.
    """

    c: float = 0.0
    t_cooldown: float = 0.0
    downscaled: bool = False


def downscale_decisions(
    ts: np.ndarray,
    low: np.ndarray,
    config: ControllerConfig,
    carry: DownscaleCarry,
) -> tuple[np.ndarray, DownscaleCarry, int, int]:
    """Vectorized Algorithm-1 decision sequence over one segment.

    Returns ``(downscaled_after_step, carry_out, n_downscales, n_restores)``
    where ``downscaled_after_step[i]`` equals the return value of
    :meth:`ExecutionIdleController.step` at sample ``i`` — verified exactly
    in tests/test_whatif.py over simulator and DES telemetry.

    The recurrence is vectorized by low/busy *runs*: within a low run the
    accumulator ``c`` is a strict left-fold (``np.add.accumulate``) matching
    the controller's repeated float addition, and the trigger index is the
    max of the first ``c > X`` sample and the first ``t >= t_cooldown``
    sample (both thresholds are monotone within a run). The Python loop is
    O(runs), not O(samples).
    """
    low = np.asarray(low, dtype=bool)
    ts = np.asarray(ts, dtype=np.float64)
    n = low.shape[0]
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out, carry, 0, 0
    c, t_cd, ds = carry.c, carry.t_cooldown, carry.downscaled
    eps, x, y = config.interval_eps_s, config.threshold_x_s, config.cooldown_y_s

    change = np.flatnonzero(np.diff(low)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    n_down = n_rest = 0

    for s, e in zip(starts, ends):
        if not low[s]:
            # activity: c resets; restore (and start the cooldown clock) if
            # the device was downscaled — both happen at the run's first step
            if ds:
                ds = False
                n_rest += 1
                t_cd = float(ts[s]) + y
            c = 0.0
        elif ds:
            # already downscaled: stays downscaled for the whole low run.
            # c keeps accumulating in the controller but is unobservable
            # until the next activity resets it, so its value is dead here.
            out[s:e] = True
        else:
            m = e - s
            buf = np.empty(m + 1)
            buf[0] = c
            buf[1:] = eps
            cs = np.add.accumulate(buf)[1:]        # strict left-fold, as step()
            if cs[-1] > x:                          # cs is strictly increasing
                i_c = int(np.argmax(cs > x))
                i_t = int(np.searchsorted(ts[s:e], t_cd, side="left"))
                i = max(i_c, i_t)
                if i < m:
                    out[s + i:e] = True
                    ds = True
                    n_down += 1
            c = float(cs[-1])
    return out, DownscaleCarry(c=c, t_cooldown=t_cd, downscaled=ds), n_down, n_rest


@dataclasses.dataclass(frozen=True)
class DownscalePolicy:
    """Algorithm-1 frequency control replayed counterfactually (§5.3).

    Energy model: while downscaled (and the program is resident) the board
    power drops by the residency-floor gap
    ``exec_idle_w - residency_floor_w(f_min clocks)`` — downscaling attacks
    the floor, not the activity term — clipped below at deep-idle power.

    Penalty model: each downscale episode stalls the device for two clock
    switches (down + up, Velicka et al. [52]) plus one control interval of
    ramp at ``perf_scale(f_min)``; priced per *restore* event so totals are
    chunking-invariant.
    """

    config: ControllerConfig = ControllerConfig()
    switch_latency_s: float = 0.2
    compute_bound_fraction: float = 0.7

    def __post_init__(self) -> None:
        if not self.config.threshold_x_s > 0:
            raise ValueError(
                f"DownscalePolicy threshold_x_s must be positive, got "
                f"{self.config.threshold_x_s}")
        if not self.config.cooldown_y_s > 0:
            raise ValueError(
                f"DownscalePolicy cooldown_y_s must be positive, got "
                f"{self.config.cooldown_y_s}")
        if not self.config.interval_eps_s > 0:
            raise ValueError(
                f"DownscalePolicy interval_eps_s must be positive, got "
                f"{self.config.interval_eps_s}")
        if self.switch_latency_s < 0:
            raise ValueError(
                f"DownscalePolicy switch_latency_s must be >= 0, got "
                f"{self.switch_latency_s}")

    @property
    def name(self) -> str:
        return "downscale"

    def describe(self) -> dict:
        return {
            "policy": self.name,
            "threshold_x_s": self.config.threshold_x_s,
            "cooldown_y_s": self.config.cooldown_y_s,
            "mode": self.config.mode.value,
            "switch_latency_s": self.switch_latency_s,
            "compute_bound_fraction": self.compute_bound_fraction,
            **_threshold_params(self.config),
        }

    def init_carry(self) -> DownscaleCarry:
        return DownscaleCarry()

    def _min_clocks(self) -> tuple[ClockLevel, ClockLevel]:
        if self.config.mode == DownscaleMode.SM_AND_MEM:
            return ClockLevel.MIN, ClockLevel.MIN
        return ClockLevel.MIN, ClockLevel.MAX

    def apply(self, seg: TelemetryFrame, plat: PlatformSpec,
              carry: DownscaleCarry,
              dt_s: float = 1.0) -> tuple[SegmentEffect, DownscaleCarry]:
        low = low_activity_series(seg, self.config)
        decisions, carry, n_down, n_rest = downscale_decisions(
            seg["timestamp"], low, self.config, carry)
        sm, mem = self._min_clocks()
        delta = plat.exec_idle_w - plat.residency_floor_w(sm, mem)
        resident = seg["program_resident"].astype(bool)
        throttled = decisions & resident
        power = np.asarray(seg["power"], dtype=np.float64)
        cf = np.where(throttled, np.maximum(power - delta, plat.deep_idle_w), power)
        return SegmentEffect(
            power_w=cf,
            resident=None,
            throttled=throttled,
            wake_events=n_rest,
            downscale_events=n_down,
        ), carry

    def event_penalty_s(self, plat: PlatformSpec) -> float:
        sm, mem = self._min_clocks()
        r = plat.perf_scale(sm, mem, self.compute_bound_fraction)
        return 2.0 * self.switch_latency_s + self.config.interval_eps_s * (1.0 - r)


# --------------------------------------------------------------------------- #
# Consolidation / parking (§5.1, k-of-n via core.imbalance)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ParkCarry:
    prev_idle: bool = False


@dataclasses.dataclass(frozen=True)
class ParkingPolicy:
    """Deliberate-imbalance consolidation: park the n-k inactive devices.

    Device membership follows :meth:`repro_torch.core.imbalance.PoolConfig
    .active_set` applied to consecutive blocks of ``pool.n_devices`` device
    ids (``device_id % n_devices``); parked devices drop their
    execution-idle samples to deep-idle power and residency (the program is
    evicted). Recorded active work on a parked device stays in place —
    a conservative counterfactual, since real consolidation migrates it —
    but each idle-to-active transition pays ``resume_latency_s`` of model
    reload (the Model Parking Tax).
    """

    pool: PoolConfig
    resume_latency_s: float = 10.0
    config: ControllerConfig = ControllerConfig()

    def __post_init__(self) -> None:
        if self.pool.n_devices < 1:
            raise ValueError(
                f"ParkingPolicy pool must have >= 1 device, got "
                f"{self.pool.n_devices}")
        if self.pool.n_active is not None and not (
                1 <= self.pool.n_active <= self.pool.n_devices):
            raise ValueError(
                f"ParkingPolicy requires 1 <= n_active <= n_devices, got "
                f"n_active={self.pool.n_active} for a pool of "
                f"{self.pool.n_devices}")
        self.pool.active_set()   # BALANCED/CONSOLIDATED consistency check
        if self.resume_latency_s < 0:
            raise ValueError(
                f"ParkingPolicy resume_latency_s must be >= 0, got "
                f"{self.resume_latency_s}")

    @property
    def name(self) -> str:
        return "parking"

    def describe(self) -> dict:
        return {
            "policy": self.name,
            "n_devices": self.pool.n_devices,
            "n_active": len(self.pool.active_set()),
            "resume_latency_s": self.resume_latency_s,
            **_threshold_params(self.config),
        }

    def init_carry(self) -> ParkCarry:
        return ParkCarry()

    def apply(self, seg: TelemetryFrame, plat: PlatformSpec, carry: ParkCarry,
              dt_s: float = 1.0) -> tuple[SegmentEffect, ParkCarry]:
        n = len(seg)
        power = np.asarray(seg["power"], dtype=np.float64)
        dev = int(seg["device_id"][0])
        if dev % self.pool.n_devices in self.pool.active_set():
            return SegmentEffect(
                power_w=power, resident=None, throttled=np.zeros(n, bool),
            ), carry
        low = low_activity_series(seg, self.config)
        resident = seg["program_resident"].astype(bool)
        idle = resident & low
        active = resident & ~low
        prev_idle = np.empty(n, dtype=bool)
        prev_idle[0] = carry.prev_idle
        prev_idle[1:] = idle[:-1]
        wakes = int(np.sum(active & prev_idle))
        return SegmentEffect(
            power_w=np.where(idle, plat.deep_idle_w, power),
            resident=resident & ~idle,
            throttled=idle,
            wake_events=wakes,
        ), ParkCarry(prev_idle=bool(idle[-1]))

    def event_penalty_s(self, plat: PlatformSpec) -> float:
        return self.resume_latency_s


# --------------------------------------------------------------------------- #
# Power capping
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PowerCapPolicy:
    """Cap board power at ``cap_fraction * tdp_w``.

    Capped *active* samples slow down by the cube-law frequency/power
    relation (perf ∝ f, power ∝ f³): each such sample loses
    ``dt_s * ((power/cap)^(1/3) - 1)`` seconds of progress, priced at the
    replayer's sampling interval. Penalty partials are fsum'd at finalize:
    identical for any fixed chunking (hence across worker counts), within
    one ulp across different chunkings (per-chunk ``np.sum`` rounding).
    """

    cap_fraction: float = 0.6
    config: ControllerConfig = ControllerConfig()

    def __post_init__(self) -> None:
        if not 0.0 < self.cap_fraction <= 1.0:
            raise ValueError(
                f"PowerCapPolicy cap_fraction must be in (0, 1], got "
                f"{self.cap_fraction}")

    @property
    def name(self) -> str:
        return "powercap"

    def describe(self) -> dict:
        return {"policy": self.name, "cap_fraction": self.cap_fraction,
                **_threshold_params(self.config)}

    def init_carry(self) -> None:
        return None

    def apply(self, seg: TelemetryFrame, plat: PlatformSpec, carry: None,
              dt_s: float = 1.0) -> tuple[SegmentEffect, None]:
        power = np.asarray(seg["power"], dtype=np.float64)
        cap_w = self.cap_fraction * plat.tdp_w
        over = power > cap_w
        low = low_activity_series(seg, self.config)
        resident = seg["program_resident"].astype(bool)
        capped_active = over & resident & ~low
        slow = np.cbrt(power[capped_active] / cap_w) - 1.0
        return SegmentEffect(
            power_w=np.minimum(power, cap_w),
            resident=None,
            throttled=over,
            penalty_partial_s=dt_s * float(np.sum(slow)),
        ), None

    def event_penalty_s(self, plat: PlatformSpec) -> float:
        return 0.0


# --------------------------------------------------------------------------- #
# Sequential composition (the effect algebra's product)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CompositePolicy:
    """Apply ``parts`` in sequence: each part sees the previous part's
    counterfactual (power and residency overridden, every signal column
    recorded) and the effects fold through
    :func:`repro_torch.whatif.effects.compose`.

    The motivating composite is the operator's real mitigation: park the
    pool's inactive devices and downscale the ones that keep serving —
    ``CompositePolicy((ParkingPolicy(pool), DownscalePolicy(cfg)))``. The
    two parts act on disjoint device sets (parking no-ops on active devices;
    on parked devices the idle samples lose residency, so downscale's
    ``throttled = decisions & resident`` no-ops there), and each part prices
    its own events: part ``i``'s wake counts occupy their own pricing
    channel, so parking wakes cost the resume latency while downscale
    restores cost the clock-switch stall (see
    :func:`repro_torch.whatif.effects.policy_event_prices`).

    Composition is sequential, not commutative in general — parts that touch
    the same samples (e.g. downscale then power-cap) compose like the real
    controllers would, downstream of each other's output.
    """

    parts: tuple[Policy, ...]

    def __post_init__(self) -> None:
        if not self.parts:
            raise ValueError("CompositePolicy requires at least one part")
        for p in self.parts:
            if not isinstance(p, Policy):
                raise ValueError(
                    f"CompositePolicy parts must implement the Policy "
                    f"protocol, got {type(p).__name__}")
        object.__setattr__(self, "parts", tuple(self.parts))

    @property
    def name(self) -> str:
        return "+".join(p.name for p in self.parts)

    def describe(self) -> dict:
        return {"policy": "composite",
                "parts": [p.describe() for p in self.parts]}

    @property
    def n_event_channels(self) -> int:
        return sum(policy_event_channels(p) for p in self.parts)

    def event_prices_s(self, plat: PlatformSpec) -> np.ndarray:
        """Concatenated per-part price vectors, in part order."""
        return np.concatenate(
            [policy_event_prices(p, plat) for p in self.parts])

    def event_penalty_s(self, plat: PlatformSpec) -> float:
        """Unused: composite events are priced per channel via
        :meth:`event_prices_s` (each part keeps its own per-event cost)."""
        return 0.0

    def init_carry(self) -> tuple:
        return tuple(p.init_carry() for p in self.parts)

    def apply(self, seg: TelemetryFrame, plat: PlatformSpec, carry: tuple,
              dt_s: float = 1.0) -> tuple[SegmentEffect, tuple]:
        k_total = self.n_event_channels
        eff = identity_effect(seg, n_channels=k_total)
        cur = seg
        out_carries = []
        k0 = 0
        for i, (p, c) in enumerate(zip(self.parts, carry)):
            if i > 0:
                cur = effect_view(cur, part_eff)
            part_eff, c2 = p.apply(cur, plat, c, dt_s=dt_s)
            out_carries.append(c2)
            kp = policy_event_channels(p)
            events = np.zeros(k_total, dtype=np.int64)
            events[k0:k0 + kp] = part_eff.event_vector(kp)
            eff = compose(eff, dataclasses.replace(part_eff, events=events))
            k0 += kp
        return eff, tuple(out_carries)


# --------------------------------------------------------------------------- #
# Family-batched evaluators (config-axis replay)
# --------------------------------------------------------------------------- #
@runtime_checkable
class PolicyBatch(Protocol):
    """A family of policy configs evaluated in one pass per segment.

    The config-axis analogue of :class:`Policy`: ``apply_batch`` consumes the
    same time-ordered segments, carries one (vectorized) state across segment
    boundaries for the whole family, and must be **bit-identical**, per
    member config, to that config's scalar :meth:`Policy.apply` replay.
    """

    @property
    def policies(self) -> tuple[Policy, ...]: ...
    def init_carry(self) -> Any: ...
    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec, carry: Any,
                    dt_s: float = 1.0) -> tuple[BatchEffect, Any]: ...


def _identity_effect(n: int, n_configs: int) -> BatchEffect:
    return BatchEffect(
        power_rows=np.empty((0, n)),
        throttled_rows=np.empty((0, n), dtype=bool),
        row_of=np.full(n_configs, -1, dtype=np.int64),
        resident_rows=None,
        penalty_partial_s=np.zeros(n_configs),
        wake_events=np.zeros(n_configs, dtype=np.int64),
        downscale_events=np.zeros(n_configs, dtype=np.int64),
    )


@dataclasses.dataclass(frozen=True)
class NoOpBatch:
    """All members are the recorded fleet: every config aliases baseline."""

    policies: tuple[NoOpPolicy, ...]

    def init_carry(self) -> None:
        return None

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec, carry: None,
                    dt_s: float = 1.0) -> tuple[BatchEffect, None]:
        return _identity_effect(len(seg), len(self.policies)), None

    def apply_runs(self, stream, plat: PlatformSpec, min_samples: int,
                   dt_s: float) -> "RunBatchResult":
        return _identity_run_result(len(self.policies))


@dataclasses.dataclass
class BatchDownscaleCarry:
    """Per-config controller state, carried across segment boundaries.

    The vector form of :class:`DownscaleCarry`: element ``c`` of each array
    is exactly what the scalar carry would hold after the same samples.
    """

    c: np.ndarray            # [C] consecutive low-activity accumulators
    t_cooldown: np.ndarray   # [C]
    downscaled: np.ndarray   # [C] bool


def batched_downscale_decisions(
    ts: np.ndarray,
    low: np.ndarray,
    eps: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    carry: BatchDownscaleCarry,
) -> tuple[np.ndarray, BatchDownscaleCarry, np.ndarray, np.ndarray]:
    """Config-axis Algorithm-1 decision sequences over one segment.

    The same low/busy-run loop as :func:`downscale_decisions`, advanced for
    every config of the family per run with vector ops over the config axis —
    O(runs) Python for the *whole grid* instead of per config. Bit-identical
    per config: the in-run accumulator is the same strict left-fold
    (``np.add.accumulate`` along the sample axis is sequential per row), the
    trigger index the same max of first ``c > X`` and first ``t >=
    t_cooldown`` sample, and the restore/cooldown updates the same elementwise
    float ops the scalar recurrence performs.

    Returns ``(downscaled_after_step [C, n], carry_out, n_downscales [C],
    n_restores [C])``.
    """
    low = np.asarray(low, dtype=bool)
    ts = np.asarray(ts, dtype=np.float64)
    n = low.shape[0]
    n_cfg = eps.shape[0]
    out = np.zeros((n_cfg, n), dtype=bool)
    n_down = np.zeros(n_cfg, dtype=np.int64)
    n_rest = np.zeros(n_cfg, dtype=np.int64)
    if n == 0:
        return out, carry, n_down, n_rest
    c = carry.c.copy()
    t_cd = carry.t_cooldown.copy()
    ds = carry.downscaled.copy()

    change = np.flatnonzero(np.diff(low)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])

    for s, e in zip(starts, ends):
        if not low[s]:
            # activity: c resets; configs that were downscaled restore (and
            # start their cooldown clock) at the run's first step
            n_rest += ds
            t_cd[ds] = float(ts[s]) + y[ds]
            ds[:] = False
            c[:] = 0.0
        else:
            m = e - s
            # already-downscaled configs stay downscaled for the whole run
            # (their c is unobservable until the next activity resets it)
            out[ds, s:e] = True
            idle = np.flatnonzero(~ds)
            if idle.size:
                buf = np.empty((idle.size, m + 1))
                buf[:, 0] = c[idle]
                buf[:, 1:] = eps[idle, None]
                cs = np.add.accumulate(buf, axis=1)[:, 1:]  # left-fold per row
                trig = cs[:, -1] > x[idle]                  # strictly increasing
                if np.any(trig):
                    i_c = np.argmax(cs > x[idle, None], axis=1)
                    i_t = np.searchsorted(ts[s:e], t_cd[idle], side="left")
                    i = np.maximum(i_c, i_t)
                    fire = trig & (i < m)
                    rows = idle[fire]
                    if rows.size:
                        out[rows, s:e] = np.arange(m) >= i[fire][:, None]
                        ds[rows] = True
                        n_down[rows] += 1
                c[idle] = cs[:, -1]
    return out, BatchDownscaleCarry(c=c, t_cooldown=t_cd, downscaled=ds), \
        n_down, n_rest


@dataclasses.dataclass(frozen=True)
class DownscaleBatch:
    """Every downscale config sharing one low-activity series, one pass.

    Members must agree on ``(activity_threshold, comm_threshold_gbs)`` (the
    low-series key — enforced by :func:`make_batches`); X, Y, eps and the
    clock mode vary freely along the config axis.
    """

    policies: tuple[DownscalePolicy, ...]

    def __post_init__(self) -> None:
        pols = self.policies
        object.__setattr__(self, "_eps",
                           np.array([p.config.interval_eps_s for p in pols]))
        object.__setattr__(self, "_x",
                           np.array([p.config.threshold_x_s for p in pols]))
        object.__setattr__(self, "_y",
                           np.array([p.config.cooldown_y_s for p in pols]))
        object.__setattr__(self, "_trig", _trigger_indices(self._eps, self._x))
        object.__setattr__(self, "_delta_cache", {})

    def init_carry(self) -> BatchDownscaleCarry:
        n_cfg = len(self.policies)
        return BatchDownscaleCarry(
            c=np.zeros(n_cfg),
            t_cooldown=np.zeros(n_cfg),
            downscaled=np.zeros(n_cfg, dtype=bool),
        )

    def _delta(self, plat: PlatformSpec) -> np.ndarray:
        delta = self._delta_cache.get(plat.name)
        if delta is None:
            delta = self._delta_cache[plat.name] = np.array([
                plat.exec_idle_w - plat.residency_floor_w(*p._min_clocks())
                for p in self.policies])
        return delta

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec,
                    carry: BatchDownscaleCarry,
                    dt_s: float = 1.0) -> tuple[BatchEffect, BatchDownscaleCarry]:
        pols = self.policies
        low = low_activity_series(seg, pols[0].config)
        decisions, carry, n_down, n_rest = batched_downscale_decisions(
            seg["timestamp"], low, self._eps, self._x, self._y, carry)
        delta = self._delta(plat)
        resident = seg["program_resident"].astype(bool)
        throttled = decisions & resident[None, :]
        power = np.asarray(seg["power"], dtype=np.float64)
        cf = np.where(throttled,
                      np.maximum(power[None, :] - delta[:, None],
                                 plat.deep_idle_w),
                      power[None, :])
        n_cfg = len(pols)
        return BatchEffect(
            power_rows=cf,
            throttled_rows=throttled,
            row_of=np.arange(n_cfg, dtype=np.int64),
            resident_rows=None,
            penalty_partial_s=np.zeros(n_cfg),
            wake_events=n_rest,
            downscale_events=n_down,
        ), carry

    def apply_runs(self, stream, plat: PlatformSpec, min_samples: int,
                   dt_s: float) -> "RunBatchResult":
        """Whole-stream replay against the run axis: O(low runs) decisions
        for the whole family, savings gathered from shared prefix sums —
        no ``(n_configs, n_samples)`` block is ever built."""
        n_cfg = len(self.policies)
        n_down, n_rest, throttled, sav_exec, sav_act = _run_downscale(
            stream, plat, min_samples, dt_s, self._eps, self._x, self._y,
            self._trig, self._delta(plat))
        base = stream.baseline(min_samples)
        return RunBatchResult(
            row_of=np.arange(n_cfg, dtype=np.int64),
            cf_rows=_downscale_breakdowns(base, sav_exec, sav_act, dt_s),
            penalty_partial_s=np.zeros(n_cfg),
            wake_events=n_rest,
            downscale_events=n_down,
            throttled_samples=throttled,
        )


@dataclasses.dataclass(frozen=True)
class ParkingBatch:
    """Every parking config, one pass: a device stream is either parked or
    untouched, and *all* parked configs share one counterfactual row — the
    parked power/residency series is independent of the pool shape and the
    resume latency (which only prices the shared wake count at finalize).
    Members must agree on the low-series thresholds (:func:`make_batches`).
    """

    policies: tuple[ParkingPolicy, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "_pools", tuple(
            (p.pool.n_devices, frozenset(p.pool.active_set()))
            for p in self.policies))

    def init_carry(self) -> ParkCarry:
        return ParkCarry()

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec,
                    carry: ParkCarry,
                    dt_s: float = 1.0) -> tuple[BatchEffect, ParkCarry]:
        n = len(seg)
        n_cfg = len(self.policies)
        dev = int(seg["device_id"][0])
        parked = np.array([dev % nd not in act for nd, act in self._pools],
                          dtype=bool)
        if not parked.any():
            return _identity_effect(n, n_cfg), carry
        low = low_activity_series(seg, self.policies[0].config)
        resident = seg["program_resident"].astype(bool)
        idle = resident & low
        active = resident & ~low
        prev_idle = np.empty(n, dtype=bool)
        prev_idle[0] = carry.prev_idle
        prev_idle[1:] = idle[:-1]
        wakes = int(np.sum(active & prev_idle))
        power = np.asarray(seg["power"], dtype=np.float64)
        return BatchEffect(
            power_rows=np.where(idle, plat.deep_idle_w, power)[None, :],
            throttled_rows=idle[None, :],
            row_of=np.where(parked, 0, -1).astype(np.int64),
            resident_rows=(resident & ~idle)[None, :],
            penalty_partial_s=np.zeros(n_cfg),
            wake_events=np.where(parked, wakes, 0).astype(np.int64),
            downscale_events=np.zeros(n_cfg, dtype=np.int64),
        ), ParkCarry(prev_idle=bool(idle[-1]))

    def apply_runs(self, stream, plat: PlatformSpec, min_samples: int,
                   dt_s: float) -> "RunBatchResult":
        """Run-level parking: the parked counterfactual is pure run algebra
        (idle runs drop to deep-idle power and residency; wakes are
        idle-to-active run adjacencies), and — as in the row path — every
        parked config shares the one counterfactual breakdown."""
        n_cfg = len(self.policies)
        dev = stream.key[2]
        parked = np.array([dev % nd not in act for nd, act in self._pools],
                          dtype=bool)
        if not parked.any():
            return _identity_run_result(n_cfg)
        bd, pk = _parking_breakdown(stream, plat, min_samples, dt_s)
        return RunBatchResult(
            row_of=np.where(parked, 0, -1).astype(np.int64),
            cf_rows=[bd],
            penalty_partial_s=np.zeros(n_cfg),
            wake_events=np.where(parked, pk["wakes"], 0).astype(np.int64),
            downscale_events=np.zeros(n_cfg, dtype=np.int64),
            throttled_samples=np.where(parked, pk["idle_samples"],
                                       0).astype(np.int64),
        )


@dataclasses.dataclass(frozen=True)
class PowerCapBatch:
    """Every cap fraction in one pass: the [C, n] capped power grid is two
    broadcast ops; the per-config cube-law penalty gathers the shared
    active-sample power once and masks it per cap (the one O(configs) loop,
    kept scalar so each config's ``np.sum`` reduces exactly the array the
    scalar policy reduces). Members must agree on the low-series thresholds.
    """

    policies: tuple[PowerCapPolicy, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "_fracs", np.array(
            [p.cap_fraction for p in self.policies]))

    def init_carry(self) -> None:
        return None

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec, carry: None,
                    dt_s: float = 1.0) -> tuple[BatchEffect, None]:
        pols = self.policies
        n_cfg = len(pols)
        power = np.asarray(seg["power"], dtype=np.float64)
        cap_w = self._fracs * plat.tdp_w
        over = power[None, :] > cap_w[:, None]
        cf = np.minimum(power[None, :], cap_w[:, None])
        low = low_activity_series(seg, pols[0].config)
        resident = seg["program_resident"].astype(bool)
        pw_active = power[resident & ~low]
        penalty = np.empty(n_cfg)
        for i in range(n_cfg):
            slow = np.cbrt(pw_active[pw_active > cap_w[i]] / cap_w[i]) - 1.0
            penalty[i] = dt_s * float(np.sum(slow))
        return BatchEffect(
            power_rows=cf,
            throttled_rows=over,
            row_of=np.arange(n_cfg, dtype=np.int64),
            resident_rows=None,
            penalty_partial_s=penalty,
            wake_events=np.zeros(n_cfg, dtype=np.int64),
            downscale_events=np.zeros(n_cfg, dtype=np.int64),
        ), None

    def apply_runs(self, stream, plat: PlatformSpec, min_samples: int,
                   dt_s: float) -> "RunBatchResult":
        """Every cap fraction against sorted-power prefix structures: a
        cap's clipped energy, throttle count and cube-law penalty are each
        one vectorized ``searchsorted`` per accounting bucket — O(log n)
        per config after a shared O(n log n) build, instead of an
        O(n_samples) ``minimum``/``cbrt`` pass per config."""
        n_cfg = len(self.policies)
        caps = self._fracs * plat.tdp_w
        buckets = stream.cap_buckets(min_samples)
        base = stream.baseline(min_samples)
        throttled = np.zeros(n_cfg, dtype=np.int64)
        energy_cf: dict[DeviceState, np.ndarray] = {}
        for s in DeviceState:
            sorted_p, top_sum = buckets[int(s)]
            k = sorted_p.shape[0] - np.searchsorted(sorted_p, caps,
                                                    side="right")
            energy_cf[s] = base.energy_j[s] - (top_sum[k] - k * caps) * dt_s
            throttled += k
        sorted_p, _, top_cbrt = buckets["penalty"]
        kp = sorted_p.shape[0] - np.searchsorted(sorted_p, caps, side="right")
        penalty = dt_s * (top_cbrt[kp] / np.cbrt(caps) - kp)
        cf_rows = [
            EnergyBreakdown(
                time_s=base.time_s,
                energy_j={s: float(energy_cf[s][c]) for s in DeviceState})
            for c in range(n_cfg)
        ]
        return RunBatchResult(
            row_of=np.arange(n_cfg, dtype=np.int64),
            cf_rows=cf_rows,
            penalty_partial_s=penalty,
            wake_events=np.zeros(n_cfg, dtype=np.int64),
            downscale_events=np.zeros(n_cfg, dtype=np.int64),
            throttled_samples=throttled,
        )


@dataclasses.dataclass(frozen=True)
class FallbackBatch:
    """Config axis of one: any :class:`Policy` implementation, replayed via
    its own scalar ``apply``. Keeps the batched replayer total over arbitrary
    grids — unknown policy types lose the sharing, not correctness.
    """

    policies: tuple[Policy, ...]     # always length 1

    def init_carry(self) -> Any:
        return self.policies[0].init_carry()

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec, carry: Any,
                    dt_s: float = 1.0) -> tuple[BatchEffect, Any]:
        effect, carry = self.policies[0].apply(seg, plat, carry, dt_s=dt_s)
        # always report a residency row (recorded residency when the policy
        # leaves it unchanged): a custom policy may alternate between None
        # and an override across segments, and the replayer requires a
        # stream-stable row structure. Classifying the recorded residency
        # reproduces the baseline states exactly, so this costs one extra
        # classification, never correctness.
        resident = (seg["program_resident"].astype(bool)
                    if effect.resident is None else effect.resident)
        return BatchEffect(
            power_rows=np.asarray(effect.power_w, dtype=np.float64)[None, :],
            throttled_rows=np.asarray(effect.throttled, dtype=bool)[None, :],
            row_of=np.zeros(1, dtype=np.int64),
            resident_rows=np.asarray(resident, dtype=bool)[None, :],
            penalty_partial_s=np.array([effect.penalty_partial_s]),
            wake_events=np.array([effect.wake_events], dtype=np.int64),
            downscale_events=np.array([effect.downscale_events],
                                      dtype=np.int64),
            events_rows=(None if effect.events is None
                         else effect.events[None, :]),
        ), carry


@dataclasses.dataclass(frozen=True)
class CompositeBatch:
    """Config axis over composites sharing one part structure.

    Members apply their parts sequentially through the scalar
    :meth:`CompositePolicy.apply` (each member's downstream parts see *that
    member's* intermediate counterfactual, so their series differ per member
    and cannot share rows), but the batch still rides the replayer's shared
    per-segment work: one stream grouping, one baseline classification and
    integration, and one low-activity series per distinct threshold pair —
    the memo in :func:`low_activity_series` is shared across members and
    parts via :func:`repro_torch.whatif.effects.effect_view`. Bit-identical to
    sequential scalar application (tests/test_whatif_effects.py).

    Residency rows are reported only when some member actually overrides
    residency on this stream; when every part is a known leaf family that
    decision is stream-stable (parking is the only resident-changer and its
    parked set is device-keyed), so streams on never-parked devices — the
    majority under k-of-n pools — keep the replayer's shared classification
    and config-axis integrator instead of one reclassification per member.
    Composites containing *unknown* part types always materialize residency
    rows, like :class:`FallbackBatch` (a custom part may alternate between
    None and an override across segments, and the replayer requires a
    stream-stable row structure).
    """

    policies: tuple[CompositePolicy, ...]

    def __post_init__(self) -> None:
        def stable(policy) -> bool:
            if isinstance(policy, CompositePolicy):
                return all(stable(p) for p in policy.parts)
            return isinstance(policy, (NoOpPolicy, DownscalePolicy,
                                       ParkingPolicy, PowerCapPolicy))
        object.__setattr__(self, "_stable_residency",
                           all(stable(p) for p in self.policies))
        # run-level (IR) support: exactly the parking-then-downscale shape,
        # whose parts act on disjoint residency (see apply_runs)
        ir_ok = all(
            len(p.parts) == 2
            and isinstance(p.parts[0], ParkingPolicy)
            and isinstance(p.parts[1], DownscalePolicy)
            for p in self.policies)
        object.__setattr__(self, "_ir_ok", ir_ok)
        if ir_ok:
            object.__setattr__(self, "_park_pools", tuple(
                (p.parts[0].pool.n_devices,
                 frozenset(p.parts[0].pool.active_set()))
                for p in self.policies))
            # reuse DownscaleBatch's knob-array / trigger / delta-cache
            # precomputation for the downscale parts (one member each)
            object.__setattr__(self, "_ds_batch", DownscaleBatch(
                tuple(p.parts[1] for p in self.policies)))

    def apply_runs(self, stream, plat: PlatformSpec, min_samples: int,
                   dt_s: float) -> "RunBatchResult":
        """Run-level park-then-downscale: the two parts touch disjoint
        residency, so the composite decomposes exactly on the run axis.

        On a stream a member parks, idle samples lose residency, and the
        downstream downscale's ``throttled = decisions & resident`` is
        empty (decisions are true only on low samples, which are exactly
        the evicted ones) — parking's counterfactual IS the member's
        counterfactual there, while the Algorithm-1 decision sequence (and
        its restore events) is unchanged because the low-activity predicate
        reads only signal columns. On unparked streams parking is the
        identity and the member degenerates to its downscale part. Both
        cases are pure run algebra; each part prices its own event channel
        as in the row path.
        """
        if not self._ir_ok:
            raise ValueError(
                "run-level replay supports only parking+downscale "
                "composites; route this batch through the row path")
        n_cfg = len(self.policies)
        dev = stream.key[2]
        parked = np.array([dev % nd not in act for nd, act in
                           self._park_pools], dtype=bool)
        ds = self._ds_batch
        n_down, n_rest, ds_throttled, sav_exec, sav_act = _run_downscale(
            stream, plat, min_samples, dt_s, ds._eps, ds._x, ds._y,
            ds._trig, ds._delta(plat))
        base = stream.baseline(min_samples)
        ds_rows = _downscale_breakdowns(base, sav_exec, sav_act, dt_s)
        park_wakes = np.zeros(n_cfg, dtype=np.int64)
        if parked.any():
            park_bd, pk = _parking_breakdown(stream, plat, min_samples, dt_s)
            park_wakes = np.where(parked, pk["wakes"], 0).astype(np.int64)
            throttled = np.where(parked, pk["idle_samples"], ds_throttled)
            cf_rows = [park_bd if parked[c] else ds_rows[c]
                       for c in range(n_cfg)]
        else:
            throttled = ds_throttled
            cf_rows = ds_rows
        events = np.stack([park_wakes, n_rest], axis=1)
        return RunBatchResult(
            row_of=np.arange(n_cfg, dtype=np.int64),
            cf_rows=cf_rows,
            penalty_partial_s=np.zeros(n_cfg),
            wake_events=park_wakes + n_rest,
            downscale_events=n_down,
            throttled_samples=throttled.astype(np.int64),
            events_rows=events.astype(np.int64),
        )

    def init_carry(self) -> list:
        return [p.init_carry() for p in self.policies]

    def apply_batch(self, seg: TelemetryFrame, plat: PlatformSpec,
                    carry: list,
                    dt_s: float = 1.0) -> tuple[BatchEffect, list]:
        n = len(seg)
        n_cfg = len(self.policies)
        n_ch = self.policies[0].n_event_channels
        power_rows = np.empty((n_cfg, n))
        throttled_rows = np.empty((n_cfg, n), dtype=bool)
        events_rows = np.empty((n_cfg, n_ch), dtype=np.int64)
        partials = np.empty(n_cfg)
        wakes = np.empty(n_cfg, dtype=np.int64)
        downs = np.empty(n_cfg, dtype=np.int64)
        out_carries = []
        effects = []
        for i, (pol, c) in enumerate(zip(self.policies, carry)):
            eff, c2 = pol.apply(seg, plat, c, dt_s=dt_s)
            out_carries.append(c2)
            effects.append(eff)
            power_rows[i] = eff.power_w
            throttled_rows[i] = eff.throttled
            events_rows[i] = eff.events
            partials[i] = eff.penalty_partial_s
            wakes[i] = eff.wake_events
            downs[i] = eff.downscale_events
        if self._stable_residency and all(e.resident is None for e in effects):
            resident_rows = None
        else:
            resident_rows = np.empty((n_cfg, n), dtype=bool)
            rec_resident = seg["program_resident"].astype(bool)
            for i, eff in enumerate(effects):
                resident_rows[i] = (rec_resident if eff.resident is None
                                    else eff.resident)
        return BatchEffect(
            power_rows=power_rows,
            throttled_rows=throttled_rows,
            row_of=np.arange(n_cfg, dtype=np.int64),
            resident_rows=resident_rows,
            penalty_partial_s=partials,
            wake_events=wakes,
            downscale_events=downs,
            events_rows=events_rows,
        ), out_carries


# --------------------------------------------------------------------------- #
# Run-level evaluators (the IR fast path; see repro_torch.whatif.ir)
# --------------------------------------------------------------------------- #
#: a trigger index past any run: Algorithm 1 never fires (also pads a
#: config axis with configs that change nothing)
NEVER_TRIGGERS = 1 << 62


@functools.lru_cache(maxsize=65536)
def downscale_trigger_index(eps: float, x: float) -> int:
    """Samples of consecutive low activity before Algorithm 1 triggers.

    Equals the number of strict left-fold additions of ``eps`` (from
    ``c = 0.0``) whose accumulator stays ``<= x`` — the same float sequence
    ``np.add.accumulate`` produces in :func:`downscale_decisions`, so the
    trigger lands on the same sample bit-for-bit. In a whole-stream replay
    every low run starts from ``c = 0`` (any activity resets the
    accumulator), so this index is a *constant per config*: the run-level
    replay never materializes the accumulator series at all. Returns a
    sentinel larger than any run when the accumulator saturates below
    ``x`` (it can then never trigger, exactly as the scalar recurrence).
    """
    c = 0.0
    k = 0
    while True:
        nxt = c + eps
        if nxt > x:
            return k
        if nxt == c:
            return NEVER_TRIGGERS
        c = nxt
        k += 1


def _trigger_indices(eps: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.array([downscale_trigger_index(float(e), float(xx))
                     for e, xx in zip(eps, x)], dtype=np.int64)


@dataclasses.dataclass
class RunBatchResult:
    """One family batch's counterfactual for one IR *stream*.

    The run-level analogue of :class:`~repro_torch.whatif.effects.BatchEffect`
    with the integration already folded: distinct counterfactual
    :class:`~repro_torch.core.energy.EnergyBreakdown` rows instead of power rows
    (``row_of[c] == -1`` aliases the shared baseline breakdown), exact
    integer event/throttle counts, and per-config penalty partials.
    """

    row_of: np.ndarray               # [C] -> index into cf_rows, -1 = baseline
    cf_rows: list                    # distinct counterfactual breakdowns
    penalty_partial_s: np.ndarray    # [C] sample-proportional penalties
    wake_events: np.ndarray          # [C] int
    downscale_events: np.ndarray     # [C] int
    throttled_samples: np.ndarray    # [C] int
    events_rows: np.ndarray | None = None   # [C, K] multi-channel counts


def _identity_run_result(n_configs: int) -> RunBatchResult:
    return RunBatchResult(
        row_of=np.full(n_configs, -1, dtype=np.int64),
        cf_rows=[],
        penalty_partial_s=np.zeros(n_configs),
        wake_events=np.zeros(n_configs, dtype=np.int64),
        downscale_events=np.zeros(n_configs, dtype=np.int64),
        throttled_samples=np.zeros(n_configs, dtype=np.int64),
    )


def _run_downscale(stream, plat: PlatformSpec, min_samples: int, dt_s: float,
                   eps: np.ndarray, x: np.ndarray, y: np.ndarray,
                   trig: np.ndarray, deltas: np.ndarray):
    """Config-axis Algorithm-1 replay over one stream's *low-activity runs*.

    The run-level core shared by :meth:`DownscaleBatch.apply_runs` and
    :meth:`CompositeBatch.apply_runs`: O(low runs) Python for the whole
    config axis, with per-run vector ops — no per-sample decision series is
    ever materialized. Per low run the trigger index is
    ``max(trigger_index, cooldown searchsorted)`` exactly as the row
    kernels compute it; restores (and their cooldown stamps) land on the
    busy run separating consecutive low runs. Savings are gathered from the
    stream's precomputed per-sample clip-saving prefix sums, bucketed by
    accounting state.

    Returns ``(n_down, n_rest, throttled, sav_exec, sav_active)``, each
    ``[C]``: exact event/sample counts, savings in W·samples.
    """
    n_cfg = eps.shape[0]
    n_down = np.zeros(n_cfg, dtype=np.int64)
    n_rest = np.zeros(n_cfg, dtype=np.int64)
    throttled = np.zeros(n_cfg, dtype=np.int64)
    sav_exec = np.zeros(n_cfg)
    sav_act = np.zeros(n_cfg)
    off, low_flags = stream.controller_runs()
    low_j = np.flatnonzero(low_flags)
    n_low = low_j.size
    if n_low == 0:
        return n_down, n_rest, throttled, sav_exec, sav_act

    s0s = off[low_j]
    e0s = off[low_j + 1]
    lens = e0s - s0s
    ts0s = stream.ts_first + dt_s * s0s.astype(np.float64)
    # runs are contiguous, so the busy run following low run k starts at
    # the low run's end sample — where its restores (and cooldown clocks)
    # land; this matches float(ts[off]) of the row kernels bit-for-bit
    busy_after = stream.ts_first + dt_s * e0s.astype(np.float64)

    # phase 1 — history-free decisions for the whole (run x config) grid:
    # with c = 0 at every low-run start, a config fires iff the run outlives
    # its trigger index. Cooldown can only *suppress* some of these.
    fire = lens[:, None] > trig[None, :]                   # [K, C]
    # cooldown from a fire before run k reaches into run k only if the busy
    # run right before k is shorter than the largest cooldown: t_cd <=
    # busy_after[k-1] + max(y), so a longer busy gap clears every config
    risky = np.zeros(n_low, dtype=bool)
    risky[1:] = (ts0s[1:] - busy_after[:-1]) < float(y.max())

    # phase 2 — resolve cooldown suppression sequentially. Only *risky*
    # runs (busy gap shorter than the family's largest cooldown) can have
    # phase-1 fires suppressed: with none, every trigger index is the
    # family constant ``trig`` and the whole sequential pass is skipped.
    # Inside the loop, only risky runs with a recent fire pay for the
    # searchsorted (exact row-kernel trigger index)
    i_rows: dict[int, np.ndarray] = {}
    if risky.any():
        last_fire = np.full(n_cfg, -1, dtype=np.int64)
        any_fire = False
        ts_full = None
        for k in range(n_low):
            if any_fire and risky[k]:
                t_cd = np.where(last_fire >= 0,
                                busy_after[np.maximum(last_fire, 0)] + y,
                                -np.inf)
                aff = t_cd > ts0s[k]
                if aff.any():
                    if ts_full is None:
                        ts_full = stream.ts()
                    # configs whose cooldown ends at or before the run start
                    # keep the phase-1 trigger index: searchsorted would
                    # return 0 and max(trig, 0) == trig, so only the
                    # affected subset pays
                    i_row = trig.copy()
                    i_row[aff] = np.maximum(trig[aff], np.searchsorted(
                        ts_full[s0s[k]:e0s[k]], t_cd[aff], side="left"))
                    fire[k] &= i_row < lens[k]
                    i_rows[k] = i_row
            row = fire[k]
            if row.any():
                any_fire = True
                np.copyto(last_fire, k, where=row)

    # phase 3 — bulk event counts and prefix-sum gathers over [K, C]
    n_down = fire.sum(axis=0).astype(np.int64)
    n_rest = n_down.copy()
    if int(low_j[-1]) == low_flags.shape[0] - 1:
        # a trailing fired low run never restores (no busy run follows)
        n_rest -= fire[-1]
    trig_i = np.broadcast_to(trig, (n_low, n_cfg))
    if i_rows:
        trig_i = trig_i.copy()
        for k, i_row in i_rows.items():
            trig_i[k] = i_row
    gpos = s0s[:, None] + np.where(fire, trig_i, 0)
    cum_res = stream.cum_resident()
    throttled = np.where(fire, cum_res[e0s][:, None] - cum_res[gpos],
                         0).sum(axis=0)
    for d in np.unique(deltas):
        cfg_idx = np.flatnonzero(deltas == d)
        cum_e, cum_a = stream.downscale_cums(float(d), plat.deep_idle_w,
                                             min_samples)
        sub_f = fire[:, cfg_idx]
        sub_g = gpos[:, cfg_idx]
        sav_exec[cfg_idx] = np.where(
            sub_f, cum_e[e0s][:, None] - cum_e[sub_g], 0.0).sum(axis=0)
        sav_act[cfg_idx] = np.where(
            sub_f, cum_a[e0s][:, None] - cum_a[sub_g], 0.0).sum(axis=0)
    return n_down, n_rest, throttled, sav_exec, sav_act


def _downscale_breakdowns(base: EnergyBreakdown, sav_exec: np.ndarray,
                          sav_act: np.ndarray, dt_s: float) -> list:
    """Per-config counterfactual breakdowns: downscaling never changes the
    state series, so times are the baseline's and only the EXECUTION_IDLE /
    ACTIVE energy buckets shed the clipped savings."""
    out = []
    for c in range(sav_exec.shape[0]):
        energy = dict(base.energy_j)
        energy[DeviceState.EXECUTION_IDLE] -= sav_exec[c] * dt_s
        energy[DeviceState.ACTIVE] -= sav_act[c] * dt_s
        out.append(EnergyBreakdown(time_s=base.time_s, energy_j=energy))
    return out


def _parking_breakdown(stream, plat: PlatformSpec, min_samples: int,
                       dt_s: float) -> tuple[EnergyBreakdown, dict]:
    """The single counterfactual breakdown every parked config shares."""
    pk = stream.parking_counterfactual(min_samples)
    energy = pk["keep_sum"] + pk["idle_len"] * plat.deep_idle_w
    bd = integrate_runs(pk["cf_state"], energy[None, :], stream.length,
                        min_samples, dt_s)[0]
    return bd, pk


def _part_structure(policy: Policy) -> tuple:
    """Recursive part-type signature of a composite — members of one
    :class:`CompositeBatch` must share it so their event-channel layouts
    (and hence the batch's rectangular ``events_rows``) line up."""
    if isinstance(policy, CompositePolicy):
        return tuple(_part_structure(p) for p in policy.parts)
    return (type(policy).__name__,)


def _batch_key(policy: Policy, index: int) -> tuple:
    """Family grouping key: policies sharing a key batch together. Downscale /
    parking / powercap group by their low-activity thresholds (the shared
    per-segment precompute); composites group by part structure; anything
    else stays a singleton."""
    if isinstance(policy, DownscalePolicy):
        cfg = policy.config
        return ("downscale", cfg.activity_threshold, cfg.comm_threshold_gbs)
    if isinstance(policy, ParkingPolicy):
        cfg = policy.config
        return ("parking", cfg.activity_threshold, cfg.comm_threshold_gbs)
    if isinstance(policy, PowerCapPolicy):
        cfg = policy.config
        return ("powercap", cfg.activity_threshold, cfg.comm_threshold_gbs)
    if isinstance(policy, NoOpPolicy):
        return ("noop",)
    if isinstance(policy, CompositePolicy):
        return ("composite", _part_structure(policy))
    return ("other", index)


_BATCH_TYPES = {"downscale": DownscaleBatch, "parking": ParkingBatch,
                "powercap": PowerCapBatch, "noop": NoOpBatch,
                "composite": CompositeBatch, "other": FallbackBatch}


def make_batches(
    policies: Sequence[Policy],
) -> list[tuple[PolicyBatch, list[int]]]:
    """Group a policy grid into family batches for the config-axis replay.

    Returns ``(batch, grid_indices)`` pairs in first-occurrence order;
    ``grid_indices`` maps each batch member back to its position in the
    input grid (order-preserving within a batch), so sweep results can be
    reassembled in grid order.
    """
    grouped: dict[tuple, list[int]] = {}
    for i, p in enumerate(policies):
        grouped.setdefault(_batch_key(p, i), []).append(i)
    out: list[tuple[PolicyBatch, list[int]]] = []
    for key, idxs in grouped.items():
        batch_cls = _BATCH_TYPES[key[0]]
        out.append((batch_cls(tuple(policies[i] for i in idxs)), idxs))
    return out
