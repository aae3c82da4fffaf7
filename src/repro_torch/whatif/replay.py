"""Counterfactual replay of policies over stored telemetry.

:class:`BatchedPolicyReplayer` is the what-if analogue of
:class:`repro_torch.telemetry.pipeline.FleetAccumulator`: feed time-ordered
chunks (storage shards, simulator chunks, DES frames) of any size, finalize
once. It replays a whole policy *grid* along a config axis: per (job, host,
device) stream, one shared classification / run-length encoding / baseline
integration per segment, each policy family evaluated as a
``(n_configs, n_samples)`` block with its carry crossing chunk boundaries,
power re-priced via the platform's
:class:`repro_torch.core.power_model.PlatformSpec`. It is the row path: the
oracle of the run-level replay :func:`replay_ir` and the NumPy backend's
route for configs the IR cannot carry.

Penalties: event-priced penalties (downscale restores, parking wakes) are
integer counts priced once at finalize, so they are chunking-invariant too.
Policies with several pricing channels (composites — see
:mod:`repro_torch.whatif.effects`) carry a per-channel count vector and are priced
per channel, each part's events at that part's own per-event cost.
Sample-proportional penalties (power capping) are per-chunk ``np.sum``
partials ``math.fsum``'d at finalize: exact for any *fixed* chunking, but,
like ``FleetAccumulator.unattributed_energy_j``, they may differ in the
last ulp between *different* chunkings of one stream.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.energy import (BatchedStreamingIntegrator, EnergyBreakdown,
                                     StreamingIntegrator, merge)
from repro_torch.core.power_model import PlatformSpec, get_platform
from repro_torch.core.states import (ClassifierConfig, DEFAULT_CLASSIFIER,
                                     DeviceState, classify_series)
from repro_torch.telemetry.records import TelemetryFrame
from repro_torch.whatif.effects import policy_event_prices, price_events
from repro_torch.whatif.policies import Policy, PolicyBatch, make_batches


def _default_platform_ids() -> dict[int, str]:
    from repro_torch.cluster.simulator import PLATFORM_IDS
    return {i: name for name, i in PLATFORM_IDS.items()}


def _resolve_platform(
    platform_of: str | Mapping[int, str] | None,
    cache: dict[int, PlatformSpec],
    platform_id: int,
) -> PlatformSpec:
    """Shared ``platform`` column resolution: None uses the cluster
    simulator's interning, a str forces one platform for every stream (e.g.
    DES output), a mapping gives explicit id -> name."""
    plat = cache.get(platform_id)
    if plat is None:
        if isinstance(platform_of, str):
            plat = get_platform(platform_of)
        else:
            table = (platform_of if platform_of is not None
                     else _default_platform_ids())
            plat = get_platform(table[platform_id])
        cache[platform_id] = plat
    return plat


@dataclasses.dataclass(frozen=True)
class JobReplay:
    """One stream's recorded vs counterfactual accounting."""

    job_id: int
    platform: str
    duration_s: float
    baseline: EnergyBreakdown
    counterfactual: EnergyBreakdown
    penalty_s: float
    wake_events: int
    downscale_events: int
    throttled_time_s: float

    @property
    def energy_saved_j(self) -> float:
        return self.baseline.total_energy_j - self.counterfactual.total_energy_j

    @property
    def saved_fraction(self) -> float:
        base = self.baseline.total_energy_j
        return self.energy_saved_j / base if base else 0.0

    @property
    def penalty_fraction(self) -> float:
        """Perf penalty relative to the job's recorded active time."""
        active = self.baseline.time_s[DeviceState.ACTIVE]
        return self.penalty_s / active if active else 0.0


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """Fleet-level outcome of replaying one policy config."""

    policy_name: str
    policy_params: dict
    jobs: list[JobReplay]
    baseline: EnergyBreakdown
    counterfactual: EnergyBreakdown
    penalty_s: float
    wake_events: int
    downscale_events: int
    throttled_time_s: float
    n_rows: int

    @property
    def energy_saved_j(self) -> float:
        return self.baseline.total_energy_j - self.counterfactual.total_energy_j

    @property
    def saved_fraction(self) -> float:
        base = self.baseline.total_energy_j
        return self.energy_saved_j / base if base else 0.0

    @property
    def penalty_fraction(self) -> float:
        active = self.baseline.time_s[DeviceState.ACTIVE]
        return self.penalty_s / active if active else 0.0


# --------------------------------------------------------------------------- #
# Config-axis batched replay
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _BatchState:
    """Per-(stream, batch) partial replay state carried across chunks.

    ``row_of`` (config -> counterfactual row, -1 = identity) is fixed by the
    stream's first segment and must stay stable — it only depends on
    stream-constant inputs (device id, thresholds), which is validated on
    every subsequent segment.
    """

    carry: Any
    row_of: np.ndarray | None = None
    cf: BatchedStreamingIntegrator | None = None       # rows on baseline states
    cf_rows: list[StreamingIntegrator] | None = None   # rows with own residency
    penalty_partials: list[np.ndarray] = dataclasses.field(default_factory=list)
    wake_events: np.ndarray | None = None              # [C_b] int
    downscale_events: np.ndarray | None = None         # [C_b] int
    throttled_counts: np.ndarray | None = None         # [R] int, per row
    events: np.ndarray | None = None                   # [C_b, K] int (composites)


@dataclasses.dataclass
class _BatchedGroup:
    """Per-(job, host, device) partial state for the whole grid: ONE baseline
    integration shared by every config, plus one :class:`_BatchState` per
    family batch."""

    base: StreamingIntegrator
    batch_states: list[_BatchState]
    platform_id: int
    n_rows: int = 0
    ts_first: float = math.inf
    ts_last: float = -math.inf


class BatchedPolicyReplayer:
    """Replay an entire policy grid in one pass per stream segment.

    The grid is grouped into family batches
    (:func:`repro_torch.whatif.policies.make_batches`), and each stream segment is
    processed once — one lexsort grouping (in :meth:`update`), one baseline
    classification, one idle run-length encoding / low-activity series (the
    segment-level cache in :func:`~repro_torch.whatif.policies.low_activity_series`),
    and one baseline power integration — with every family evaluated as a
    ``(n_configs, n_samples)`` block. Per-config carry state crosses chunk
    boundaries, so results are bit-identical for any chunking. Samples with
    ``job_id < 0`` (unallocated deep idle) pass through untouched: policies
    mitigate *jobs*.

    ``finalize`` returns one :class:`ReplayResult` per policy, in grid order.
    """

    def __init__(
        self,
        policies: Sequence[Policy],
        platform_of: str | Mapping[int, str] | None = None,
        min_job_duration_s: float = 2 * 3600.0,
        min_interval_s: float = 5.0,
        classifier: ClassifierConfig = DEFAULT_CLASSIFIER,
        dt_s: float = 1.0,
    ):
        self.policies = list(policies)
        self.platform_of = platform_of
        self.min_job_duration_s = min_job_duration_s
        self.min_interval_s = min_interval_s
        self.classifier = classifier
        self.dt_s = dt_s
        self._batches: list[tuple[PolicyBatch, list[int]]] = make_batches(
            self.policies)
        self._groups: dict[tuple[int, int, int], _BatchedGroup] = {}
        self._plat_cache: dict[int, PlatformSpec] = {}
        self.n_rows = 0

    def _platform(self, platform_id: int) -> PlatformSpec:
        return _resolve_platform(self.platform_of, self._plat_cache,
                                 platform_id)

    # ------------------------------------------------------------------ #
    def update(self, chunk: TelemetryFrame) -> None:
        """Fold one chunk of telemetry into the running grid replay."""
        if len(chunk) == 0:
            return
        for key, seg in chunk.group_streams():
            if key[0] < 0:
                continue
            self._update_segment(key, seg)

    def _new_integrator(self, n_configs: int | None = None):
        """Scalar integrator (1-D power) by default; a config-axis one for
        row blocks when ``n_configs`` is given (even ``n_configs=1`` — row
        blocks are always 2-D)."""
        if n_configs is None:
            return StreamingIntegrator(
                min_duration_s=self.min_interval_s, dt_s=self.dt_s)
        return BatchedStreamingIntegrator(
            n_configs=n_configs, min_duration_s=self.min_interval_s,
            dt_s=self.dt_s)

    def _update_segment(self, key: tuple[int, int, int],
                        seg: TelemetryFrame) -> None:
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = _BatchedGroup(
                base=self._new_integrator(),
                batch_states=[_BatchState(carry=batch.init_carry())
                              for batch, _ in self._batches],
                platform_id=int(seg["platform"][0]),
            )
        ts = seg["timestamp"]
        if float(ts[0]) < g.ts_last:
            raise ValueError(
                f"chunks for stream {key} are not time-ordered: got "
                f"t={float(ts[0])} after t={g.ts_last}")
        g.ts_first = min(g.ts_first, float(ts[0]))
        g.ts_last = float(ts[-1])
        g.n_rows += len(seg)
        self.n_rows += len(seg)

        states = classify_series(
            seg["program_resident"].astype(bool),
            seg.activity_pct(),
            seg.comm_gbs(),
            self.classifier,
        )
        plat = self._platform(g.platform_id)
        g.base.update(states, seg["power"])
        for (batch, idxs), bs in zip(self._batches, g.batch_states):
            effect, bs.carry = batch.apply_batch(seg, plat, bs.carry,
                                                 dt_s=self.dt_s)
            n_rows_cf = effect.power_rows.shape[0]
            if bs.row_of is None:
                bs.row_of = effect.row_of
                bs.wake_events = np.zeros(len(idxs), dtype=np.int64)
                bs.downscale_events = np.zeros(len(idxs), dtype=np.int64)
                bs.throttled_counts = np.zeros(n_rows_cf, dtype=np.int64)
                if n_rows_cf:
                    if effect.resident_rows is None:
                        bs.cf = self._new_integrator(n_rows_cf)
                    else:
                        bs.cf_rows = [self._new_integrator()
                                      for _ in range(n_rows_cf)]
            elif not np.array_equal(bs.row_of, effect.row_of):
                raise ValueError(
                    f"batch {type(batch).__name__} changed its config->row "
                    f"mapping mid-stream for {key}")
            if n_rows_cf:
                if effect.resident_rows is None:
                    if bs.cf_rows is not None:
                        raise ValueError(
                            f"batch {type(batch).__name__} changed residency "
                            f"structure mid-stream for {key}")
                    bs.cf.update(states, effect.power_rows)
                else:
                    if bs.cf is not None:
                        raise ValueError(
                            f"batch {type(batch).__name__} changed residency "
                            f"structure mid-stream for {key}")
                    for r in range(n_rows_cf):
                        cf_states = classify_series(
                            effect.resident_rows[r], seg.activity_pct(),
                            seg.comm_gbs(), self.classifier)
                        bs.cf_rows[r].update(cf_states, effect.power_rows[r])
                bs.throttled_counts += effect.throttled_rows.sum(axis=1)
            bs.penalty_partials.append(effect.penalty_partial_s)
            bs.wake_events += effect.wake_events
            bs.downscale_events += effect.downscale_events
            if effect.events_rows is not None:
                bs.events = (effect.events_rows.copy() if bs.events is None
                             else bs.events + effect.events_rows)

    def finalize(self) -> list[ReplayResult]:
        """Flush carried state; one :class:`ReplayResult` per grid config."""
        n_cfg = len(self.policies)
        jobs: list[list[JobReplay]] = [[] for _ in range(n_cfg)]
        penalty_tot = [0.0] * n_cfg
        wake_tot = [0] * n_cfg
        down_tot = [0] * n_cfg
        throttled_tot = [0] * n_cfg
        for key in sorted(self._groups):
            g = self._groups[key]
            base_bd, _ = g.base.finalize()
            span_s = g.ts_last - g.ts_first + self.dt_s
            plat = self._platform(g.platform_id)
            for (batch, idxs), bs in zip(self._batches, g.batch_states):
                if bs.cf is not None:
                    row_bds, _ = bs.cf.finalize_batch()
                elif bs.cf_rows is not None:
                    row_bds = [r.finalize()[0] for r in bs.cf_rows]
                else:
                    row_bds = []
                if span_s < self.min_job_duration_s:
                    continue
                for j, gi in enumerate(idxs):
                    pol = self.policies[gi]
                    row = int(bs.row_of[j]) if bs.row_of is not None else -1
                    cf_bd = base_bd if row < 0 else row_bds[row]
                    wakes = int(bs.wake_events[j])
                    if bs.events is not None:
                        event_pen = price_events(
                            policy_event_prices(pol, plat), bs.events[j])
                    else:
                        event_pen = wakes * pol.event_penalty_s(plat)
                    penalty = (math.fsum(p[j] for p in bs.penalty_partials)
                               + event_pen)
                    throttled = (0 if row < 0
                                 else int(bs.throttled_counts[row]))
                    jobs[gi].append(JobReplay(
                        job_id=key[0],
                        platform=plat.name,
                        duration_s=float(span_s),
                        baseline=base_bd,
                        counterfactual=cf_bd,
                        penalty_s=penalty,
                        wake_events=wakes,
                        downscale_events=int(bs.downscale_events[j]),
                        throttled_time_s=float(throttled * self.dt_s),
                    ))
                    penalty_tot[gi] += penalty
                    wake_tot[gi] += wakes
                    down_tot[gi] += int(bs.downscale_events[j])
                    throttled_tot[gi] += throttled
        n_rows = self.n_rows
        self._groups.clear()
        self.n_rows = 0
        return [
            ReplayResult(
                policy_name=pol.name,
                policy_params=pol.describe(),
                jobs=jobs[gi],
                baseline=merge([j.baseline for j in jobs[gi]]),
                counterfactual=merge([j.counterfactual for j in jobs[gi]]),
                penalty_s=penalty_tot[gi],
                wake_events=wake_tot[gi],
                downscale_events=down_tot[gi],
                throttled_time_s=float(throttled_tot[gi] * self.dt_s),
                n_rows=n_rows,
            )
            for gi, pol in enumerate(self.policies)
        ]


# --------------------------------------------------------------------------- #
# Run-axis replay (the IR fast path; see repro_torch.whatif.ir)
# --------------------------------------------------------------------------- #
def _replay_ir_streams(
    streams: list,
    policies: Sequence[Policy],
    platform_of: str | Mapping[int, str] | None,
    min_job_duration_s: float,
    min_samples: int,
    dt_s: float,
) -> tuple[list[list[tuple]], int]:
    """Replay a policy grid against a list of :class:`StreamIR` streams.
    Returns ``(jobs_per_config, n_rows)`` where each job entry is
    ``(stream key, throttled samples, JobReplay)``."""
    batches = make_batches(policies)
    plat_cache: dict[int, PlatformSpec] = {}
    n_cfg = len(policies)
    jobs: list[list[tuple]] = [[] for _ in range(n_cfg)]
    n_rows = 0
    for stream in streams:
        n_rows += stream.n_rows
        span_s = stream.ts_last - stream.ts_first + dt_s
        if span_s < min_job_duration_s:
            continue
        plat = _resolve_platform(platform_of, plat_cache, stream.platform_id)
        base_bd = stream.baseline(min_samples)
        for batch, idxs in batches:
            res = batch.apply_runs(stream, plat, min_samples, dt_s)
            for j, gi in enumerate(idxs):
                pol = policies[gi]
                row = int(res.row_of[j])
                cf_bd = base_bd if row < 0 else res.cf_rows[row]
                wakes = int(res.wake_events[j])
                if res.events_rows is not None:
                    event_pen = price_events(
                        policy_event_prices(pol, plat), res.events_rows[j])
                else:
                    event_pen = wakes * pol.event_penalty_s(plat)
                penalty = float(res.penalty_partial_s[j]) + event_pen
                jobs[gi].append((stream.key, int(res.throttled_samples[j]),
                                 JobReplay(
                    job_id=stream.key[0],
                    platform=plat.name,
                    duration_s=float(span_s),
                    baseline=base_bd,
                    counterfactual=cf_bd,
                    penalty_s=penalty,
                    wake_events=wakes,
                    downscale_events=int(res.downscale_events[j]),
                    throttled_time_s=float(res.throttled_samples[j] * dt_s),
                )))
    return jobs, n_rows


def replay_ir(
    ir,
    policies: Sequence[Policy],
    platform_of: str | Mapping[int, str] | None = None,
    min_job_duration_s: float = 2 * 3600.0,
    min_interval_s: float = 5.0,
    classifier: ClassifierConfig = DEFAULT_CLASSIFIER,
    dt_s: float = 1.0,
    hosts: Iterable[str] | None = None,
) -> list[ReplayResult]:
    """Replay a whole policy grid against a :class:`repro_torch.whatif.ir.RunIR`.

    The run-axis counterpart of streaming the store through
    :class:`BatchedPolicyReplayer`: every family evaluates
    ``(n_configs, n_runs)`` blocks via its ``apply_runs`` method, so the
    per-config cost is O(runs), and the only O(rows) work ever done was the
    IR build. Contract vs the row path (tests/test_whatif_ir.py): per-state
    times, event counts, throttled time and decision-derived metrics are
    **bit-identical**; energies and penalties agree to <= 1e-9 relative.

    Every policy must be run-level capable for the IR's config
    (:func:`repro_torch.whatif.ir.ir_supported`); the sweep kernel routes
    unsupported configs through the row path instead.
    """
    if classifier != ir.config.classifier:
        raise ValueError(
            f"IR was built for classifier {ir.config.classifier}, replay "
            f"requested {classifier}; rebuild the IR for it")
    if dt_s != ir.config.dt_s:
        raise ValueError(f"IR dt_s {ir.config.dt_s} != replay dt_s {dt_s}")
    policies = list(policies)
    min_samples = (0 if min_interval_s is None
                   else int(np.ceil(min_interval_s / dt_s)))
    with obs.span("replay_ir.streams", configs=len(policies)):
        jobs, n_rows = _replay_ir_streams(
            ir.select(hosts), policies, platform_of, min_job_duration_s,
            min_samples, dt_s)
    results = []
    base_fleet = None       # the kept-job set is config-independent, so the
    for gi, pol in enumerate(policies):     # fleet baseline merges once
        entries = sorted(jobs[gi], key=lambda kj: kj[0])
        ordered_jobs = [jr for _, _, jr in entries]
        if base_fleet is None:
            base_fleet = merge([j.baseline for j in ordered_jobs])
        results.append(ReplayResult(
            policy_name=pol.name,
            policy_params=pol.describe(),
            jobs=ordered_jobs,
            baseline=base_fleet,
            counterfactual=merge([j.counterfactual for j in ordered_jobs]),
            penalty_s=math.fsum(j.penalty_s for j in ordered_jobs),
            wake_events=sum(j.wake_events for j in ordered_jobs),
            downscale_events=sum(j.downscale_events for j in ordered_jobs),
            throttled_time_s=float(
                sum(t for _, t, _ in entries) * dt_s),
            n_rows=n_rows,
        ))
    return results
