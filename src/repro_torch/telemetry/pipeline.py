"""Alignment + job attribution + analysis entry points (paper §2.1–2.2).

Takes raw telemetry frames (from the cluster simulator, the serving DES, or
live RuntimeSamplers), attributes each sample to a job, classifies states,
and produces per-job / fleet-level :class:`EnergyBreakdown`s — the exact
computation behind the paper's headline 19.7% / 10.7% numbers.

Two entry points share one accounting implementation:

* :func:`analyze_fleet` — monolithic: one in-memory frame, analyzed as a
  single chunk.
* :func:`analyze_store` / :class:`FleetAccumulator` — streaming: chunks of
  any size (e.g. one storage shard at a time) fed through ``update``; per-job
  run state is carried across chunk boundaries, so results are bit-identical
  to the monolithic path while peak memory stays bounded by one chunk.

:func:`analyze_store` additionally fronts both with the **run-level IR**
(:mod:`repro_torch.whatif.ir`, the "One IR to rule the stack" substrate): by
default it acquires the store's :class:`~repro_torch.whatif.ir.RunIR` via
``get_ir`` and reduces run tables instead of re-classifying rows —
O(runs) per pass after the one-off compaction, with per-state times,
durations, interval lists and counts **bit-identical** to the row engine
and energies within float summation order (<= 1e-9 relative; the row path
stays available as the bit-exactness oracle via ``compact=False`` and as
the automatic fallback for irregular or quarantined streams).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import TYPE_CHECKING, Iterable

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.energy import EnergyBreakdown, StreamingIntegrator, integrate, merge
from repro_torch.core.intervals import Interval, extract_intervals
from repro_torch.core.states import ClassifierConfig, DEFAULT_CLASSIFIER, DeviceState, classify_series
from repro_torch.telemetry.records import TelemetryFrame

if TYPE_CHECKING:
    from repro_torch.telemetry.storage import TelemetryStore


@dataclasses.dataclass(frozen=True)
class JobAnalysis:
    job_id: int
    duration_s: float
    states: np.ndarray | None      # None on the streaming path (out-of-core)
    breakdown: EnergyBreakdown
    intervals: list[Interval]
    platform: int = -1             # platform id of the stream's device

    @property
    def exec_idle_time_fraction(self) -> float:
        return self.breakdown.exec_idle_time_fraction

    @property
    def exec_idle_energy_fraction(self) -> float:
        return self.breakdown.exec_idle_energy_fraction


@dataclasses.dataclass(frozen=True)
class FleetAnalysis:
    jobs: list[JobAnalysis]
    fleet: EnergyBreakdown              # job-attributed samples only
    unattributed_energy_j: float        # samples with job_id < 0 (Fig 3a 7%)
    n_intervals: int
    coverage: float = 1.0               # rows analyzed / rows on disk
    skipped: tuple = ()                 # shard skip records (strict=False)
    #: per-platform fleet breakdowns (platform id -> merged breakdown over
    #: that platform's surviving jobs) — the §4 per-platform aggregates
    platforms: dict = dataclasses.field(default_factory=dict)

    @property
    def in_execution_time_fraction(self) -> float:
        return self.fleet.exec_idle_time_fraction

    @property
    def in_execution_energy_fraction(self) -> float:
        return self.fleet.exec_idle_energy_fraction


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


def _platform_breakdowns(jobs: list[JobAnalysis]) -> dict:
    """Per-platform merged breakdowns over the surviving jobs, merged in
    jobs-list order (sorted stream keys on every path, so row- and
    run-level analyses accumulate in the same sequence — bit-identical)."""
    by_platform: dict[int, list[EnergyBreakdown]] = {}
    for j in jobs:
        by_platform.setdefault(j.platform, []).append(j.breakdown)
    return {p: merge(by_platform[p]) for p in sorted(by_platform)}


@dataclasses.dataclass
class _GroupState:
    """Per-(job, host, device) partial state carried across chunks."""

    integrator: StreamingIntegrator
    n_rows: int = 0
    ts_first: float = math.inf
    ts_last: float = -math.inf
    state_pieces: list[np.ndarray] | None = None
    platform: int = -1


class FleetAccumulator:
    """Out-of-core fleet analysis: feed chunks, finalize once.

    Chunks may hold any mix of jobs/hosts/devices and any number of rows;
    the only requirement is that, per (job, host, device) stream, chunks
    arrive in time order (each chunk is internally time-sorted by
    ``TelemetryFrame.group_streams``). Per-job partial state is O(1) per
    group plus the pending power samples of each group's unfinished trailing
    run, so peak memory is bounded by one chunk — never the whole dataset.

    ``finalize`` yields the exact :class:`FleetAnalysis` the monolithic
    :func:`analyze_fleet` computes on the concatenated data (see
    :class:`repro_torch.core.energy.StreamingIntegrator` for why this is
    bit-identical); only ``unattributed_energy_j`` may differ in the last
    ulp, since its partial sums follow the chunk partition.
    """

    def __init__(
        self,
        min_job_duration_s: float = 2 * 3600.0,
        min_interval_s: float = 5.0,
        config: ClassifierConfig = DEFAULT_CLASSIFIER,
        dt_s: float = 1.0,
        keep_states: bool = False,
    ):
        self.min_job_duration_s = min_job_duration_s
        self.min_interval_s = min_interval_s
        self.config = config
        self.dt_s = dt_s
        self.keep_states = keep_states
        self._groups: dict[tuple[int, int, int], _GroupState] = {}
        self._unattributed_pieces: list[float] = []
        self.n_rows = 0
        self.n_chunks = 0

    def update(self, chunk: TelemetryFrame) -> None:
        """Fold one chunk of telemetry into the running analysis."""
        if len(chunk) == 0:
            return
        self.n_chunks += 1
        self.n_rows += len(chunk)
        obs.counter("repro_analyze_rows_total", float(len(chunk)),
                    help="telemetry rows folded into fleet analysis")
        obs.counter("repro_analyze_chunks_total",
                    help="telemetry chunks (shards) folded into fleet analysis")

        job_ids = chunk["job_id"]
        neg = job_ids < 0
        if np.any(neg):
            self._unattributed_pieces.append(float(np.sum(chunk["power"][neg])))

        for key, seg in chunk.group_streams():
            if key[0] < 0:
                continue
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _GroupState(
                    integrator=StreamingIntegrator(
                        min_duration_s=self.min_interval_s, dt_s=self.dt_s),
                    state_pieces=[] if self.keep_states else None,
                    platform=int(seg["platform"][0]),
                )
            ts = seg["timestamp"]
            # `<` (not `<=`): the monolithic path's stable sort accepts
            # duplicate timestamps, and the any-chunking equivalence contract
            # must hold wherever the boundary falls — so an exactly re-fed
            # abutting shard is NOT detectable here; genuine reordering is
            if float(ts[0]) < g.ts_last:
                raise ValueError(
                    f"chunks for stream {key} are not time-ordered: got "
                    f"t={float(ts[0])} after t={g.ts_last}")
            g.ts_first = min(g.ts_first, float(ts[0]))
            g.ts_last = float(ts[-1])
            g.n_rows += len(seg)

            states = classify_series(
                seg["program_resident"].astype(bool),
                seg.activity_pct(),
                seg.comm_gbs(),
                self.config,
            )
            if g.state_pieces is not None:
                g.state_pieces.append(states)
            g.integrator.update(states, seg["power"])

    def finalize(self) -> FleetAnalysis:
        """Flush carried run state and assemble the :class:`FleetAnalysis`."""
        jobs: list[JobAnalysis] = []
        for key in sorted(self._groups):
            g = self._groups[key]
            breakdown, intervals = g.integrator.finalize()
            # duration by timestamp span (+dt for the last sample), NOT row
            # count — row count only equals seconds at exactly 1 Hz
            span_s = g.ts_last - g.ts_first + self.dt_s
            if span_s < self.min_job_duration_s:
                continue
            states = (np.concatenate(g.state_pieces)
                      if g.state_pieces is not None else None)
            jobs.append(JobAnalysis(
                job_id=key[0],
                duration_s=float(span_s),
                states=states,
                breakdown=breakdown,
                intervals=intervals,
                platform=g.platform,
            ))
        unattributed = math.fsum(self._unattributed_pieces)
        # clear ALL accumulated state, not just groups — a reused accumulator
        # must start from zero, never mix epochs
        self._groups.clear()
        self._unattributed_pieces.clear()
        self.n_rows = 0
        self.n_chunks = 0
        fleet = merge([j.breakdown for j in jobs])
        return FleetAnalysis(
            jobs=jobs,
            fleet=fleet,
            unattributed_energy_j=unattributed,
            n_intervals=sum(len(j.intervals) for j in jobs),
            platforms=_platform_breakdowns(jobs),
        )


def analyze_fleet(
    frame: TelemetryFrame,
    min_job_duration_s: float = 2 * 3600.0,
    min_interval_s: float = 5.0,
    config: ClassifierConfig = DEFAULT_CLASSIFIER,
    dt_s: float = 1.0,
) -> FleetAnalysis:
    """Group samples by (job, host, device) stream and analyze each (§2.1).

    Monolithic entry point: the whole frame as one chunk through
    :class:`FleetAccumulator` (single lexsort-based grouping pass — not a
    boolean mask per group). Jobs whose timestamp span is shorter than
    ``min_job_duration_s`` are excluded (the paper's ≥2 h long-job filter);
    samples with job_id < 0 count as unattributed.
    """
    acc = FleetAccumulator(
        min_job_duration_s=min_job_duration_s,
        min_interval_s=min_interval_s,
        config=config,
        dt_s=dt_s,
        keep_states=True,
    )
    acc.update(frame)
    return acc.finalize()


def _analyze_ir(ir, hosts, min_job_duration_s: float,
                min_interval_s: float | None, dt_s: float) -> FleetAnalysis:
    """Run-algebra fleet analysis over a prebuilt :class:`RunIR`.

    Per stream, per-state occupancy, execution-idle intervals and the
    §2.2 sustain relabel reduce over the run table
    (:func:`repro_torch.core.energy.integrate_runs_with_intervals`) instead of
    re-classifying rows. Contract vs the row engine on the same data:
    per-state times, job durations, interval bounds/counts and the
    per-platform grouping are **bit-identical** (integer sample sums and
    timestamp arithmetic over the same scalar ops); energies agree within
    float summation order; ``unattributed_energy_j`` is exactly equal
    (``math.fsum`` over the same per-chunk partials). Coverage/skip
    accounting is the caller's job (:func:`analyze_store`).
    """
    min_samples = (0 if min_interval_s is None
                   else int(np.ceil(min_interval_s / dt_s)))
    host_set = set(hosts) if hosts is not None else None
    jobs: list[JobAnalysis] = []
    for s in ir.select(hosts):
        # same duration arithmetic as the row path: the reconstructed
        # ts_last bit-equals the recorded column (regularity is validated
        # at IR build time), so the span filter cannot diverge
        span_s = s.ts_last - s.ts_first + dt_s
        if span_s < min_job_duration_s:
            continue
        from repro_torch.core.energy import integrate_runs_with_intervals
        breakdowns, intervals = integrate_runs_with_intervals(
            s.state, s.power_sum[None, :], s.length, min_samples, dt_s)
        jobs.append(JobAnalysis(
            job_id=s.key[0],
            duration_s=float(span_s),
            states=None,
            breakdown=breakdowns[0],
            intervals=intervals,
            platform=s.platform_id,
        ))
    unattributed = math.fsum(
        v for h, v in ir.unattributed
        if host_set is None or h in host_set)
    fleet = merge([j.breakdown for j in jobs])
    return FleetAnalysis(
        jobs=jobs,
        fleet=fleet,
        unattributed_energy_j=unattributed,
        n_intervals=sum(len(j.intervals) for j in jobs),
        platforms=_platform_breakdowns(jobs),
    )


def analyze_store(
    store: "TelemetryStore",
    hosts: Iterable[str] | None = None,
    min_job_duration_s: float = 2 * 3600.0,
    min_interval_s: float = 5.0,
    config: ClassifierConfig = DEFAULT_CLASSIFIER,
    dt_s: float = 1.0,
    strict: bool = True,
    compact: bool | None = None,
    ir=None,
) -> FleetAnalysis:
    """Streaming fleet analysis: one shard in memory at a time.

    Bit-identical to ``analyze_fleet(store.read_all(hosts))`` (modulo the
    last ulp of ``unattributed_energy_j`` on the row engine, and of the
    per-state energies between engines) with peak memory bounded by the
    largest shard, so 162 GB-scale datasets analyze on a laptop.

    **Engine selection** (``compact``): by default (``None``) the analysis
    runs over the store's run-level IR (:func:`repro_torch.whatif.ir.get_ir` —
    memory/sidecar cached, incrementally extended on append), reducing run
    tables instead of re-classifying rows, and falls back to the row
    engine automatically when the store cannot be compacted (irregular
    sampling, quarantined mid-stream shards) — recorded as a
    ``compact -> row`` fallback. ``compact=False`` pins the row engine
    (the bit-exactness oracle); ``compact=True`` demands the IR engine and
    propagates its errors instead of falling back. A prebuilt ``ir``
    handle (e.g. shared with a sweep/search over the same store) skips
    acquisition entirely; it must match ``config``/``dt_s``. Between the
    engines, per-state times, durations, intervals, platform grouping and
    ``unattributed_energy_j`` are bit-identical; energies agree within
    1e-9 relative (float summation order).

    Robustness: ``strict=False`` skips unreadable shards instead of raising
    — the result is bit-identical to analyzing the clean subset, with the
    skipped shards recorded in ``result.skipped`` and ``result.coverage``
    reporting rows analyzed / rows on disk.
    """
    hosts = list(hosts) if hosts is not None else None
    t0 = time.perf_counter()
    result = None
    n_rows = n_chunks = n_runs = 0
    with obs.span("analyze_store"):
        if compact is not False:
            # local import: whatif.ir imports core/* which pipeline feeds
            from repro_torch.telemetry.storage import ShardReadError
            from repro_torch.whatif import ir as ir_mod
            try:
                ir_obj = ir
                if ir_obj is not None:
                    if (ir_obj.config.classifier != config
                            or ir_obj.config.dt_s != dt_s):
                        raise ir_mod.IRUnsupportedError(
                            "prebuilt IR was compacted under a different "
                            "classifier config or dt_s")
                    if ir_obj.skipped and strict:
                        raise ir_mod.IRUnsupportedError(
                            "prebuilt IR carries skipped shards; pass "
                            "strict=False to accept degraded coverage")
                else:
                    ir_obj = ir_mod.get_ir(
                        store,
                        ir_mod.IRConfig(classifier=config, dt_s=dt_s),
                        strict=strict)
                skips = [dict(s) for s in ir_obj.skipped
                         if hosts is None or s.get("host", "") in set(hosts)]
                with obs.span("analyze.reduce_runs"):
                    result = _analyze_ir(ir_obj, hosts, min_job_duration_s,
                                         min_interval_s, dt_s)
                n_runs = sum(s.n_runs for s in ir_obj.select(hosts))
            except (ir_mod.IRUnsupportedError, ShardReadError) as e:
                if compact:
                    raise
                reason = ("ir_unsupported"
                          if isinstance(e, ir_mod.IRUnsupportedError)
                          else "shard_read_error")
                obs.fallback("compact", "row", reason)
        if result is None:
            acc = FleetAccumulator(
                min_job_duration_s=min_job_duration_s,
                min_interval_s=min_interval_s,
                config=config,
                dt_s=dt_s,
            )
            skips = []
            with obs.span("analyze.accumulate"):
                for frame in store.iter_shards(hosts, strict=strict,
                                               skips=skips):
                    acc.update(frame)
            n_rows, n_chunks = acc.n_rows, acc.n_chunks
            with obs.span("analyze.finalize"):
                result = acc.finalize()
        expected = store.rows_on_disk(hosts)
        skip_rows = sum(s["rows"] for s in skips)
        coverage = (1.0 if expected <= 0
                    else max(0.0, 1.0 - skip_rows / expected))
        result = dataclasses.replace(result, coverage=coverage,
                                     skipped=tuple(skips))
        if not n_rows:
            n_rows = max(expected - skip_rows, 0)
        obs.gauge("repro_coverage_fraction", coverage, stage="analyze",
                  help="rows analyzed / rows on disk for the last run")
    if obs.enabled():
        dt = max(time.perf_counter() - t0, 1e-12)
        obs.observe("repro_analyze_seconds", dt,
                    help="wall time of analyze_store calls")
        obs.gauge("repro_analyze_rows_per_s", n_rows / dt,
                  help="row throughput of the last analyze_store")
        if n_chunks:
            obs.gauge("repro_analyze_shards_per_s", n_chunks / dt,
                      help="shard throughput of the last analyze_store")
        if n_runs:
            obs.gauge("repro_analyze_runs_per_s", n_runs / dt,
                      help="run-table throughput of the last compact "
                           "analyze_store")
        obs.gauge("repro_analyze_jobs", float(len(result.jobs)),
                  help="jobs surviving the min-duration filter")
    return result


def per_job_fraction_cdf(jobs: Iterable[JobAnalysis]) -> dict[str, np.ndarray]:
    """Per-job execution-idle time/energy fractions (Fig 7)."""
    t = np.array([j.exec_idle_time_fraction for j in jobs])
    e = np.array([j.exec_idle_energy_fraction for j in jobs])
    return {"time_fraction": np.sort(t), "energy_fraction": np.sort(e)}


def tail_share(fractions: np.ndarray, threshold: float) -> float:
    """Share of jobs whose fraction exceeds `threshold` (Fig 7 quotes)."""
    fractions = np.asarray(fractions)
    return float(np.mean(fractions > threshold)) if fractions.size else 0.0
