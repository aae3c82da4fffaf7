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
import os
import time
from typing import TYPE_CHECKING, Iterable

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.energy import EnergyBreakdown, StreamingIntegrator, integrate, merge
from repro_torch.core.intervals import Interval, extract_intervals
from repro_torch.core.states import ClassifierConfig, DEFAULT_CLASSIFIER, DeviceState, classify_series
from repro_torch.telemetry.records import StreamOrderError, TelemetryFrame

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
                raise StreamOrderError(
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

    def merge(self, other: "FleetAccumulator") -> "FleetAccumulator":
        """Absorb an accumulator that processed a *disjoint* set of streams.

        This is the reduction step of process-pool shard analysis
        (``analyze_store(workers=N)``): each worker accumulates a
        host-label partition, the main process merges. Overlapping stream
        keys raise — per-stream run carry is sequential and cannot be
        joined after the fact. ``finalize`` after merging is bit-identical
        to the serial pass: per-stream results are computed identically,
        streams are re-sorted globally, and the unattributed total is
        ``math.fsum`` (exact, hence order-independent) over the same
        per-chunk partial sums.
        """
        overlap = self._groups.keys() & other._groups.keys()
        if overlap:
            raise ValueError(
                "cannot merge accumulators with overlapping streams: "
                f"{sorted(overlap)[:3]}...")
        if (other.min_job_duration_s, other.min_interval_s, other.config,
                other.dt_s) != (self.min_job_duration_s, self.min_interval_s,
                                self.config, self.dt_s):
            raise ValueError("cannot merge accumulators with different configs")
        self._groups.update(other._groups)
        self._unattributed_pieces.extend(other._unattributed_pieces)
        self.n_rows += other.n_rows
        self.n_chunks += other.n_chunks
        return self

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


def _pool_context():
    """forkserver where available, spawn elsewhere — never plain fork, so a
    parent with a live CUDA context is safe: the worker bodies are host
    NumPy, module-level, and import nothing that initialises CUDA or builds
    a kernel. Both start methods re-execute the caller's main module in
    each worker, so scripts calling ``workers > 1`` entry points at top
    level need the standard ``if __name__ == "__main__":`` guard (as
    ``chip_smoke.py`` has)."""
    import multiprocessing
    try:
        return multiprocessing.get_context("forkserver")
    except ValueError:
        return multiprocessing.get_context("spawn")


@dataclasses.dataclass(frozen=True)
class FaultTolerance:
    """Fault-supervisor policy for process-pool stages.

    ``max_retries`` bounds how many times a *crashed* (BrokenProcessPool) or
    *timed-out* partition is resubmitted — with exponential backoff starting
    at ``backoff_s`` — before it degrades to in-process execution in the
    parent (recorded as a ``pool -> in_process`` fallback). ``timeout_s``
    is the wall-clock budget for one pool round (``None`` = never time out;
    hung workers then hang the stage, exactly as before this layer existed).
    Worker-raised exceptions are *not* retried: a deterministic error (a
    corrupt shard under ``strict=True``, a bad config) propagates
    immediately with its original type.

    The live controller uses the same object one level up, for its tick
    (:class:`repro_torch.live.supervisor.TickSupervisor`): ``max_retries``
    bounds the same-rung retries of a failed tick attempt, ``timeout_s`` is
    the budget of the whole ladder walk.
    """

    max_retries: int = 2
    timeout_s: float | None = None
    backoff_s: float = 0.05


DEFAULT_FAULT_TOLERANCE = FaultTolerance()


def _fault_plan() -> str | None:
    """The active fault-plan path, captured in the *parent* at submission
    time. It must travel as a task argument, not ambiently: forkserver
    children inherit the fork server's environment from when it first
    launched, so a plan installed later would be invisible to them."""
    return os.environ.get("REPRO_FAULT_PLAN")   # == faults.ENV_PLAN


def _partition_body(stage, plan, worker, root, shard_files, *extra):
    """Pool submission wrapper: give the fault-injection harness its hook,
    then run the worker. The plan check keeps the harness import (and any
    file reads) entirely off the production path."""
    if plan:
        from repro_torch.testing import faults
        faults.check(stage, plan)
    return worker(root, shard_files, *extra)


def _shutdown_pool(pool, hard: bool) -> None:
    if hard:
        # hung or crashed round: terminate live workers (a hung worker
        # never exits on its own) and abandon queued futures
        for proc in list((getattr(pool, "_processes", None) or {}).values()):
            try:
                proc.terminate()
            except Exception:
                pass
        pool.shutdown(wait=False, cancel_futures=True)
    else:
        pool.shutdown(wait=True)


def run_supervised(fn, task_args: list[tuple], stage: str,
                   fault: FaultTolerance | None = None) -> list:
    """Run ``fn(*args)`` for each args-tuple in a process pool under the
    bounded-retry fault supervisor; returns results **in task order**.

    Crash/hang handling: a task whose worker dies (``BrokenProcessPool``)
    or exceeds ``fault.timeout_s`` is retried in a fresh pool up to
    ``fault.max_retries`` times with exponential backoff, then degraded to
    in-process execution in the parent — so one bad worker can no longer
    take down an entire ``analyze_store``/``run_sweep``. Note a broken pool
    fails *every* in-flight task of that round; innocent tasks are simply
    retried and succeed. Worker-raised exceptions propagate immediately
    (they are deterministic; retrying cannot help). Obs payloads are
    absorbed in task order after all tasks settle, preserving the
    bit-identical obs-on/obs-off contract.
    """
    from concurrent.futures import TimeoutError as FutTimeout
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool

    fault = fault or DEFAULT_FAULT_TOLERANCE
    n = len(task_args)
    results: dict[int, object] = {}
    payloads: dict[int, object] = {}
    attempts = [0] * n
    token = obs.worker_token(f"{stage}.partition")
    pending = list(range(n))
    while pending:
        pool = ProcessPoolExecutor(max_workers=len(pending),
                                   mp_context=_pool_context())
        futures = {i: pool.submit(obs.call_with_obs, token, fn, *task_args[i])
                   for i in pending}
        deadline = (time.monotonic() + fault.timeout_s
                    if fault.timeout_s is not None else None)
        failed: list[tuple[int, BaseException]] = []
        error: BaseException | None = None
        for i in pending:
            if error is not None:
                futures[i].cancel()
                continue
            try:
                budget = (None if deadline is None
                          else max(deadline - time.monotonic(), 0.0))
                results[i], payloads[i] = futures[i].result(timeout=budget)
            except (BrokenProcessPool, FutTimeout) as e:
                failed.append((i, e))
            except BaseException as e:
                error = e               # worker-raised: not retryable
        _shutdown_pool(pool, hard=bool(failed) or error is not None)
        if error is not None:
            raise error
        pending = []
        backoff_round = 0
        for i, exc in failed:
            attempts[i] += 1
            reason = type(exc).__name__
            obs.counter("repro_partition_retries_total",
                        stage=stage, reason=reason,
                        help="pool partition attempts that crashed/hung and "
                             "were retried or degraded")
            if attempts[i] <= fault.max_retries:
                pending.append(i)
                backoff_round = max(backoff_round, attempts[i])
            else:
                obs.fallback("pool", "in_process", reason)
                with obs.span(f"{stage}.partition", degraded=True):
                    results[i] = fn(*task_args[i])
                payloads[i] = None
        if pending and fault.backoff_s > 0:
            time.sleep(min(fault.backoff_s * (2 ** (backoff_round - 1)), 2.0))
    for i in range(n):
        obs.absorb(payloads.get(i))
    return [results[i] for i in range(n)]


def map_shard_partitions(store, hosts, workers, worker, extra_args, merge,
                         stage: str = "pipeline",
                         fault: FaultTolerance | None = None):
    """Run ``worker(root, shard_files, *extra_args)`` over host-label
    partitions of a store and fold the results with ``merge(acc, part)``.
    Every worker body returns ``(obj, skips)`` — its result plus the shard
    skip records its ``strict=False`` reads produced — and this returns the
    folded ``(result, skips)`` with skips concatenated in partition order.

    The shared scaffold of ``analyze_store(workers=N)`` and
    ``repro_torch.whatif.sweep.run_sweep``. Determinism contract: partitions are
    disjoint in streams (see :meth:`TelemetryStore.partition_hosts`) and
    results are merged **in submit order**, so for order-exact reductions
    (``math.fsum`` pieces, sorted stream keys) any worker count is
    bit-identical to the serial pass. With one partition or ``workers <= 1``
    the worker runs in-process.

    Pool rounds run under the :func:`run_supervised` fault supervisor
    (crashed/hung partitions retry with backoff, then degrade to
    in-process; policy via ``fault``, default
    :data:`DEFAULT_FAULT_TOLERANCE`).

    When observability is enabled (:mod:`repro_torch.obs`), each pool submission
    is wrapped in :func:`repro_torch.obs.call_with_obs`: the worker runs under a
    ``{stage}.partition`` span in its own process, and its spans/metrics
    are folded back into the parent trace in submit order.  Obs off, the
    wrapper is a pure passthrough, and merge order is unchanged either way.
    """
    # materialize: `hosts` may be a one-shot iterable, and it is consumed
    # both by partition_hosts and by the serial fallback below
    hosts = list(hosts) if hosts is not None else None
    partitions = store.partition_hosts(workers, hosts) if workers > 1 else []
    if len(partitions) <= 1:
        obs.gauge("repro_pool_workers", 1.0, stage=stage,
                  help="process-pool fan-out per stage (1 = in-process)")
        with obs.span(f"{stage}.partition", serial=True):
            return _partition_body(stage, _fault_plan(), worker,
                                   str(store.root),
                                   store.shard_files(hosts), *extra_args)
    obs.gauge("repro_pool_workers", float(len(partitions)), stage=stage,
              help="process-pool fan-out per stage (1 = in-process)")
    parts = run_supervised(
        _partition_body,
        [(stage, _fault_plan(), worker, str(store.root),
          store.shard_files(part), *extra_args) for part in partitions],
        stage=stage, fault=fault)
    result, skips = None, []
    for part, part_skips in parts:
        skips.extend(part_skips)
        result = part if result is None else merge(result, part)
    return result, skips


def _accumulate_shards(
    root: str,
    shard_files: list[str],
    mmap: bool,
    acc_kwargs: dict,
    strict: bool = True,
    verify: bool = False,
) -> tuple[FleetAccumulator, list[dict]]:
    """Process-pool worker body: accumulate one shard subset (must stay
    module-level picklable). Returns ``(accumulator, skip_records)`` —
    under ``strict=False`` unreadable shards are skipped and recorded
    instead of raising (see :meth:`TelemetryStore.read_shard_or_skip`)."""
    from repro_torch.telemetry.storage import TelemetryStore
    store = TelemetryStore(root)
    acc = FleetAccumulator(**acc_kwargs)
    skips: list[dict] = []
    for name in shard_files:
        frame = store.read_shard_or_skip(name, skips, mmap=mmap,
                                         strict=strict, verify=verify)
        if frame is not None:
            acc.update(frame)
    return acc, skips


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
    workers: int = 1,
    mmap: bool = False,
    strict: bool = True,
    verify: bool = False,
    fault: FaultTolerance | None = None,
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

    ``workers > 1`` spreads host-label partitions over a process pool
    (streams never span host labels, so partitions are disjoint) and merges
    the partial accumulators — bit-identical to the serial pass, including
    ``unattributed_energy_j`` (see :meth:`FleetAccumulator.merge`).
    ``mmap=True`` memory-maps ``npy_dir`` shards (zero-copy reads; see
    :meth:`TelemetryStore.iter_shards`).

    Robustness: ``strict=False`` skips unreadable shards instead of raising
    — the result is bit-identical to analyzing the clean subset, with the
    skipped shards recorded in ``result.skipped`` and ``result.coverage``
    reporting rows analyzed / rows on disk. ``verify=True`` additionally
    checksums every shard read (on the compact path that is the shard
    reads IR acquisition performs; cached IRs were verified when built).
    ``fault`` tunes the pool's crash/hang supervisor (see
    :class:`FaultTolerance`).
    """
    hosts = list(hosts) if hosts is not None else None
    t0 = time.perf_counter()
    result = None
    n_rows = n_chunks = n_runs = 0
    with obs.span("analyze_store", workers=workers):
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
                        workers=workers, mmap=mmap, strict=strict,
                        verify=verify, fault=fault)
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
            acc_kwargs = dict(
                min_job_duration_s=min_job_duration_s,
                min_interval_s=min_interval_s,
                config=config,
                dt_s=dt_s,
            )
            acc, skips = map_shard_partitions(
                store, hosts, workers, _accumulate_shards,
                (mmap, acc_kwargs, strict, verify),
                merge=lambda a, b: a.merge(b), stage="analyze", fault=fault)
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
