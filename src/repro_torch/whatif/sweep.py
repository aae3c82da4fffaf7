"""Policy evaluation kernel and the fixed-grid sweep built on it.

:func:`evaluate` is the reusable kernel: replay any set of policy configs
over one :class:`TelemetryStore`, one :class:`PolicyOutcome` per config.
:func:`run_sweep` is its fixed-grid caller — it assembles a
:class:`Frontier` (energy saved vs performance penalty per config, the
Pareto-optimal subset flagged, per-job CDFs attached) from the default
200-config grid. :func:`repro_torch.whatif.search.search_frontier` is the
*closed-loop* caller: the same kernel inside a budgeted refinement loop
around the Pareto knee.

Execution model: by default the store is compacted once into the run-level
IR (:mod:`repro_torch.whatif.ir`, cached in memory and as a store sidecar),
and every config the IR can carry replays against its run tables:
``backend="torch"`` (the default) on the card
(:mod:`repro_torch.whatif.backend`), ``backend="numpy"`` on the host
(:func:`repro_torch.whatif.replay.replay_ir`). Configs the IR cannot carry,
stores it cannot compact and ``compact=False`` take the row path on the
host, on either backend.

The row path: the store's shards are partitioned by host label (each
(job, host, device) stream lives entirely under one host label, so
partitions hold disjoint streams); each partition streams its shards once.
By default (``batched=True``) the whole grid rides one
:class:`~repro_torch.whatif.replay.BatchedPolicyReplayer` per partition:
the grid is grouped into family batches and every stream segment is
classified, run-length-encoded and baseline-integrated ONCE for all
configs, each family evaluated as a ``(n_configs, n_samples)`` block — the
sweep is O(rows + configs), not O(rows x configs). ``batched=False`` keeps
one :class:`~repro_torch.whatif.replay.PolicyReplayer` per config (sharing
only grouping + classification via
:func:`repro_torch.whatif.replay.replay_chunk`); it is the reference oracle
the batched path is verified bit-identical against. Either way peak memory
is one shard + per-stream carry state. With ``workers > 1`` partitions run
in a process pool and the replayers are merged (disjoint-stream merge);
every per-stream computation is identical and the cross-stream reductions
are exact (``math.fsum``) or order-fixed (sorted stream keys), so
``workers=N`` is **bit-identical** to ``workers=1``. The pool's workers are
host NumPy and never touch the card.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import TYPE_CHECKING, Iterable, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.core.imbalance import PoolConfig, PoolPolicy
from repro_torch.telemetry.pipeline import map_shard_partitions
from repro_torch.whatif.policies import (DownscalePolicy, NoOpPolicy, ParkingPolicy,
                                         Policy, PowerCapPolicy)
from repro_torch.whatif.replay import (BatchedPolicyReplayer, PolicyReplayer,
                                       ReplayResult, replay_chunk)

if TYPE_CHECKING:
    from repro_torch.telemetry.storage import TelemetryStore


# --------------------------------------------------------------------------- #
# Default policy grid
# --------------------------------------------------------------------------- #
def default_policy_grid(dense: bool = True) -> list[Policy]:
    """Policy configs spanning the paper's mitigation space.

    ``dense=True`` (default): 200 configs — 1 no-op + 64 Algorithm-1
    downscale (X x Y x mode) + 21 consolidation (k-of-n x resume latency)
    + 114 power caps. The dense parking/cap axes follow the "Model Parking
    Tax" trade-off study; a grid this size is only affordable because the
    config-axis batched replay makes the sweep O(rows + configs).

    ``dense=False``: the legacy 48-config grid (1 + 24 + 6 + 17) that the
    committed ``BENCH_whatif_sweep.json`` baseline measures.
    """
    grid: list[Policy] = [NoOpPolicy()]
    xs = ((0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 10.0, 15.0) if dense
          else (1.0, 2.0, 3.0, 5.0, 8.0, 10.0))
    ys = (1.0, 2.0, 5.0, 10.0) if dense else (2.0, 5.0)
    for x in xs:
        for y in ys:
            for mode in (DownscaleMode.SM_ONLY, DownscaleMode.SM_AND_MEM):
                grid.append(DownscalePolicy(config=ControllerConfig(
                    threshold_x_s=x, cooldown_y_s=y, mode=mode)))
    resumes = (2.0, 5.0, 10.0, 30.0, 60.0) if dense else (5.0, 30.0)
    for k in (1, 2, 3):
        for resume_s in resumes:
            grid.append(ParkingPolicy(
                pool=PoolConfig(n_devices=4, policy=PoolPolicy.CONSOLIDATED,
                                n_active=k),
                resume_latency_s=resume_s))
    if dense:
        for k in (2, 4, 6):
            for resume_s in (5.0, 30.0):
                grid.append(ParkingPolicy(
                    pool=PoolConfig(n_devices=8,
                                    policy=PoolPolicy.CONSOLIDATED,
                                    n_active=k),
                    resume_latency_s=resume_s))
    n_caps = 114 if dense else 17
    for frac in np.linspace(0.25, 0.95, n_caps):
        grid.append(PowerCapPolicy(cap_fraction=round(float(frac), 4)))
    return grid


# --------------------------------------------------------------------------- #
# Frontier report
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PolicyOutcome:
    """One grid point on the energy/perf trade-off frontier."""

    name: str
    params: dict
    n_jobs: int
    baseline_energy_j: float
    counterfactual_energy_j: float
    energy_saved_j: float
    saved_fraction: float
    penalty_s: float
    penalty_fraction: float
    wake_events: int
    downscale_events: int
    throttled_time_s: float
    exec_idle_energy_fraction_baseline: float
    exec_idle_energy_fraction_cf: float
    #: sorted per-job CDFs (x-axes of the Fig-7-style what-if plots)
    per_job_saved_fraction: tuple[float, ...]
    per_job_penalty_s: tuple[float, ...]
    pareto: bool = False


@dataclasses.dataclass(frozen=True)
class Frontier:
    """Sweep result: one outcome per policy config, Pareto subset flagged.

    Produced by the fixed-grid :func:`run_sweep` and by the closed-loop
    :func:`repro_torch.whatif.search.search_frontier`, whose frontier holds
    every config the search evaluated. :meth:`best_within_penalty` answers
    the budget question directly.

    ``n_runs`` is the run-level IR's compact axis size when the sweep took
    the compact path (0 otherwise): ``n_rows / n_runs`` is the corpus's
    compaction ratio — a direct view of how idle-dominated (and therefore
    run-compressible) the fleet telemetry is.

    ``trace`` is the closed-loop search's eval-by-eval convergence record
    (empty for fixed-grid sweeps): one dict per evaluated config, in
    evaluation order — ``{"i", "round", "family", "saved_fraction",
    "penalty_s"}`` — deliberately containing only deterministic replay
    results (no wall-clock), so frontiers stay **bit-identical** whether
    observability is on or off. Render with
    :func:`repro_torch.whatif.report.format_search_trace`.
    """

    outcomes: tuple[PolicyOutcome, ...]
    n_rows: int
    n_jobs: int
    n_runs: int = 0
    trace: tuple[dict, ...] = ()
    #: rows replayed / rows on disk — 1.0 unless shards were skipped under
    #: ``strict=False`` (see README "Robustness & dirty telemetry")
    coverage: float = 1.0

    @property
    def compaction_ratio(self) -> float:
        return self.n_rows / self.n_runs if self.n_runs else float("nan")

    def pareto_set(self) -> list[PolicyOutcome]:
        return [o for o in self.outcomes if o.pareto]

    def best_within_penalty(self, max_penalty_s: float) -> PolicyOutcome | None:
        """Highest-saving config whose modeled penalty fits the budget."""
        ok = [o for o in self.outcomes if o.penalty_s <= max_penalty_s]
        return max(ok, key=lambda o: o.energy_saved_j) if ok else None


def pareto_flags(saved: Sequence[float], penalty: Sequence[float]) -> list[bool]:
    """Non-dominated points for (maximize saved, minimize penalty).

    Point i is dominated when some other point j has ``s_j >= s_i`` and
    ``p_j <= p_i`` with one of the two strict. Computed in O(n log n): sort
    by saved, descending; a point is dominated when a strictly larger saved
    comes with a penalty at most its own (the running minimum of the groups
    before its own), or an equal saved with a strictly smaller penalty (its
    group's minimum). NaN compares false, so a point with NaN in either
    coordinate is never dominated and dominates nothing; equal points do not
    dominate each other; ±inf and -0.0 == 0.0 compare as floats do. Same
    flags as the pairwise test on every input.
    """
    s = np.asarray(saved, dtype=np.float64).reshape(-1)
    p = np.asarray(penalty, dtype=np.float64).reshape(-1)
    flags = np.ones(s.size, dtype=bool)
    idx = np.flatnonzero(~(np.isnan(s) | np.isnan(p)))
    if idx.size < 2:
        return flags.tolist()
    order = idx[np.argsort(-s[idx], kind="stable")]
    s_o, p_o = s[order], p[order]
    first = np.r_[True, s_o[1:] != s_o[:-1]]      # each group of equal saved
    group = np.cumsum(first) - 1
    group_min = np.minimum.reduceat(p_o, np.flatnonzero(first))
    # the least penalty among strictly larger saved (none for the first group)
    before = np.minimum.accumulate(group_min)
    larger = np.r_[np.inf, before[:-1]][group]
    dominated = (group > 0) & (larger <= p_o)
    dominated |= group_min[group] < p_o
    flags[order] = ~dominated
    return flags.tolist()


def assemble_frontier(outcomes: Sequence[PolicyOutcome],
                      n_rows: int = 0, n_runs: int = 0,
                      trace: Sequence[dict] = (),
                      coverage: float = 1.0) -> Frontier:
    """Build a :class:`Frontier` from already-evaluated outcomes, recomputing
    the Pareto flags over exactly this set (any flags carried in are
    discarded). The closed-loop search accumulates outcomes across
    refinement rounds and re-assembles after every round (passing its
    convergence ``trace``)."""
    flags = pareto_flags([o.energy_saved_j for o in outcomes],
                         [o.penalty_s for o in outcomes])
    flagged = tuple(dataclasses.replace(o, pareto=f)
                    for o, f in zip(outcomes, flags))
    n_jobs = max((o.n_jobs for o in flagged), default=0)
    return Frontier(outcomes=flagged, n_rows=n_rows, n_jobs=n_jobs,
                    n_runs=n_runs, trace=tuple(trace), coverage=coverage)


def _outcome(result: ReplayResult) -> PolicyOutcome:
    saved_cdf = tuple(sorted(float(j.saved_fraction) for j in result.jobs))
    penalty_cdf = tuple(sorted(float(j.penalty_s) for j in result.jobs))
    return PolicyOutcome(
        name=result.policy_name,
        params=result.policy_params,
        n_jobs=len(result.jobs),
        baseline_energy_j=result.baseline.total_energy_j,
        counterfactual_energy_j=result.counterfactual.total_energy_j,
        energy_saved_j=result.energy_saved_j,
        saved_fraction=result.saved_fraction,
        penalty_s=result.penalty_s,
        penalty_fraction=result.penalty_fraction,
        wake_events=result.wake_events,
        downscale_events=result.downscale_events,
        throttled_time_s=result.throttled_time_s,
        exec_idle_energy_fraction_baseline=result.baseline.exec_idle_energy_fraction,
        exec_idle_energy_fraction_cf=result.counterfactual.exec_idle_energy_fraction,
        per_job_saved_fraction=saved_cdf,
        per_job_penalty_s=penalty_cdf,
    )


def _assemble(results: list[ReplayResult], n_rows: int,
              n_runs: int = 0) -> Frontier:
    return assemble_frontier([_outcome(r) for r in results], n_rows, n_runs)


# --------------------------------------------------------------------------- #
# Evaluation kernel and its fixed-grid caller
# --------------------------------------------------------------------------- #
def _replay_partition(
    root: str,
    shard_files: list[str],
    policies: Sequence[Policy],
    mmap: bool,
    replayer_kwargs: dict,
    strict: bool = True,
    verify: bool = False,
) -> tuple[list[PolicyReplayer], list[dict]]:
    """Stream one shard subset through every policy's replayer (worker body;
    must stay module-level picklable). The reference oracle path."""
    from repro_torch.telemetry.storage import TelemetryStore
    store = TelemetryStore(root)
    replayers = [PolicyReplayer(p, **replayer_kwargs) for p in policies]
    skips: list[dict] = []
    for name in shard_files:
        frame = store.read_shard_or_skip(name, skips, mmap=mmap,
                                         strict=strict, verify=verify)
        if frame is not None:
            replay_chunk(replayers, frame)
    return replayers, skips


def _replay_partition_batched(
    root: str,
    shard_files: list[str],
    policies: Sequence[Policy],
    mmap: bool,
    replayer_kwargs: dict,
    strict: bool = True,
    verify: bool = False,
) -> tuple[BatchedPolicyReplayer, list[dict]]:
    """Stream one shard subset through the config-axis batched replayer
    (worker body; must stay module-level picklable)."""
    from repro_torch.telemetry.storage import TelemetryStore
    store = TelemetryStore(root)
    replayer = BatchedPolicyReplayer(policies, **replayer_kwargs)
    skips: list[dict] = []
    for name in shard_files:
        frame = store.read_shard_or_skip(name, skips, mmap=mmap,
                                         strict=strict, verify=verify)
        if frame is not None:
            replayer.update(frame)
    return replayer, skips


def _ir_skips(ir_obj, hosts: Iterable[str] | None) -> list[dict]:
    """The IR's recorded shard skips, filtered to the replayed host set."""
    if not ir_obj.skipped:
        return []
    host_set = set(hosts) if hosts is not None else None
    return [dict(s) for s in ir_obj.skipped
            if host_set is None or s.get("host") in host_set]


def _merge_skips(*skip_lists: Sequence[dict]) -> list[dict]:
    """Concatenate skip-record lists, deduplicating by shard file (the IR
    and a row-fallback recursion may both report the same bad shard)."""
    seen: set = set()
    out: list[dict] = []
    for lst in skip_lists:
        for s in lst:
            key = s.get("file")
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    return out


def _coverage_of(store: "TelemetryStore", hosts: Iterable[str] | None,
                 skips: Sequence[dict]) -> float:
    """Rows replayed / rows on disk for the host selection (1.0 when no
    shards were skipped or the store is empty)."""
    if not skips:
        return 1.0
    expected = store.rows_on_disk(hosts)
    if expected <= 0:
        return 1.0
    return max(0.0, 1.0 - sum(float(s.get("rows", 0)) for s in skips)
               / expected)


def _evaluate(
    configs: Sequence[Policy],
    store: "TelemetryStore",
    workers: int = 1,
    hosts: Iterable[str] | None = None,
    mmap: bool = False,
    batched: bool = True,
    replayer_kwargs: dict | None = None,
    compact: bool | None = None,
    ir=None,
    strict: bool = True,
    verify: bool = False,
    fault=None,
) -> tuple[list[ReplayResult], int, int, list[dict]]:
    """Kernel body shared by :func:`evaluate` / :func:`run_sweep`: one
    :class:`ReplayResult` per config in input order, plus the replayed
    job-attributed row count, (when the compact path ran) the IR's run
    count, and the shard skip records of a ``strict=False`` replay.

    ``compact=None`` resolves to ``batched`` — the row-exact reference
    paths (``batched=False`` / ``compact=False``) stay byte-for-byte what
    they were. With the compact path on, configs the IR supports replay
    against the run axis (:func:`repro_torch.whatif.replay.replay_ir`); the rest
    — custom policies, mismatched thresholds, unsupported composites —
    stream the store through the row path, and an irregularly-sampled
    store falls back entirely (a ``compact -> row`` fallback in the
    degradation ladder).
    """
    configs = list(configs)
    replayer_kwargs = replayer_kwargs or {}
    if compact is None:
        compact = batched

    if compact:
        from repro_torch.whatif import ir as ir_mod
        from repro_torch.whatif.replay import replay_ir

        classifier = replayer_kwargs.get("classifier", None)
        dt_s = replayer_kwargs.get("dt_s", 1.0)
        if ir is not None:
            ir_obj = ir
        else:
            from repro_torch.core.states import DEFAULT_CLASSIFIER
            cfg = ir_mod.ir_config_for(
                configs, classifier or DEFAULT_CLASSIFIER, dt_s)
            ir_obj = None
            if any(ir_mod.ir_supported(p, cfg) for p in configs):
                try:
                    ir_obj = ir_mod.get_ir(store, cfg, workers=workers,
                                           mmap=mmap, strict=strict,
                                           verify=verify, fault=fault)
                except ir_mod.IRUnsupportedError:
                    ir_obj = None       # e.g. irregular sampling: use rows
                    obs.fallback("compact", "row", "ir_unsupported")
        if ir_obj is not None:
            sup = [i for i, p in enumerate(configs)
                   if ir_mod.ir_supported(p, ir_obj.config)]
            if sup:
                ir_kwargs = {k: v for k, v in replayer_kwargs.items()
                             if k in ("platform_of", "min_job_duration_s",
                                      "min_interval_s", "classifier", "dt_s")}
                obs.counter("repro_replay_configs_total", float(len(sup)),
                            path="compact",
                            help="policy configs replayed, by execution path")
                sup_results = replay_ir(
                    ir_obj, [configs[i] for i in sup], hosts=hosts,
                    workers=workers, fault=fault, **ir_kwargs)
                skips = _ir_skips(ir_obj, hosts)
                results: list[ReplayResult | None] = [None] * len(configs)
                for i, res in zip(sup, sup_results):
                    results[i] = res
                rest = [i for i in range(len(configs)) if results[i] is None]
                if rest:
                    obs.counter("repro_replay_row_fallback_configs_total",
                                float(len(rest)),
                                help="configs the IR could not cover "
                                     "(row-path fallback)")
                    rest_results, _, _, rest_skips = _evaluate(
                        [configs[i] for i in rest], store, workers=workers,
                        hosts=hosts, mmap=mmap, batched=batched,
                        replayer_kwargs=replayer_kwargs, compact=False,
                        strict=strict, verify=verify, fault=fault)
                    for i, res in zip(rest, rest_results):
                        results[i] = res
                    skips = _merge_skips(skips, rest_skips)
                selected = ir_obj.select(hosts)
                n_rows = sum(s.n_rows for s in selected)
                n_runs = sum(s.n_runs for s in selected)
                return results, n_rows, n_runs, skips

    if batched:
        obs.counter("repro_replay_configs_total", float(len(configs)),
                    path="row_batched",
                    help="policy configs replayed, by execution path")
        replayer, skips = map_shard_partitions(
            store, hosts, workers, _replay_partition_batched,
            (configs, mmap, replayer_kwargs, strict, verify),
            merge=lambda a, b: a.merge(b), stage="sweep", fault=fault)
        n_rows = replayer.n_rows          # finalize() resets the counter
        return replayer.finalize(), n_rows, 0, skips

    def merge_lists(a: list[PolicyReplayer], b: list[PolicyReplayer]):
        for dst, src in zip(a, b):
            dst.merge(src)
        return a

    obs.counter("repro_replay_configs_total", float(len(configs)),
                path="row_serial",
                help="policy configs replayed, by execution path")
    replayers, skips = map_shard_partitions(
        store, hosts, workers, _replay_partition,
        (configs, mmap, replayer_kwargs, strict, verify),
        merge=merge_lists, stage="sweep", fault=fault)
    n_rows = replayers[0].n_rows if replayers else 0
    return [r.finalize() for r in replayers], n_rows, 0, skips


def _ir_kwargs(replayer_kwargs: dict) -> dict:
    return {k: v for k, v in replayer_kwargs.items()
            if k in ("platform_of", "min_job_duration_s", "min_interval_s",
                     "classifier", "dt_s")}


def _evaluate_torch(
    configs: list[Policy],
    store: "TelemetryStore",
    workers: int,
    hosts: Iterable[str] | None,
    mmap: bool,
    batched: bool,
    replayer_kwargs: dict,
    compact: bool | None,
    ir,
    strict: bool,
    verify: bool,
    fault,
    device: str,
) -> tuple[list[PolicyOutcome], int, int, list[dict]]:
    """The torch backend, routed as the JAX package routes its accelerator
    backend. The split is made on the host, before anything is packed for
    the card: IR-capable configs replay on ``device`` through
    :func:`repro_torch.whatif.backend.replay_ir_outcomes`; configs the IR
    cannot carry take the row path (counted in
    ``repro_replay_row_fallback_configs_total``); a store the IR cannot
    compact replays on rows (one ``compact -> row`` fallback), and so does
    ``compact=False``.

    Unlike the JAX package's dispatch, nothing here carries on on the host
    when the card fails: an error of the torch backend (a kernel that does
    not build or launch, device loss) propagates to the caller.
    """
    from repro_torch.device import resolve_device
    from repro_torch.whatif import ir as ir_mod

    device = resolve_device(device)
    if compact is None or compact:
        if ir is not None:
            ir_obj = ir
        else:
            from repro_torch.core.states import DEFAULT_CLASSIFIER
            cfg = ir_mod.ir_config_for(
                configs, replayer_kwargs.get("classifier") or DEFAULT_CLASSIFIER,
                replayer_kwargs.get("dt_s", 1.0))
            ir_obj = None
            if any(ir_mod.ir_supported(p, cfg) for p in configs):
                try:
                    ir_obj = ir_mod.get_ir(store, cfg, workers=workers,
                                           mmap=mmap, strict=strict,
                                           verify=verify, fault=fault)
                except ir_mod.IRUnsupportedError:
                    obs.fallback("compact", "row", "ir_unsupported")
        sup = ([i for i, p in enumerate(configs)
                if ir_mod.ir_supported(p, ir_obj.config)]
               if ir_obj is not None else [])
        if sup:
            from repro_torch.whatif import backend as torch_backend
            sup_out, n_rows, n_runs = torch_backend.replay_ir_outcomes(
                ir_obj, [configs[i] for i in sup], hosts=hosts, device=device,
                **_ir_kwargs(replayer_kwargs))
            obs.counter("repro_replay_configs_total", float(len(sup)),
                        path="torch",
                        help="policy configs replayed, by execution path")
            skips = _ir_skips(ir_obj, hosts)
            outcomes: list[PolicyOutcome | None] = [None] * len(configs)
            for i, out in zip(sup, sup_out):
                outcomes[i] = out
            rest = [i for i in range(len(configs)) if outcomes[i] is None]
            if rest:
                obs.counter("repro_replay_row_fallback_configs_total",
                            float(len(rest)),
                            help="configs the IR could not cover "
                                 "(row-path fallback)")
                rest_results, _, _, rest_skips = _evaluate(
                    [configs[i] for i in rest], store, workers=workers,
                    hosts=hosts, mmap=mmap, batched=batched,
                    replayer_kwargs=replayer_kwargs, compact=False,
                    strict=strict, verify=verify, fault=fault)
                for i, res in zip(rest, rest_results):
                    outcomes[i] = _outcome(res)
                skips = _merge_skips(skips, rest_skips)
            return outcomes, n_rows, n_runs, skips
    # nothing for the card: the row path (compaction was already tried)
    results, n_rows, n_runs, skips = _evaluate(
        configs, store, workers=workers, hosts=hosts, mmap=mmap,
        batched=batched, replayer_kwargs=replayer_kwargs, compact=False,
        strict=strict, verify=verify, fault=fault)
    return [_outcome(r) for r in results], n_rows, n_runs, skips


#: the one argument of the JAX package's ``evaluate``/``run_sweep``/
#: ``search_frontier`` that the port does not take yet: ``dist``, the
#: config-axis device mesh, which comes with the distribution slice
DROPPED_ARGUMENTS = ("dist",)


def reject_dropped(kwargs: dict, caller: str) -> None:
    """Raise if ``kwargs`` holds one of :data:`DROPPED_ARGUMENTS`, naming it,
    so that none is silently ignored."""
    dropped = sorted(set(kwargs) & set(DROPPED_ARGUMENTS))
    if dropped:
        raise TypeError(f"{caller}() got {dropped}, which the port does not "
                        f"take: it replays on one device (the JAX package's "
                        f"config-axis mesh {list(DROPPED_ARGUMENTS)} is not "
                        f"ported)")


def resolve_backend(backend: str) -> str:
    """Resolve an ``evaluate``/``run_sweep`` ``backend`` argument.

    ``"torch"`` (the default: the run-level replay on the card,
    :mod:`repro_torch.whatif.backend`), ``"numpy"`` (the host path, the
    bit-exactness oracle) or ``"auto"``, which is ``"torch"``: the port never
    picks the host path on its own.
    """
    if backend == "auto":
        return "torch"
    if backend not in ("numpy", "torch"):
        raise ValueError(
            f"unknown backend {backend!r}; use 'torch', 'numpy' or 'auto'")
    return backend


def _evaluate_outcomes(
    configs: Sequence[Policy],
    store: "TelemetryStore",
    workers: int = 1,
    hosts: Iterable[str] | None = None,
    mmap: bool = False,
    batched: bool = True,
    replayer_kwargs: dict | None = None,
    compact: bool | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
    verify: bool = False,
    fault=None,
) -> tuple[list[PolicyOutcome], int, int, list[dict]]:
    """Backend dispatch under a ``whatif.evaluate`` span, with per-family
    config counts and a throughput gauge recorded when :mod:`repro_torch.obs`
    is enabled. Outcomes are bit-identical with obs on or off."""
    configs = list(configs)
    replayer_kwargs = replayer_kwargs or {}
    reject_dropped(replayer_kwargs, "evaluate")
    backend = resolve_backend(backend)
    t0 = time.perf_counter()
    with obs.span("whatif.evaluate", configs=len(configs), backend=backend):
        if backend == "torch":
            out = _evaluate_torch(configs, store, workers, hosts, mmap,
                                  batched, replayer_kwargs, compact, ir,
                                  strict, verify, fault, device)
        else:
            results, n_rows, n_runs, skips = _evaluate(
                configs, store, workers=workers, hosts=hosts, mmap=mmap,
                batched=batched, replayer_kwargs=replayer_kwargs,
                compact=compact, ir=ir, strict=strict, verify=verify,
                fault=fault)
            out = [_outcome(r) for r in results], n_rows, n_runs, skips
    if obs.enabled():
        dt = max(time.perf_counter() - t0, 1e-12)
        obs.observe("repro_replay_seconds", dt,
                    help="wall time of evaluate calls")
        obs.gauge("repro_replay_configs_per_s", len(configs) / dt,
                  help="config throughput of the last evaluate")
        for fam, n in collections.Counter(p.name for p in configs).items():
            obs.counter("repro_replay_family_configs_total", float(n),
                        family=fam,
                        help="policy configs replayed, by policy family")
    return out


def evaluate(
    configs: Sequence[Policy],
    store: "TelemetryStore",
    workers: int = 1,
    hosts: Iterable[str] | None = None,
    mmap: bool = False,
    batched: bool = True,
    compact: bool | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
    verify: bool = False,
    fault=None,
    **replayer_kwargs,
) -> list[PolicyOutcome]:
    """Evaluate an arbitrary set of policy configs over a store.

    The reusable kernel under both the fixed-grid :func:`run_sweep` and the
    closed-loop :func:`repro_torch.whatif.search.search_frontier`: replays
    ``configs`` and returns one :class:`PolicyOutcome` per config, **in
    input order**, with no Pareto flags — Pareto-ness is a property of a
    *set* of outcomes; flag a set with :func:`assemble_frontier`.

    Args:
        configs: policy configs to evaluate (any mix of families).
        store: shard store to replay (simulator output or DES/serving traces).
        workers: process-pool width of the host work (the row path and the
            IR build). Partitions are host-label-disjoint, so results are
            bit-identical for every worker count. Scripts calling this with
            ``workers > 1`` at top level need the standard
            ``if __name__ == "__main__":`` guard (workers re-import main).
        hosts: optional host-label filter.
        mmap: pass ``mmap=True`` to shard reads (zero-copy for ``npy_dir``
            shards; see :meth:`TelemetryStore.iter_shards`).
        batched: on the row path, evaluate the configs family-by-family
            along a config axis (:class:`BatchedPolicyReplayer`);
            ``batched=False`` runs the per-policy reference path. Both are
            bit-identical.
        compact: replay against the run-level IR (:mod:`repro_torch.whatif.ir`)
            where the configs support it. ``None`` (default) follows
            ``batched`` on the numpy backend; the torch backend, as the JAX
            package's accelerator backend, takes the IR unless
            ``compact=False``, which replays every config on rows.
            Unsupported configs and stores the IR cannot compact take the
            row path.
        ir: a prebuilt :class:`repro_torch.whatif.ir.RunIR` to replay against
            (skips the cache lookup; otherwise the IR is built once per
            (store, IR config) and cached in memory and as a store sidecar).
        backend: ``"torch"`` (default: the run-level evaluators on
            ``device``, :mod:`repro_torch.whatif.backend`), ``"numpy"`` (the
            host oracle) or ``"auto"`` (``"torch"``). Time/count metrics are
            bit-identical across backends, energies/penalties <= 1e-9
            relative (tests/test_torch_whatif.py). Both backends route what
            the IR cannot carry to the row path. An error of the torch
            backend propagates: this is its one behavioural difference from
            the JAX package's dispatch, which replays the JAX backend's
            failures on NumPy.
        device: where the torch backend runs, ``"cuda"`` (default; raises
            without CUDA) or ``"cpu"`` (the kernels' plain PyTorch
            versions). Ignored by the NumPy backend.
        strict: ``False`` skips unreadable shards instead of raising —
            results are bit-identical to replaying the clean shard subset.
        verify: checksum every shard read against the manifest.
        fault: a :class:`repro_torch.telemetry.pipeline.FaultTolerance`
            policy for the process-pool crash/hang supervisor.
        **replayer_kwargs: forwarded to the replay
            (``min_job_duration_s``, ``platform_of``, ``classifier``, ...).
    """
    outcomes, _, _, _ = _evaluate_outcomes(
        configs, store, workers=workers, hosts=hosts, mmap=mmap,
        batched=batched, replayer_kwargs=replayer_kwargs, compact=compact,
        ir=ir, backend=backend, device=device, strict=strict, verify=verify,
        fault=fault)
    return outcomes


def run_sweep(
    store: "TelemetryStore",
    policies: Sequence[Policy] | None = None,
    workers: int = 1,
    hosts: Iterable[str] | None = None,
    mmap: bool = False,
    batched: bool = True,
    compact: bool | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
    verify: bool = False,
    fault=None,
    **replayer_kwargs,
) -> Frontier:
    """Replay a fixed policy grid over a store and report the trade-off
    frontier — the fixed-grid caller of the :func:`evaluate` kernel.

    ``policies`` defaults to :func:`default_policy_grid` (200 configs). All
    other arguments are :func:`evaluate`'s; ``run_sweep(compact=False)`` is
    the row-exact verification path for the default compact (run-IR)
    sweep. With ``strict=False`` the returned frontier's ``coverage``
    reports the fraction of on-disk rows actually replayed (< 1.0 when
    shards were skipped).
    """
    hosts = list(hosts) if hosts is not None else None
    policies = list(default_policy_grid() if policies is None else policies)
    outcomes, n_rows, n_runs, skips = _evaluate_outcomes(
        policies, store, workers=workers, hosts=hosts, mmap=mmap,
        batched=batched, replayer_kwargs=replayer_kwargs, compact=compact,
        ir=ir, backend=backend, device=device, strict=strict, verify=verify,
        fault=fault)
    coverage = _coverage_of(store, hosts, skips)
    obs.gauge("repro_coverage_fraction", coverage, stage="sweep",
              help="rows analyzed / rows on disk for the last run")
    return assemble_frontier(outcomes, n_rows, n_runs, coverage=coverage)


def sweep_frame(frame, policies: Sequence[Policy] | None = None,
                batched: bool = True, **replayer_kwargs) -> Frontier:
    """In-memory convenience: sweep a single :class:`TelemetryFrame`
    (e.g. a DES :class:`PoolResult` telemetry) without a store."""
    policies = list(default_policy_grid() if policies is None else policies)
    if batched:
        replayer = BatchedPolicyReplayer(policies, **replayer_kwargs)
        replayer.update(frame)
        n_rows = replayer.n_rows          # finalize() resets the counter
        return _assemble(replayer.finalize(), n_rows)
    replayers = [PolicyReplayer(p, **replayer_kwargs) for p in policies]
    replay_chunk(replayers, frame)
    n_rows = replayers[0].n_rows if replayers else 0
    return _assemble([r.finalize() for r in replayers], n_rows)
