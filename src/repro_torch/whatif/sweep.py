"""Policy evaluation kernel and the fixed-grid sweep built on it.

:func:`evaluate` is the reusable kernel: replay any set of policy configs
over one :class:`TelemetryStore`, one :class:`PolicyOutcome` per config.
:func:`run_sweep` is its fixed-grid caller — it assembles a
:class:`Frontier` (energy saved vs performance penalty per config, the
Pareto-optimal subset flagged, per-job CDFs attached) from the default
200-config grid. The closed-loop search (:mod:`repro_torch.whatif.search`)
is the other caller: the same kernel inside a budgeted refinement loop
around the Pareto knee.

Execution model: the store is compacted once into the run-level IR
(:mod:`repro_torch.whatif.ir`, cached in memory and as a store sidecar),
and every config replays against its run tables. ``backend="torch"`` (the
default) does that on the card (:mod:`repro_torch.whatif.backend`) and
refuses what the IR cannot carry. ``backend="numpy"`` is the host oracle:
IR-capable configs replay on the run tables
(:func:`repro_torch.whatif.replay.replay_ir`), the rest stream the store
shard by shard through one
:class:`~repro_torch.whatif.replay.BatchedPolicyReplayer`.
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
from repro_torch.whatif.policies import (DownscalePolicy, NoOpPolicy, ParkingPolicy,
                                         Policy, PowerCapPolicy)
from repro_torch.whatif.replay import BatchedPolicyReplayer, ReplayResult

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


# --------------------------------------------------------------------------- #
# Evaluation kernel and its fixed-grid caller
# --------------------------------------------------------------------------- #
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


def _replay_rows(
    configs: Sequence[Policy],
    store: "TelemetryStore",
    hosts: Iterable[str] | None,
    replayer_kwargs: dict,
    strict: bool,
) -> tuple[list[ReplayResult], int, list[dict]]:
    """The NumPy row path: stream the store shard by shard through one
    config-axis :class:`BatchedPolicyReplayer`, one shard in memory."""
    obs.counter("repro_replay_configs_total", float(len(configs)),
                path="row", help="policy configs replayed, by execution path")
    replayer = BatchedPolicyReplayer(configs, **replayer_kwargs)
    skips: list[dict] = []
    with obs.span("sweep.rows", configs=len(configs)):
        for frame in store.iter_shards(hosts, strict=strict, skips=skips):
            replayer.update(frame)
    n_rows = replayer.n_rows              # finalize() resets the counter
    return replayer.finalize(), n_rows, skips


def _ir_config(configs: Sequence[Policy], replayer_kwargs: dict):
    """The IR config the configs imply under the replay's classifier/dt."""
    from repro_torch.core.states import DEFAULT_CLASSIFIER
    from repro_torch.whatif import ir as ir_mod

    return ir_mod.ir_config_for(
        configs, replayer_kwargs.get("classifier") or DEFAULT_CLASSIFIER,
        replayer_kwargs.get("dt_s", 1.0))


def _acquire_ir(configs: Sequence[Policy], store: "TelemetryStore",
                replayer_kwargs: dict, ir, strict: bool):
    """The run-level IR the configs replay against: ``ir`` when given,
    else :func:`repro_torch.whatif.ir.get_ir` under the IR config the
    configs imply. Raises :class:`~repro_torch.whatif.ir.IRUnsupportedError`
    when the store cannot be compacted (e.g. irregular sampling)."""
    from repro_torch.whatif import ir as ir_mod

    if ir is not None:
        return ir
    return ir_mod.get_ir(store, _ir_config(configs, replayer_kwargs),
                         strict=strict)


def _ir_kwargs(replayer_kwargs: dict) -> dict:
    return {k: v for k, v in replayer_kwargs.items()
            if k in ("platform_of", "min_job_duration_s", "min_interval_s",
                     "classifier", "dt_s")}


def _evaluate_numpy(
    configs: list[Policy],
    store: "TelemetryStore",
    hosts: Iterable[str] | None,
    replayer_kwargs: dict,
    ir,
    strict: bool,
) -> tuple[list[PolicyOutcome], int, int, list[dict]]:
    """The host oracle. Configs the IR supports replay against the run axis
    (:func:`repro_torch.whatif.replay.replay_ir`); the rest — custom
    policies, mismatched thresholds, unsupported composites — stream the
    store through the row path, and a store that cannot be compacted
    (irregular sampling) replays entirely on rows (a ``compact -> row``
    fallback)."""
    from repro_torch.whatif import ir as ir_mod
    from repro_torch.whatif.replay import replay_ir

    results: list[ReplayResult | None] = [None] * len(configs)
    n_rows = n_runs = 0
    skips: list[dict] = []
    ir_obj = None
    cfg = ir.config if ir is not None else _ir_config(configs, replayer_kwargs)
    if ir is not None or any(ir_mod.ir_supported(p, cfg) for p in configs):
        try:
            ir_obj = _acquire_ir(configs, store, replayer_kwargs, ir, strict)
        except ir_mod.IRUnsupportedError:
            obs.fallback("compact", "row", "ir_unsupported")
    sup = ([i for i, p in enumerate(configs)
            if ir_mod.ir_supported(p, ir_obj.config)]
           if ir_obj is not None else [])
    if sup:
        obs.counter("repro_replay_configs_total", float(len(sup)),
                    path="compact",
                    help="policy configs replayed, by execution path")
        for i, res in zip(sup, replay_ir(ir_obj, [configs[i] for i in sup],
                                         hosts=hosts,
                                         **_ir_kwargs(replayer_kwargs))):
            results[i] = res
        skips = _ir_skips(ir_obj, hosts)
        selected = ir_obj.select(hosts)
        n_rows = sum(s.n_rows for s in selected)
        n_runs = sum(s.n_runs for s in selected)
    rest = [i for i in range(len(configs)) if results[i] is None]
    if rest or not sup:
        rest_results, rest_rows, rest_skips = _replay_rows(
            [configs[i] for i in rest], store, hosts, replayer_kwargs, strict)
        for i, res in zip(rest, rest_results):
            results[i] = res
        skips = _merge_skips(skips, rest_skips)
        if not sup:
            n_rows = rest_rows
    return [_outcome(r) for r in results], n_rows, n_runs, skips


def _evaluate_torch(
    configs: list[Policy],
    store: "TelemetryStore",
    hosts: Iterable[str] | None,
    replayer_kwargs: dict,
    ir,
    strict: bool,
    device: str,
) -> tuple[list[PolicyOutcome], int, int, list[dict]]:
    """The card: every config replays on the run-level IR through
    :func:`repro_torch.whatif.backend.replay_ir_outcomes` on ``device``.

    Nothing here runs on the host in the card's place: a config the IR
    cannot carry and a store that cannot be compacted raise (the NumPy
    backend is the explicit route for both), and an error in the torch
    backend (a kernel that does not build or launch, device loss)
    propagates to the caller.
    """
    from repro_torch.device import resolve_device
    from repro_torch.whatif import backend as torch_backend
    from repro_torch.whatif import ir as ir_mod

    device = resolve_device(device)
    cfg = ir.config if ir is not None else _ir_config(
        configs, replayer_kwargs)
    unsupported = [p.name for p in configs if not ir_mod.ir_supported(p, cfg)]
    if unsupported:
        raise ValueError(
            f"{len(unsupported)} config(s) cannot replay on the run-level IR "
            f"({sorted(set(unsupported))}); the torch backend replays only "
            f"IR-capable configs, pass backend='numpy' for the row path")
    try:
        ir_obj = _acquire_ir(configs, store, replayer_kwargs, ir, strict)
    except ir_mod.IRUnsupportedError as e:
        raise ir_mod.IRUnsupportedError(
            f"{e}; the torch backend replays only the run-level IR, pass "
            f"backend='numpy' for the row path") from e
    outcomes, n_rows, n_runs = torch_backend.replay_ir_outcomes(
        ir_obj, configs, hosts=hosts, device=device,
        **_ir_kwargs(replayer_kwargs))
    obs.counter("repro_replay_configs_total", float(len(configs)),
                path="torch", help="policy configs replayed, by execution path")
    return outcomes, n_rows, n_runs, _ir_skips(ir_obj, hosts)


#: arguments of the JAX package's ``evaluate``/``run_sweep``/``search_frontier``
#: that the port does not take: it replays in one process (no ``workers``
#: pool, no fault supervisor ``fault``, no config-axis mesh ``dist``), always
#: batched on the run-level IR (no ``batched``/``compact`` switch), and reads
#: shards without ``mmap`` or checksum ``verify``
DROPPED_ARGUMENTS = ("workers", "mmap", "batched", "compact", "dist", "verify", "fault")


def reject_dropped(kwargs: dict, caller: str) -> None:
    """Raise if ``kwargs`` holds one of :data:`DROPPED_ARGUMENTS`, naming it,
    so that none is silently ignored."""
    dropped = sorted(set(kwargs) & set(DROPPED_ARGUMENTS))
    if dropped:
        raise TypeError(f"{caller}() got {dropped}, which the port does not take: it "
                        f"replays in one process on the run-level IR (the JAX "
                        f"package's {list(DROPPED_ARGUMENTS)} are not ported)")


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
    hosts: Iterable[str] | None = None,
    replayer_kwargs: dict | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
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
            out = _evaluate_torch(configs, store, hosts, replayer_kwargs, ir,
                                  strict, device)
        else:
            out = _evaluate_numpy(configs, store, hosts, replayer_kwargs, ir,
                                  strict)
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
    hosts: Iterable[str] | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
    **replayer_kwargs,
) -> list[PolicyOutcome]:
    """Evaluate an arbitrary set of policy configs over a store.

    The reusable kernel under the fixed-grid :func:`run_sweep`: replays
    ``configs`` and returns one :class:`PolicyOutcome` per config, **in
    input order**, with no Pareto flags — Pareto-ness is a property of a
    *set* of outcomes; flag a set with :func:`assemble_frontier`.

    Args:
        configs: policy configs to evaluate (any mix of families).
        store: shard store to replay (simulator output or DES/serving traces).
        hosts: optional host-label filter.
        ir: a prebuilt :class:`repro_torch.whatif.ir.RunIR` to replay against
            (skips the cache lookup; otherwise the IR is built once per
            (store, IR config) and cached in memory and as a store sidecar).
        backend: ``"torch"`` (default: the run-level evaluators on
            ``device``, :mod:`repro_torch.whatif.backend`), ``"numpy"`` (the
            host oracle) or ``"auto"`` (``"torch"``). Time/count metrics are
            bit-identical across backends, energies/penalties <= 1e-9
            relative (tests/test_torch_whatif.py). The torch backend replays
            only IR-capable configs on a store that can be compacted, and
            raises otherwise; its errors propagate. This is its one
            behavioural difference from the JAX package's dispatch, which
            replays such configs, and the JAX backend's failures, on NumPy.
        device: where the torch backend runs, ``"cuda"`` (default; raises
            without CUDA) or ``"cpu"`` (the kernels' plain PyTorch
            versions). Ignored by the NumPy backend.
        strict: ``False`` skips unreadable shards instead of raising —
            results are bit-identical to replaying the clean shard subset.
        **replayer_kwargs: forwarded to the replay
            (``min_job_duration_s``, ``platform_of``, ``classifier``, ...).
    """
    outcomes, _, _, _ = _evaluate_outcomes(
        configs, store, hosts=hosts, replayer_kwargs=replayer_kwargs, ir=ir,
        backend=backend, device=device, strict=strict)
    return outcomes


def run_sweep(
    store: "TelemetryStore",
    policies: Sequence[Policy] | None = None,
    hosts: Iterable[str] | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    strict: bool = True,
    **replayer_kwargs,
) -> Frontier:
    """Replay a fixed policy grid over a store and report the trade-off
    frontier — the fixed-grid caller of the :func:`evaluate` kernel.

    ``policies`` defaults to :func:`default_policy_grid` (200 configs). All
    other arguments are :func:`evaluate`'s. With ``strict=False`` the
    returned frontier's ``coverage`` reports the fraction of on-disk rows
    actually replayed (< 1.0 when shards were skipped).
    """
    hosts = list(hosts) if hosts is not None else None
    policies = list(default_policy_grid() if policies is None else policies)
    outcomes, n_rows, n_runs, skips = _evaluate_outcomes(
        policies, store, hosts=hosts, replayer_kwargs=replayer_kwargs, ir=ir,
        backend=backend, device=device, strict=strict)
    coverage = _coverage_of(store, hosts, skips)
    obs.gauge("repro_coverage_fraction", coverage, stage="sweep",
              help="rows analyzed / rows on disk for the last run")
    return assemble_frontier(outcomes, n_rows, n_runs, coverage=coverage)
