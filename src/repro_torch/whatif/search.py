"""Closed-loop Pareto search: budgeted knob optimization over policy families.

A dense grid sweep (:func:`repro_torch.whatif.sweep.run_sweep`) answers "what
does the whole mitigation space look like" with an O(grid) dump. An operator
asks a narrower question: *the best knob setting under a performance-penalty
budget* — and wants it without paying for 200 grid points.
:func:`search_frontier` answers it closed-loop: evaluate a coarse per-family
grid once (one batched replay), find the Pareto **knee**, then successively
refine each family's continuous knobs around its knee-adjacent Pareto
members — midpoint subdivision per axis, one batched
:func:`repro_torch.whatif.sweep.evaluate` pass per round — terminating on a
config-evaluation budget, knee convergence, or axis resolution.

The budget currency is **config evaluations**: the run-level IR is acquired
once per search and each refinement round replays only its new configs
against it, so the search wins where per-*config* cost dominates —
composite or custom families, knob spaces finer than the fixed grid's 200
points, or when only the knee neighbourhood matters.

The refinement mirrors the data-driven deadline-aware frequency-scaling
approach of Ilager et al. (budgeted knob search instead of exhaustive
sweep); the parking/cap axes follow the "Model Parking Tax" trade-off study.
Everything is deterministic — candidate generation is order-fixed and the
batched evaluator is bit-identical for any worker count — so a search is
reproducible across runs and process-pool widths.

The rounds run on the port's evaluator: the torch backend on the card by
default (``backend="torch"``, ``device="cuda"``, the cap-bucket scan and the
Algorithm-1 cooldown chain as hand-written kernels), ``backend="numpy"`` as
the host oracle. Rounds, candidate order, the knee test and the trace follow
the JAX package's search line by line, so a search here evaluates the same
configs in the same order as the JAX package's over the same store (time
and count fields exact, energies and penalties within 1e-9 relative). The
port takes every argument of the JAX package's search, ``dist`` (the
config-axis mesh, :func:`repro_torch.whatif.backend.config_mesh`) included;
``backend="jax"`` raises.

Typical use::

    result = search_frontier(store, budget=PenaltyBudget(
        max_penalty_fraction=0.01))     # <= 1% of recorded active time
    print(result.best.params, result.knee.params)
    print(format_frontier(result.frontier, top=10))

Observability: the search runs under a ``whatif.search`` span with one
``search.round`` child per refinement round, and records per-round evals,
knee movement, budget consumption and warm-seed hits as ``repro_search_*``
metrics when :mod:`repro_torch.obs` is enabled. Independently of obs, every
search emits a deterministic eval-by-eval convergence trace in
``result.frontier.trace`` (see :class:`repro_torch.whatif.sweep.Frontier`).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
from typing import TYPE_CHECKING, Callable, Iterable, Sequence

import repro_torch.obs as obs
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.core.imbalance import PoolConfig, PoolPolicy
from repro_torch.whatif.policies import (CompositePolicy, DownscalePolicy,
                                         NoOpPolicy, ParkingPolicy, Policy,
                                         PowerCapPolicy)
from repro_torch.whatif.sweep import (Frontier, PolicyOutcome, _coverage_of,
                                      _evaluate_outcomes, assemble_frontier,
                                      pareto_flags, resolve_backend)

if TYPE_CHECKING:
    from repro_torch.telemetry.storage import TelemetryStore


# --------------------------------------------------------------------------- #
# Budget
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PenaltyBudget:
    """Feasibility constraint on the modeled performance penalty.

    ``max_penalty_s`` bounds the fleet-total modeled stall seconds;
    ``max_penalty_fraction`` bounds the stall relative to the recorded
    active time (``PolicyOutcome.penalty_fraction``). Give either or both;
    a config is feasible when it satisfies every given bound.
    """

    max_penalty_s: float | None = None
    max_penalty_fraction: float | None = None

    def __post_init__(self) -> None:
        for field in ("max_penalty_s", "max_penalty_fraction"):
            v = getattr(self, field)
            if v is not None and v < 0:
                raise ValueError(f"PenaltyBudget {field} must be >= 0, got {v}")

    def feasible(self, outcome: PolicyOutcome) -> bool:
        if (self.max_penalty_s is not None
                and outcome.penalty_s > self.max_penalty_s):
            return False
        if (self.max_penalty_fraction is not None
                and outcome.penalty_fraction > self.max_penalty_fraction):
            return False
        return True


# --------------------------------------------------------------------------- #
# Family knob spaces
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ContinuousAxis:
    """A refinable knob. ``coarse`` seeds round 0; refinement inserts
    midpoints (geometric when ``log``) between a Pareto anchor's value and
    its nearest tried neighbours, while the gap exceeds ``resolution``
    (axis units when linear, log-units when ``log``)."""

    name: str
    lo: float
    hi: float
    coarse: tuple[float, ...]
    log: bool = False
    resolution: float = 0.05

    def __post_init__(self) -> None:
        if not self.lo < self.hi:
            raise ValueError(f"axis {self.name}: lo must be < hi")
        if self.log and self.lo <= 0:
            raise ValueError(f"axis {self.name}: log axis requires lo > 0")
        for v in self.coarse:
            if not self.lo <= v <= self.hi:
                raise ValueError(
                    f"axis {self.name}: coarse level {v} outside "
                    f"[{self.lo}, {self.hi}]")

    def gap(self, a: float, b: float) -> float:
        return math.log(b / a) if self.log else b - a

    def midpoint(self, a: float, b: float) -> float:
        return math.sqrt(a * b) if self.log else 0.5 * (a + b)


@dataclasses.dataclass(frozen=True)
class CategoricalAxis:
    """A discrete knob: every option is tried in round 0, never refined."""

    name: str
    options: tuple

    def __post_init__(self) -> None:
        if not self.options:
            raise ValueError(f"axis {self.name}: options must be non-empty")


@dataclasses.dataclass(frozen=True)
class PolicyFamily:
    """One searchable family: a knob space plus a policy factory.

    ``build`` maps a point (``{axis name: value}``) to a
    :class:`~repro_torch.whatif.policies.Policy`; the search only ever identifies
    configs by the built policy's ``describe()``, so factories are free to
    derive several constructor arguments from one axis.

    ``from_params`` is ``build``'s partial inverse: map a
    :class:`~repro_torch.whatif.sweep.PolicyOutcome`'s ``params`` dict back to an
    axis point (or None when the params belong to another family) — it is
    what lets :func:`search_frontier` warm-start from a previously saved
    frontier (``init_frontier=``), seeding round 0 at last snapshot's knee.
    """

    name: str
    axes: tuple[ContinuousAxis | CategoricalAxis, ...]
    build: Callable[[dict], Policy]
    from_params: Callable[[dict], dict | None] | None = None

    def coarse_points(self) -> list[dict]:
        levels = [(ax.name, ax.coarse if isinstance(ax, ContinuousAxis)
                   else ax.options) for ax in self.axes]
        return [dict(zip([n for n, _ in levels], combo))
                for combo in itertools.product(*[v for _, v in levels])]

    def clip_point(self, pt: dict) -> dict | None:
        """Validate a seed point against the axes: categorical values must
        be known options (a retired pool shape cannot be refined), and
        continuous values clip into the axis range so refinement stays
        well-defined."""
        out = {}
        for ax in self.axes:
            if ax.name not in pt:
                return None
            v = pt[ax.name]
            if isinstance(ax, CategoricalAxis):
                if v not in ax.options:
                    return None
                out[ax.name] = v
            else:
                out[ax.name] = min(max(float(v), ax.lo), ax.hi)
        return out


def _build_downscale(pt: dict) -> Policy:
    return DownscalePolicy(config=ControllerConfig(
        threshold_x_s=pt["threshold_x_s"], cooldown_y_s=pt["cooldown_y_s"],
        mode=pt["mode"]))


def _build_parking(pt: dict) -> Policy:
    n_devices, n_active = pt["pool"]
    return ParkingPolicy(
        pool=PoolConfig(n_devices=n_devices, policy=PoolPolicy.CONSOLIDATED,
                        n_active=n_active),
        resume_latency_s=pt["resume_latency_s"])


def _build_powercap(pt: dict) -> Policy:
    return PowerCapPolicy(cap_fraction=pt["cap_fraction"])


def _build_park_downscale(pt: dict) -> Policy:
    n_devices, n_active = pt["pool"]
    return CompositePolicy((
        ParkingPolicy(
            pool=PoolConfig(n_devices=n_devices,
                            policy=PoolPolicy.CONSOLIDATED,
                            n_active=n_active),
            resume_latency_s=pt["resume_latency_s"]),
        DownscalePolicy(config=ControllerConfig(
            threshold_x_s=pt["threshold_x_s"])),
    ))


def _downscale_from_params(p: dict) -> dict | None:
    if p.get("policy") != "downscale":
        return None
    return {"threshold_x_s": p["threshold_x_s"],
            "cooldown_y_s": p["cooldown_y_s"],
            "mode": DownscaleMode(p["mode"])}


def _parking_from_params(p: dict) -> dict | None:
    if p.get("policy") != "parking":
        return None
    return {"pool": (p["n_devices"], p["n_active"]),
            "resume_latency_s": p["resume_latency_s"]}


def _powercap_from_params(p: dict) -> dict | None:
    if p.get("policy") != "powercap":
        return None
    return {"cap_fraction": p["cap_fraction"]}


def _park_downscale_from_params(p: dict) -> dict | None:
    if p.get("policy") != "composite" or len(p.get("parts", ())) != 2:
        return None
    park, down = p["parts"]
    if park.get("policy") != "parking" or down.get("policy") != "downscale":
        return None
    return {"pool": (park["n_devices"], park["n_active"]),
            "resume_latency_s": park["resume_latency_s"],
            "threshold_x_s": down["threshold_x_s"]}


def default_families(composites: bool = True) -> list[PolicyFamily]:
    """The searchable mirror of :func:`~repro_torch.whatif.sweep
    .default_policy_grid`: same families, same knob ranges, but coarse seeds
    instead of dense levels — the refinement loop supplies the density, and
    only where the Pareto knee needs it.

    ``composites=True`` adds the operator's composite ("Model Parking Tax"
    meets Algorithm 1): park the pool's inactive devices, downscale the
    active rest — a point the fixed grid cannot express at all.
    """
    families = [
        PolicyFamily(
            name="downscale",
            axes=(
                ContinuousAxis("threshold_x_s", 0.5, 15.0,
                               coarse=(0.5, 3.0, 15.0), log=True),
                ContinuousAxis("cooldown_y_s", 1.0, 10.0,
                               coarse=(1.0, 10.0), log=True),
                CategoricalAxis("mode", (DownscaleMode.SM_ONLY,
                                         DownscaleMode.SM_AND_MEM)),
            ),
            build=_build_downscale, from_params=_downscale_from_params),
        PolicyFamily(
            name="parking",
            axes=(
                CategoricalAxis("pool", ((4, 1), (4, 2), (4, 3),
                                         (8, 2), (8, 4), (8, 6))),
                ContinuousAxis("resume_latency_s", 2.0, 60.0,
                               coarse=(2.0, 60.0), log=True),
            ),
            build=_build_parking, from_params=_parking_from_params),
        PolicyFamily(
            name="powercap",
            axes=(
                ContinuousAxis("cap_fraction", 0.25, 0.95,
                               coarse=(0.25, 0.6, 0.95), resolution=0.005),
            ),
            build=_build_powercap, from_params=_powercap_from_params),
    ]
    if composites:
        families.append(PolicyFamily(
            name="park+downscale",
            axes=(
                CategoricalAxis("pool", ((4, 1), (4, 2), (8, 4))),
                ContinuousAxis("resume_latency_s", 2.0, 60.0,
                               coarse=(10.0,), log=True),
                ContinuousAxis("threshold_x_s", 0.5, 15.0,
                               coarse=(1.0, 8.0), log=True),
            ),
            build=_build_park_downscale,
            from_params=_park_downscale_from_params))
    return families


# --------------------------------------------------------------------------- #
# Knee detection
# --------------------------------------------------------------------------- #
def _normalizer(outcomes: Sequence[PolicyOutcome]):
    s = [o.energy_saved_j for o in outcomes]
    p = [o.penalty_s for o in outcomes]
    s_lo, s_span = min(s), max(s) - min(s)
    p_lo, p_span = min(p), max(p) - min(p)

    def norm(o: PolicyOutcome) -> tuple[float, float]:
        return ((o.energy_saved_j - s_lo) / s_span if s_span else 0.0,
                (o.penalty_s - p_lo) / p_span if p_span else 0.0)
    return norm


def find_knee(outcomes: Sequence[PolicyOutcome]) -> PolicyOutcome:
    """The Pareto front's point of diminishing returns.

    Pareto-filter the outcomes, normalize saved energy and penalty to the
    front's extents, and take the member with the maximum perpendicular
    distance above the chord joining the front's endpoints (the classic
    elbow/kneedle construction). Degenerate fronts (fewer than three
    members, or a flat chord) fall back to the member maximizing
    ``saved_norm - penalty_norm``. Deterministic: ties keep the
    lowest-penalty member.
    """
    if not outcomes:
        raise ValueError("find_knee requires at least one outcome")
    flags = pareto_flags([o.energy_saved_j for o in outcomes],
                         [o.penalty_s for o in outcomes])
    front = [o for o, f in zip(outcomes, flags) if f]
    front.sort(key=lambda o: (o.penalty_s, -o.energy_saved_j))
    norm = _normalizer(front)
    if len(front) >= 3:
        (s0, p0), (s1, p1) = norm(front[0]), norm(front[-1])
        ds, dp = s1 - s0, p1 - p0
        chord = math.hypot(ds, dp)
        if chord > 0:
            best_i, best_d = 0, -math.inf
            for i, o in enumerate(front):
                s, p = norm(o)
                d = (dp * (s - s0) - ds * (p - p0)) / chord
                if d > best_d + 1e-12:
                    best_i, best_d = i, d
            return front[best_i]
    best_i, best_u = 0, -math.inf
    for i, o in enumerate(front):
        s, p = norm(o)
        if s - p > best_u + 1e-12:
            best_i, best_u = i, s - p
    return front[best_i]


def achievable_saving(outcomes: Iterable[PolicyOutcome],
                      max_penalty_s: float) -> float:
    """Best ``saved_fraction`` among outcomes with ``penalty_s`` within
    ``max_penalty_s`` — the scalar used to compare two frontiers at a common
    operating point (e.g. a search frontier vs a dense sweep, at the dense
    knee's penalty)."""
    ok = [o.saved_fraction for o in outcomes if o.penalty_s <= max_penalty_s]
    return max(ok, default=0.0)


# --------------------------------------------------------------------------- #
# Search loop
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One refinement round's accounting."""

    n_new: int
    n_evals_total: int
    knee_saved_fraction: float
    knee_penalty_s: float
    knee_params: dict


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Outcome of a :func:`search_frontier` run."""

    #: every evaluated config (evaluation order), Pareto subset flagged
    frontier: Frontier
    #: the front's point of diminishing returns (:func:`find_knee`)
    knee: PolicyOutcome
    #: highest-saving config within the budget; the knee when no budget was
    #: given; None when no evaluated config is feasible
    best: PolicyOutcome | None
    n_evals: int
    n_rounds: int
    #: True when the loop stopped because the knee stopped moving or every
    #: axis reached resolution — False when it ran out of eval budget/rounds
    converged: bool
    history: tuple[RoundRecord, ...]


def _key(policy: Policy) -> str:
    return json.dumps(policy.describe(), sort_keys=True, default=str)


def _neighbor_mids(axis: ContinuousAxis, value: float,
                   tried: Sequence[float]) -> list[float]:
    """Midpoints between ``value`` and its nearest tried neighbours on each
    side, respecting the axis resolution."""
    mids = []
    below = [v for v in tried if v < value]
    above = [v for v in tried if v > value]
    if below:
        left = max(below)
        if axis.gap(left, value) > 2 * axis.resolution:
            mids.append(axis.midpoint(left, value))
    if above:
        right = min(above)
        if axis.gap(value, right) > 2 * axis.resolution:
            mids.append(axis.midpoint(value, right))
    return mids


def seed_points(families: Sequence[PolicyFamily], frontier: "Frontier | str",
                per_family: int = 3) -> dict[str, list[dict]]:
    """Warm-start seeds: map a previous frontier's Pareto members back into
    each family's knob space (via :attr:`PolicyFamily.from_params`),
    dropping members whose categorical knobs are no longer searchable and
    clipping continuous knobs into the current axis ranges. Members are
    taken knee-outward — the previous knee seeds first — capped at
    ``per_family`` so round 0 stays close to the coarse-grid size:
    week-over-week re-searches start *at* last snapshot's knee instead of
    re-discovering it through refinement rounds."""
    if not hasattr(frontier, "outcomes"):
        from repro_torch.whatif.report import load_frontier
        frontier = load_frontier(frontier)
    members = frontier.pareto_set() or list(frontier.outcomes)
    if len(members) > 1:
        knee = find_knee(members)
        norm = _normalizer(members)
        ks, kp = norm(knee)

        def knee_dist(o: PolicyOutcome) -> float:
            s, p = norm(o)
            return math.hypot(s - ks, p - kp)
        members = sorted(members, key=knee_dist)
    seeds: dict[str, list[dict]] = {}
    for fam in families:
        if fam.from_params is None:
            continue
        pts: list[dict] = []
        for o in members:
            pt = fam.from_params(o.params)
            if pt is None:
                continue
            pt = fam.clip_point(pt)
            if pt is not None and pt not in pts:
                pts.append(pt)
            if len(pts) >= per_family:
                break
        if pts:
            seeds[fam.name] = pts
    return seeds




def search_frontier(
    store: "TelemetryStore",
    budget: PenaltyBudget | None = None,
    families: Sequence[PolicyFamily] | None = None,
    max_evals: int = 100,
    max_rounds: int = 8,
    knee_tol: float = 0.01,
    knee_patience: int = 2,
    anchors_per_family: int = 2,
    include_noop: bool = True,
    workers: int = 1,
    hosts: Iterable[str] | None = None,
    mmap: bool = False,
    batched: bool = True,
    compact: bool | None = None,
    ir=None,
    backend: str = "torch",
    device: str = "cuda",
    dist=None,
    init_frontier=None,
    strict: bool = True,
    verify: bool = False,
    fault=None,
    **replayer_kwargs,
) -> SearchResult:
    """Budgeted closed-loop knob search over a telemetry store.

    Round 0 evaluates every family's coarse grid in one batched replay
    (:func:`repro_torch.whatif.sweep.evaluate` is the inner loop). Each
    later round (a) Pareto-filters everything evaluated so far and finds the
    knee (:func:`find_knee`), (b) picks per-family anchors — the family's
    Pareto members nearest the knee, plus its best budget-feasible member
    when a ``budget`` is given — and (c) proposes midpoint subdivisions of
    each continuous axis around every anchor. The loop stops when the
    config-evaluation budget ``max_evals`` is spent, the knee moves less
    than ``knee_tol`` (relative, both coordinates) for ``knee_patience``
    consecutive rounds, no axis can be subdivided above its resolution, or
    ``max_rounds`` is reached.

    With the compact path on (``compact=None`` follows ``batched``), the
    run-level IR is acquired **once** — memory cache, store sidecar, or one
    O(rows) build — and every refinement round replays against it, so
    rounds cost O(runs x new configs) instead of re-streaming and
    re-classifying the store (:mod:`repro_torch.whatif.ir`). Pass ``ir=`` to
    reuse one across searches. ``backend="torch"`` (the default) replays
    every IR-capable config on ``device`` (``"cuda"`` by default, raising
    without CUDA; ``"cpu"`` runs the kernels' plain versions);
    ``backend="numpy"`` is the host oracle. On both, configs and stores the
    IR cannot carry replay on the row path.

    ``init_frontier`` (a :class:`~repro_torch.whatif.sweep.Frontier` or a
    saved frontier JSON path) warm-starts the search: the previous
    frontier's Pareto members seed round 0 alongside the coarse grids
    (:func:`seed_points`), so a week-over-week re-search reaches its knee
    in fewer evaluations.

    Determinism: candidates are generated in family/axis order from sorted
    tried-value sets and evaluated through the batched replay, so a search
    is the same on every run and for any ``workers``, and evaluates the
    same configs in the same order on either backend
    (tests/test_torch_search.py).

    Returns a :class:`SearchResult`; its ``frontier`` holds every evaluated
    config with the Pareto subset flagged, ``best`` answers the operator's
    budget question directly.

    ``strict`` / ``verify`` / ``fault`` are :func:`repro_torch.whatif.sweep
    .evaluate`'s dirty-telemetry knobs: ``strict=False`` skips unreadable
    shards (the returned frontier's ``coverage`` reports the replayed
    fraction), ``verify=True`` checksums every shard read, ``fault`` tunes
    the pool crash/hang supervisor. ``dist`` shards the torch backend's
    config axis over a mesh (:func:`repro_torch.whatif.sweep.evaluate`);
    ``backend="jax"`` raises a ``ValueError``.
    """
    if max_evals < 1:
        raise ValueError(f"max_evals must be >= 1, got {max_evals}")
    backend = resolve_backend(backend)
    families = (default_families() if families is None else list(families))
    names = [f.name for f in families]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate family names: {names}")
    hosts = list(hosts) if hosts is not None else None
    if compact is None:
        compact = batched
    with obs.span("whatif.search", backend=backend, max_evals=max_evals):
        return _search_loop(
            store, budget, families, max_evals, max_rounds, knee_tol,
            knee_patience, anchors_per_family, include_noop, workers, hosts,
            mmap, batched, compact, ir, backend, device, init_frontier,
            replayer_kwargs, strict=strict, verify=verify, fault=fault, dist=dist)


def _search_loop(
    store: "TelemetryStore",
    budget: PenaltyBudget | None,
    families: Sequence[PolicyFamily],
    max_evals: int,
    max_rounds: int,
    knee_tol: float,
    knee_patience: int,
    anchors_per_family: int,
    include_noop: bool,
    workers: int,
    hosts: Iterable[str] | None,
    mmap: bool,
    batched: bool,
    compact: bool,
    ir,
    backend: str,
    device: str,
    init_frontier,
    replayer_kwargs: dict,
    strict: bool = True,
    verify: bool = False,
    fault=None,
    dist=None,
) -> SearchResult:
    """The :func:`search_frontier` loop body (arguments already resolved).

    Split out so the public entry point can hold the ``whatif.search``
    observability span without re-indenting the whole loop."""
    # evaluation state, keyed by the built policy's canonical describe()
    outcomes: dict[str, PolicyOutcome] = {}
    point_of: dict[str, tuple[str, dict]] = {}     # key -> (family, point)
    order: list[str] = []                          # evaluation order
    tried: dict[tuple[str, str], set[float]] = {}  # (family, axis) -> values
    n_rows = 0
    n_runs = 0
    round_no = 0
    last_skips: list[dict] = []
    # deterministic convergence record (one entry per eval, all rounds) —
    # replay results only, no wall-clock, so frontiers stay bit-identical
    # with obs on or off
    trace: list[dict] = []

    def build_candidates(fam: PolicyFamily, points: list[dict]):
        cands = []
        for pt in points:
            pol = fam.build(pt)
            key = _key(pol)
            if key in outcomes or any(key == k for k, _ in cands):
                continue
            cands.append((key, (fam.name, pt, pol)))
        return cands

    def evaluate_round(cands) -> int:
        nonlocal n_rows, n_runs, last_skips
        if not cands:
            return 0
        pols = [pol for _, (_, _, pol) in cands]
        with obs.span("search.round", round=round_no, new=len(cands)):
            outs, rows, runs, skips = _evaluate_outcomes(
                pols, store, workers=workers, hosts=hosts, mmap=mmap,
                batched=batched, replayer_kwargs=replayer_kwargs,
                compact=compact, ir=ir, backend=backend, device=device,
                dist=dist, strict=strict, verify=verify, fault=fault)
        n_rows = rows
        n_runs = max(n_runs, runs)
        if skips:
            last_skips = skips
        for (key, (fam_name, pt, _)), out in zip(cands, outs):
            outcomes[key] = out
            point_of[key] = (fam_name, pt)
            order.append(key)
            trace.append({"i": len(order) - 1, "round": round_no,
                          "family": fam_name,
                          "saved_fraction": out.saved_fraction,
                          "penalty_s": out.penalty_s})
            for ax_name, v in pt.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    tried.setdefault((fam_name, ax_name), set()).add(float(v))
        obs.counter("repro_search_evals_total", float(len(cands)),
                    help="policy configs evaluated by the closed-loop search")
        obs.counter("repro_search_rounds_total",
                    help="search evaluation rounds (round 0 included)")
        obs.gauge("repro_search_budget_remaining",
                  float(max_evals - len(order)),
                  help="eval budget left after the last search round")
        return len(cands)

    # ---------------- round 0: coarse grids (+ warm-start seeds) -------- #
    round0: list[tuple[str, tuple]] = []
    if include_noop:
        noop = NoOpPolicy()
        round0.append((_key(noop), ("noop", {}, noop)))
    for fam in families:
        round0.extend(build_candidates(fam, fam.coarse_points()))
    if len(round0) > max_evals:
        raise ValueError(
            f"max_evals={max_evals} cannot cover the coarse grids "
            f"({len(round0)} configs); raise the budget or thin the "
            f"families' coarse levels")
    if init_frontier is not None:
        # warm-start seeds ride along only as far as the eval budget
        # allows — the coarse grids keep priority, so a budget that was
        # valid cold can never become invalid warm
        seeds = seed_points(families, init_frontier)
        round0_keys = {k for k, _ in round0}
        seed_cands = [
            c for fam in families
            for c in build_candidates(fam, seeds.get(fam.name, []))
            if c[0] not in round0_keys]
        seed_cands = seed_cands[:max_evals - len(round0)]
        if seed_cands:
            obs.counter("repro_search_warm_seed_hits_total",
                        float(len(seed_cands)),
                        help="warm-start seeds admitted into round 0")
        round0.extend(seed_cands)

    # acquire the shared IR handle ONCE (memory cache / sidecar /
    # incremental extend / one O(rows) build) and thread it through every
    # refinement round: rounds then skip get_ir's freshness re-validation
    # entirely, and a store that grows mid-search cannot shear the search
    # across two IR generations. Configs the handle's config cannot cover
    # fall back per-config to the row path inside the evaluator.
    if compact and ir is None:
        from repro_torch.core.states import DEFAULT_CLASSIFIER
        from repro_torch.whatif import ir as ir_mod
        pols0 = [pol for _, (_, _, pol) in round0]
        cfg = ir_mod.ir_config_for(
            pols0, replayer_kwargs.get("classifier") or DEFAULT_CLASSIFIER,
            replayer_kwargs.get("dt_s", 1.0))
        if any(ir_mod.ir_supported(p, cfg) for p in pols0):
            try:
                ir = ir_mod.get_ir(store, cfg, workers=workers, mmap=mmap,
                                   strict=strict, verify=verify, fault=fault)
            except ir_mod.IRUnsupportedError:
                ir = None          # e.g. irregular sampling: use rows
                obs.fallback("compact", "row", "ir_unsupported")

    evaluate_round(round0)

    history: list[RoundRecord] = []
    knee = find_knee(list(outcomes.values()))
    history.append(RoundRecord(
        n_new=len(order), n_evals_total=len(order),
        knee_saved_fraction=knee.saved_fraction, knee_penalty_s=knee.penalty_s,
        knee_params=knee.params))

    def record_knee(k: PolicyOutcome) -> None:
        obs.gauge("repro_search_knee_saved_fraction", k.saved_fraction,
                  help="saved fraction at the current Pareto knee")
        obs.gauge("repro_search_knee_penalty_s", k.penalty_s,
                  help="penalty seconds at the current Pareto knee")

    record_knee(knee)

    # ---------------- refinement rounds ---------------- #
    def close(a: float, b: float) -> bool:
        return abs(a - b) <= knee_tol * max(abs(a), abs(b), 1e-12)

    converged = False
    stable = 0
    by_fam: dict[str, list[str]] = {}
    while len(history) - 1 < max_rounds:
        round_no = len(history)
        all_outcomes = [outcomes[k] for k in order]
        flags = pareto_flags([o.energy_saved_j for o in all_outcomes],
                             [o.penalty_s for o in all_outcomes])
        pareto_keys = {k for k, f in zip(order, flags) if f}
        norm = _normalizer(all_outcomes)
        ks, kp = norm(knee)

        def knee_dist(key: str) -> float:
            s, p = norm(outcomes[key])
            return math.hypot(s - ks, p - kp)

        by_fam.clear()
        for k in order:
            by_fam.setdefault(point_of[k][0], []).append(k)

        candidates: list[tuple[str, tuple]] = []
        for fam in families:
            keys = by_fam.get(fam.name, [])
            if not keys:
                continue
            anchors = sorted((k for k in keys if k in pareto_keys),
                             key=knee_dist)[:anchors_per_family]
            if not anchors:
                # no Pareto member: refine the family's most competitive
                # point so a coarse miss can still recover
                anchors = sorted(keys, key=knee_dist)[:1]
            if budget is not None:
                feas = [k for k in keys if budget.feasible(outcomes[k])]
                if feas:
                    best_f = max(feas,
                                 key=lambda k: outcomes[k].energy_saved_j)
                    if best_f not in anchors:
                        anchors.append(best_f)
            points = []
            for akey in anchors:
                _, apt = point_of[akey]
                for ax in fam.axes:
                    if not isinstance(ax, ContinuousAxis):
                        continue
                    vals = sorted(tried.get((fam.name, ax.name), ()))
                    for mid in _neighbor_mids(ax, float(apt[ax.name]), vals):
                        points.append({**apt, ax.name: mid})
            candidates.extend(build_candidates(fam, points))

        room = max_evals - len(order)
        if not candidates:
            converged = True
            break
        if room <= 0:
            break
        new = evaluate_round(candidates[:room])
        prev = knee
        knee = find_knee(list(outcomes.values()))
        record_knee(knee)
        history.append(RoundRecord(
            n_new=new, n_evals_total=len(order),
            knee_saved_fraction=knee.saved_fraction,
            knee_penalty_s=knee.penalty_s, knee_params=knee.params))
        if (close(prev.saved_fraction, knee.saved_fraction)
                and close(prev.penalty_s, knee.penalty_s)):
            stable += 1
            if stable >= knee_patience:
                converged = True
                break
        else:
            stable = 0
            obs.counter("repro_search_knee_moves_total",
                        help="refinement rounds that moved the knee beyond "
                             "knee_tol")
        if new < len(candidates):      # budget truncated the round
            break

    coverage = _coverage_of(store, hosts, last_skips)
    obs.gauge("repro_coverage_fraction", coverage, stage="search",
              help="rows analyzed / rows on disk for the last run")
    frontier = assemble_frontier([outcomes[k] for k in order], n_rows, n_runs,
                                 trace=trace, coverage=coverage)
    final_outcomes = list(frontier.outcomes)
    knee = find_knee(final_outcomes)
    if budget is None:
        best: PolicyOutcome | None = knee
    else:
        feasible = [o for o in final_outcomes if budget.feasible(o)]
        best = (max(feasible, key=lambda o: o.energy_saved_j)
                if feasible else None)
    return SearchResult(
        frontier=frontier,
        knee=knee,
        best=best,
        n_evals=len(order),
        n_rounds=len(history),
        converged=converged,
        history=tuple(history),
    )
