"""The port's closed-loop what-if search against the JAX package's.

Mirrors tests/test_whatif_search.py case by case on the same fixture
(``generate_cluster(n_devices=8, horizon_s=2700, seed=3, shard_s=900)``),
written once by each package. Every search of the port runs on the torch
backend on the CPU (the kernels' plain versions) and is held against the
reference's search on its NumPy backend, the oracle, over the same store:
the same configs evaluated in the same order, the same rounds, trace, knee
and budget answer; counts and times exact, energies and penalties within
1e-9 relative (the torch backend sums in another order).

Also: the O(n log n) ``pareto_flags`` against the reference's pairwise
loop, with ties, duplicates, NaN, infinities and -0.0.
"""
import json
import math
import tempfile

import numpy as np
import pytest
from _hyp import given, settings, st

from repro.cluster import generate_cluster as ref_generate_cluster
from repro.telemetry import TelemetryStore as RefStore
from repro.whatif import search as ref_search
from repro.whatif import sweep as ref_sweep

from repro_torch.cluster import generate_cluster
from repro_torch.telemetry import TelemetryStore
from repro_torch.whatif import (CategoricalAxis, ContinuousAxis, PenaltyBudget,
                                PolicyFamily, PolicyOutcome, PowerCapPolicy,
                                achievable_saving, default_families,
                                default_policy_grid, evaluate, find_knee,
                                frontier_to_dict, pareto_flags, run_sweep,
                                search_frontier, seed_points)
from repro_torch.whatif.sweep import DROPPED_ARGUMENTS, assemble_frontier

FIXTURE = dict(n_devices=8, horizon_s=2700, seed=3, shard_s=900)
RTOL = ATOL = 1e-9          # the reference's oracle tolerance for float fields
EXACT_FIELDS = ("name", "params", "n_jobs", "wake_events",
                "downscale_events", "throttled_time_s", "pareto")
FLOAT_FIELDS = ("baseline_energy_j", "counterfactual_energy_j",
                "energy_saved_j", "saved_fraction", "penalty_s",
                "penalty_fraction", "exec_idle_energy_fraction_baseline",
                "exec_idle_energy_fraction_cf")
#: the port's searches: torch backend, kernels' plain versions on the CPU
TORCH = dict(backend="torch", device="cpu", min_job_duration_s=0.0)
#: the reference's oracle
ORACLE = dict(backend="numpy", min_job_duration_s=0.0)


@pytest.fixture(scope="module")
def stores():
    """(reference store, port store), written from the same seed."""
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d:
        ref_generate_cluster(store=RefStore(d_ref), **FIXTURE)
        generate_cluster(store=TelemetryStore(d), **FIXTURE)
        assert len({s["host"] for s in TelemetryStore(d).manifest["shards"]}) > 1
        yield RefStore(d_ref), TelemetryStore(d)


@pytest.fixture(scope="module")
def default_searches(stores):
    """The default search (no budget, every default family) on both sides."""
    ref_store, store = stores
    return (ref_search.search_frontier(ref_store, **ORACLE),
            search_frontier(store, **TORCH))


def close(a, b) -> bool:
    return bool(np.isclose(a, b, rtol=RTOL, atol=ATOL))


def assert_outcome_matches(ref, out):
    for f in EXACT_FIELDS:
        assert getattr(ref, f) == getattr(out, f), (ref.name, ref.params, f)
    for f in FLOAT_FIELDS:
        assert close(getattr(ref, f), getattr(out, f)), (ref.name, ref.params, f)
    for f in ("per_job_saved_fraction", "per_job_penalty_s"):
        np.testing.assert_allclose(getattr(out, f), getattr(ref, f), rtol=RTOL, atol=ATOL)


def assert_frontier_matches(ref, out):
    """Same outcomes in the same order (Pareto flags included), same
    counts, the same trace."""
    assert (ref.n_rows, ref.n_jobs, ref.n_runs, ref.coverage) == \
        (out.n_rows, out.n_jobs, out.n_runs, out.coverage)
    assert len(ref.outcomes) == len(out.outcomes)
    for a, b in zip(ref.outcomes, out.outcomes):
        assert_outcome_matches(a, b)
    assert len(ref.trace) == len(out.trace)
    for a, b in zip(ref.trace, out.trace):
        assert (a["i"], a["round"], a["family"]) == (b["i"], b["round"], b["family"])
        assert close(a["saved_fraction"], b["saved_fraction"])
        assert close(a["penalty_s"], b["penalty_s"])


def assert_search_matches(ref, out):
    """A port search against the reference's: frontier, rounds, knee, the
    budget answer and the convergence flag."""
    assert_frontier_matches(ref.frontier, out.frontier)
    assert (ref.n_evals, ref.n_rounds, ref.converged) == \
        (out.n_evals, out.n_rounds, out.converged)
    assert len(ref.history) == len(out.history)
    for a, b in zip(ref.history, out.history):
        assert (a.n_new, a.n_evals_total, a.knee_params) == \
            (b.n_new, b.n_evals_total, b.knee_params)
        assert close(a.knee_saved_fraction, b.knee_saved_fraction)
        assert close(a.knee_penalty_s, b.knee_penalty_s)
    assert_outcome_matches(ref.knee, out.knee)
    assert (ref.best is None) == (out.best is None)
    if ref.best is not None:
        assert_outcome_matches(ref.best, out.best)


def keys(frontier):
    return [json.dumps(o.params, sort_keys=True, default=str) for o in frontier.outcomes]


# --------------------------------------------------------------------------- #
# evaluate(): the kernel contract
# --------------------------------------------------------------------------- #
def test_evaluate_matches_run_sweep_outcomes(stores):
    ref_store, store = stores
    grid = default_policy_grid(dense=False)[:10]
    outcomes = evaluate(grid, store, **TORCH)
    assert len(outcomes) == len(grid)
    assert all(not o.pareto for o in outcomes)   # flags belong to sets
    swept = run_sweep(store, grid, **TORCH)
    flagged = assemble_frontier(outcomes, swept.n_rows, swept.n_runs)
    assert frontier_to_dict(flagged) == frontier_to_dict(swept)
    ref_grid = ref_sweep.default_policy_grid(dense=False)[:10]
    ref_outcomes = ref_sweep.evaluate(ref_grid, ref_store, **ORACLE)
    assert_frontier_matches(
        ref_sweep.assemble_frontier(ref_outcomes, swept.n_rows, swept.n_runs), flagged)


# --------------------------------------------------------------------------- #
# search: budget, knee, convergence
# --------------------------------------------------------------------------- #
def test_search_respects_eval_budget_and_flags_pareto(stores):
    ref_store, store = stores
    res = search_frontier(store, max_evals=50, **TORCH)
    assert res.n_evals <= 50
    assert res.n_evals == len(res.frontier.outcomes)
    assert res.n_rounds == len(res.history)
    assert res.history[-1].n_evals_total == res.n_evals
    # pareto soundness over everything evaluated
    for o in res.frontier.pareto_set():
        assert not any(
            p.energy_saved_j >= o.energy_saved_j
            and p.penalty_s <= o.penalty_s
            and (p.energy_saved_j > o.energy_saved_j
                 or p.penalty_s < o.penalty_s)
            for p in res.frontier.outcomes)
    # the noop anchor is present and untouched
    noop = next(o for o in res.frontier.outcomes if o.name == "noop")
    assert noop.energy_saved_j == 0.0 and noop.penalty_s == 0.0
    # knee is on the front, and without a budget best == knee
    assert res.knee.pareto
    assert res.best == res.knee
    assert_search_matches(ref_search.search_frontier(ref_store, max_evals=50, **ORACLE), res)


def test_search_refines_around_the_knee(default_searches):
    ref, res = default_searches
    assert res.n_rounds >= 2                      # refinement happened
    assert sum(r.n_new for r in res.history) == res.n_evals
    coarse = res.history[0].n_evals_total
    assert res.n_evals > coarse                   # beyond the coarse grids
    # refinement improves (or maintains) the knee's saved energy
    assert (res.history[-1].knee_saved_fraction
            >= res.history[0].knee_saved_fraction)
    assert_search_matches(ref, res)
    assert keys(res.frontier) == keys(ref.frontier)


def test_search_budget_feasibility(stores):
    ref_store, store = stores
    budget = PenaltyBudget(max_penalty_fraction=0.005)
    res = search_frontier(store, budget=budget, **TORCH)
    assert res.best is not None
    assert res.best.penalty_fraction <= 0.005
    # best is the max-saving feasible config over everything evaluated
    for o in res.frontier.outcomes:
        if budget.feasible(o):
            assert o.energy_saved_j <= res.best.energy_saved_j
    assert_search_matches(ref_search.search_frontier(
        ref_store, budget=ref_search.PenaltyBudget(max_penalty_fraction=0.005), **ORACLE),
        res)
    # an impossible budget yields best=None (noop excluded by its own bound)
    kw = dict(include_noop=False, max_evals=40, max_rounds=1)
    res2 = search_frontier(store, budget=PenaltyBudget(max_penalty_s=-0.0), **kw, **TORCH)
    assert all(not PenaltyBudget(max_penalty_s=-0.0).feasible(o)
               or o.penalty_s == 0.0 for o in res2.frontier.outcomes)
    assert_search_matches(ref_search.search_frontier(
        ref_store, budget=ref_search.PenaltyBudget(max_penalty_s=-0.0), **kw, **ORACLE),
        res2)


def test_search_deterministic_and_workers_bit_identical(stores, default_searches):
    """Two searches give the same bits, and so does one at ``workers=2``
    (as tests/test_whatif_search.py asserts of the reference); the port's
    NumPy backend equals the reference's search exactly (the same host
    code)."""
    ref_store, store = stores
    ref, a = default_searches
    b = search_frontier(store, **TORCH)
    assert frontier_to_dict(a.frontier) == frontier_to_dict(b.frontier)
    assert a.knee.params == b.knee.params
    assert a.n_evals == b.n_evals
    c = search_frontier(store, workers=2, **TORCH)
    assert frontier_to_dict(a.frontier) == frontier_to_dict(c.frontier)
    assert a.knee.params == c.knee.params
    assert a.n_evals == c.n_evals
    host = search_frontier(store, **ORACLE)
    assert frontier_to_dict(host.frontier) == frontier_to_dict(ref.frontier)


def test_search_tracks_dense_sweep_at_the_knee(stores):
    """The acceptance property at test scale: the searched front's
    achievable saving at its knee penalty is within tolerance of (or better
    than) the dense 200-config sweep's at the same operating point."""
    ref_store, store = stores
    res = search_frontier(store, families=default_families(composites=False), **TORCH)
    dense = run_sweep(store, **TORCH)
    at_knee_dense = achievable_saving(dense.outcomes, res.knee.penalty_s)
    assert res.knee.saved_fraction >= at_knee_dense - 0.02
    assert res.n_evals <= 100        # <= 50% of the 200-config dense grid
    assert_search_matches(ref_search.search_frontier(
        ref_store, families=ref_search.default_families(composites=False), **ORACLE), res)


# --------------------------------------------------------------------------- #
# knee detection
# --------------------------------------------------------------------------- #
def _out(cls, saved, pen, baseline=100.0):
    return cls(
        name="x", params={"saved": saved, "pen": pen}, n_jobs=1,
        baseline_energy_j=baseline, counterfactual_energy_j=baseline - saved,
        energy_saved_j=saved, saved_fraction=saved / baseline, penalty_s=pen,
        penalty_fraction=pen / 100.0, wake_events=0, downscale_events=0,
        throttled_time_s=0.0, exec_idle_energy_fraction_baseline=0.0,
        exec_idle_energy_fraction_cf=0.0, per_job_saved_fraction=(),
        per_job_penalty_s=())


def test_find_knee_picks_the_elbow():
    def knees(points):
        ours = find_knee([_out(PolicyOutcome, s, p) for s, p in points])
        ref = ref_search.find_knee([_out(ref_sweep.PolicyOutcome, s, p) for s, p in points])
        assert ours.params == ref.params
        return ours

    # a sharp elbow at (10, 9): near-vertical rise then a flat tail
    points = [(0.0, 0.0), (5.0, 4.0), (9.0, 10.0), (9.5, 50.0), (10.0, 100.0)]
    assert knees(points).energy_saved_j == 9.0
    # dominated points never win
    assert knees(points + [(1.0, 90.0)]).energy_saved_j == 9.0
    # degenerate: single point; a flat chord; ties keep the lowest penalty
    assert knees([(3.0, 1.0)]).energy_saved_j == 3.0
    assert knees([(1.0, 1.0), (1.0, 1.0), (2.0, 2.0)]).energy_saved_j == 1.0
    knees([(0.0, 0.0), (2.0, 1.0), (4.0, 2.0), (6.0, 3.0)])
    with pytest.raises(ValueError):
        find_knee([])


def test_achievable_saving():
    os_ = [_out(PolicyOutcome, s, p, baseline=1.0)
           for s, p in ((0.1, 1.0), (0.3, 5.0), (0.2, 2.0))]
    assert achievable_saving(os_, 2.5) == 0.2
    assert achievable_saving(os_, 0.5) == 0.0
    assert achievable_saving(os_, 10.0) == 0.3


# --------------------------------------------------------------------------- #
# family/axis validation and custom families
# --------------------------------------------------------------------------- #
def test_axis_validation():
    with pytest.raises(ValueError, match="lo must be < hi"):
        ContinuousAxis("x", 2.0, 1.0, coarse=(1.5,))
    with pytest.raises(ValueError, match="log axis"):
        ContinuousAxis("x", 0.0, 1.0, coarse=(0.5,), log=True)
    with pytest.raises(ValueError, match="outside"):
        ContinuousAxis("x", 1.0, 2.0, coarse=(3.0,))
    with pytest.raises(ValueError, match="non-empty"):
        CategoricalAxis("m", ())
    with pytest.raises(ValueError, match="max_evals"):
        search_frontier(None, max_evals=0)
    with pytest.raises(ValueError, match=">= 0"):
        PenaltyBudget(max_penalty_s=-1.0)
    with pytest.raises(ValueError, match="duplicate family names"):
        search_frontier(None, families=default_families() * 2)


def test_custom_single_family_search(stores):
    ref_store, store = stores

    def family(pkg_axis, pkg_family, cap_policy):
        return pkg_family(
            name="caps",
            axes=(pkg_axis("cap_fraction", 0.3, 0.9, coarse=(0.3, 0.9), resolution=0.01),),
            build=lambda pt: cap_policy(cap_fraction=pt["cap_fraction"]))

    fam = family(ContinuousAxis, PolicyFamily, PowerCapPolicy)
    res = search_frontier(store, families=[fam], max_evals=20, **TORCH)
    assert res.n_evals <= 20
    names = {o.name for o in res.frontier.outcomes}
    assert names == {"noop", "powercap"}
    # the midpoint refinement actually subdivided the cap axis
    caps = sorted(o.params["cap_fraction"]
                  for o in res.frontier.outcomes if o.name == "powercap")
    assert len(caps) > 2
    assert any(0.3 < c < 0.9 for c in caps)
    from repro.whatif import PowerCapPolicy as RefCap
    assert_search_matches(ref_search.search_frontier(
        ref_store, families=[family(ref_search.ContinuousAxis, ref_search.PolicyFamily,
                                    RefCap)], max_evals=20, **ORACLE), res)
    # coarse grids exceeding the budget are rejected up front
    with pytest.raises(ValueError, match="coarse grids"):
        search_frontier(store, families=[fam], max_evals=2, **TORCH)


# --------------------------------------------------------------------------- #
# the port's own surface
# --------------------------------------------------------------------------- #
def _pool_and_path_value(name, ref):
    """A non-default value of one of the JAX package's pool, read and path
    arguments, built from the reference's classes (``ref``) or the
    port's."""
    if name == "fault":
        from repro.telemetry import FaultTolerance as RefFault
        from repro_torch.telemetry import FaultTolerance
        return (RefFault if ref else FaultTolerance)(max_retries=1)
    return {"workers": 2, "mmap": True, "batched": False,
            "compact": False}[name]


@pytest.mark.parametrize("name", ("workers", "mmap", "batched", "compact",
                                  "dist", "fault"))
def test_search_rejects_dropped_arguments(stores, name):
    """The JAX package's pool, read and path arguments, one case each. The
    config-axis mesh ``dist`` is not ported (:data:`DROPPED_ARGUMENTS`): it
    raises, naming itself, in the search and in the evaluate it calls. The
    other five are taken, and a search with each agrees with the
    reference's search given the same argument."""
    ref_store, store = stores
    if name in DROPPED_ARGUMENTS:
        with pytest.raises(TypeError, match=name):
            search_frontier(store, **{name: 1}, **TORCH)
        with pytest.raises(TypeError, match=name):
            evaluate([PowerCapPolicy()], store, **{name: 1}, **TORCH)
        return
    kw = dict(max_rounds=1, max_evals=40,
              families=default_families(composites=False))
    out = search_frontier(store, **{name: _pool_and_path_value(name, False)},
                          **kw, **TORCH)
    ref = ref_search.search_frontier(
        ref_store, **{name: _pool_and_path_value(name, True)},
        max_rounds=1, max_evals=40,
        families=ref_search.default_families(composites=False), **ORACLE)
    assert_search_matches(ref, out)


def test_search_rejects_jax_backend(stores):
    _, store = stores
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        search_frontier(store, backend="jax", min_job_duration_s=0.0)


def test_search_warm_start_matches_reference(stores, default_searches):
    """``init_frontier`` seeds round 0 from a saved frontier's Pareto members
    knee-outward: the same seeds, and the same search, as the reference's."""
    ref_store, store = stores
    ref, res = default_searches
    def plain(seeds):              # enums of either package by their values
        return {name: [{k: getattr(v, "value", v) for k, v in pt.items()} for pt in pts]
                for name, pts in seeds.items()}

    seeds = seed_points(default_families(), res.frontier)
    assert seeds and plain(seeds) == plain(
        ref_search.seed_points(ref_search.default_families(), ref.frontier))
    warm = search_frontier(store, init_frontier=res.frontier, max_evals=60, **TORCH)
    ref_warm = ref_search.search_frontier(ref_store, init_frontier=ref.frontier,
                                          max_evals=60, **ORACLE)
    assert_search_matches(ref_warm, warm)


def test_search_budget_answer_at_one_percent(stores):
    """The operator's question, as chip_smoke.py asks it on the card: the
    best config within 1% of the recorded active time, and the knee."""
    ref_store, store = stores
    res = search_frontier(store, budget=PenaltyBudget(max_penalty_fraction=0.01), **TORCH)
    ref = ref_search.search_frontier(
        ref_store, budget=ref_search.PenaltyBudget(max_penalty_fraction=0.01), **ORACLE)
    assert_search_matches(ref, res)
    assert res.best.params == ref.best.params and res.knee.params == ref.knee.params


# --------------------------------------------------------------------------- #
# pareto_flags: O(n log n), the same flags as the pairwise loop
# --------------------------------------------------------------------------- #
#: few distinct values, so that ties and duplicates are common
VALUES = (-math.inf, -2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 2.0, 3.0, math.inf, math.nan)


@settings(max_examples=400, deadline=None)
@given(st.lists(st.integers(0, len(VALUES) - 1), min_size=0, max_size=30),
       st.lists(st.integers(0, len(VALUES) - 1), min_size=0, max_size=30))
def test_pareto_flags_match_pairwise_reference(si, pi):
    n = min(len(si), len(pi))
    saved = [VALUES[i] for i in si[:n]]
    penalty = [VALUES[i] for i in pi[:n]]
    assert pareto_flags(saved, penalty) == ref_sweep.pareto_flags(saved, penalty)


@pytest.mark.parametrize("seed", range(4))
def test_pareto_flags_match_pairwise_reference_seeded(seed):
    """Many seeded draws beside the property test (which may run on a
    five-example fallback where hypothesis is missing): ties, duplicates,
    NaN, infinities, -0.0 and continuous values, up to 60 points."""
    rng = np.random.default_rng(seed)
    for _ in range(500):
        n = int(rng.integers(0, 61))
        pools = [np.array(VALUES), np.round(rng.normal(size=8), 1), rng.normal(size=n)]
        saved = list(rng.choice(pools[int(rng.integers(0, 3))], n)) if n else []
        penalty = list(rng.choice(pools[int(rng.integers(0, 3))], n)) if n else []
        assert pareto_flags(saved, penalty) == ref_sweep.pareto_flags(saved, penalty)


def test_pareto_flags_edge_cases():
    nan, inf = math.nan, math.inf
    assert pareto_flags([], []) == []
    assert pareto_flags([1.0], [1.0]) == [True]
    # equal points do not dominate each other; a better one dominates both
    assert pareto_flags([1.0, 1.0], [2.0, 2.0]) == [True, True]
    assert pareto_flags([1.0, 1.0, 2.0], [2.0, 2.0, 1.0]) == [False, False, True]
    # NaN is never dominated and dominates nothing
    assert pareto_flags([nan, 0.0, 1.0], [0.0, 0.0, nan]) == [True, True, True]
    # -0.0 == 0.0; infinities compare as floats
    assert pareto_flags([-0.0, 0.0], [0.0, -0.0]) == [True, True]
    assert pareto_flags([inf, inf, 1.0], [inf, 1.0, -inf]) == [False, True, True]
    for saved, penalty in (([inf, inf], [inf, inf]), ([-inf, 0.0], [-inf, -inf])):
        assert pareto_flags(saved, penalty) == ref_sweep.pareto_flags(saved, penalty)


def test_pareto_flags_frontier_flags_match_reference_on_the_dense_grid(default_searches):
    """Over a real frontier's outcomes (the default search's), the flags
    the frontier carries are the pairwise loop's."""
    _, res = default_searches
    outs = res.frontier.outcomes
    assert [o.pareto for o in outs] == ref_sweep.pareto_flags(
        [o.energy_saved_j for o in outs], [o.penalty_s for o in outs])
