"""The port's what-if row path against the JAX package's.

The row path is host NumPy in both packages, a copy function for function,
so it must match bit for bit (tolerance 0): the interval helpers, the
per-policy ``PolicyReplayer`` and its merge, ``replay_store``, ``sweep_frame``
on a pool-DES frame, and ``run_sweep`` at ``batched=False``, at
``compact=False`` and at ``workers`` 1 and 2 against the reference's
``backend="numpy"`` with the same arguments (mirroring
tests/test_whatif.py and tests/test_whatif_batched.py).

The torch backend (here on the CPU, the kernels' plain versions) routes a
mixed grid as the reference routes its accelerator backend: the configs the
run-level IR can carry on the card, the rest on rows, counted. It meets the
what-if contract against the reference's NumPy oracle: times and counts
exact, floats within 1e-9. An error on its card path propagates.
"""
import dataclasses
import re
import tempfile
import types
import warnings

import numpy as np
import pytest

import repro.core.controller as r_controller
import repro.core.imbalance as r_imbalance
import repro.whatif as r_whatif
from repro.cluster import generate_cluster as ref_generate_cluster
from repro.core import intervals as ref_intervals
from repro.telemetry import TelemetryStore as RefStore
from repro.whatif import sweep as ref_sweep

import repro_torch.core.controller as controller
import repro_torch.core.imbalance as imbalance
import repro_torch.whatif as whatif
from repro_torch import obs
from repro_torch.cluster import generate_cluster
from repro_torch.core import intervals
from repro_torch.core.states import DeviceState
from repro_torch.telemetry import TelemetryStore
from repro_torch.whatif import backend as B
from repro_torch.whatif import ir as ir_mod
from repro_torch.whatif import sweep

FIXTURE = dict(n_devices=6, horizon_s=1500, seed=7, shard_s=500)
RTOL = ATOL = 1e-9          # the reference's oracle tolerance for float fields
EXACT_FIELDS = ("name", "params", "n_jobs", "wake_events",
                "downscale_events", "throttled_time_s")
FLOAT_FIELDS = ("baseline_energy_j", "counterfactual_energy_j",
                "energy_saved_j", "saved_fraction", "penalty_s",
                "penalty_fraction", "exec_idle_energy_fraction_baseline",
                "exec_idle_energy_fraction_cf")

PORT = types.SimpleNamespace(whatif=whatif, controller=controller,
                             imbalance=imbalance)
REF = types.SimpleNamespace(whatif=r_whatif, controller=r_controller,
                            imbalance=r_imbalance)


def as_dicts(outcomes):
    return [dataclasses.asdict(o) for o in outcomes]


def assert_contract(ref, out):
    """The what-if contract: exact fields equal, float fields within 1e-9."""
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        for f in EXACT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.name, a.params, f)
        for f in FLOAT_FIELDS:
            assert np.isclose(getattr(a, f), getattr(b, f), rtol=RTOL,
                              atol=ATOL), (a.name, a.params, f)
        for f in ("per_job_saved_fraction", "per_job_penalty_s"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=RTOL, atol=ATOL)


def small_grid(pkg):
    """One config of every family (tests/test_whatif.py's ``small_grid``)."""
    w, c, i = pkg.whatif, pkg.controller, pkg.imbalance
    return [
        w.NoOpPolicy(),
        w.DownscalePolicy(),
        w.DownscalePolicy(config=c.ControllerConfig(
            threshold_x_s=2.0, cooldown_y_s=3.0,
            mode=c.DownscaleMode.SM_AND_MEM)),
        w.ParkingPolicy(pool=i.PoolConfig(n_devices=4,
                                          policy=i.PoolPolicy.CONSOLIDATED,
                                          n_active=2)),
        w.PowerCapPolicy(cap_fraction=0.5),
    ]


def non_ir_configs(pkg):
    """Configs the run-level IR cannot carry: a downscale-then-parking
    composite, and a downscale at a low-activity threshold other than the
    grid's modal one."""
    w, c, i = pkg.whatif, pkg.controller, pkg.imbalance
    park = w.ParkingPolicy(pool=i.PoolConfig(
        n_devices=2, policy=i.PoolPolicy.CONSOLIDATED, n_active=1))
    return [w.CompositePolicy((w.DownscalePolicy(), park)),
            w.DownscalePolicy(config=c.ControllerConfig(
                activity_threshold=0.03, threshold_x_s=3.0))]


def random_grid(pkg, seed):
    """tests/test_whatif_batched.py's ``random_grid``: families, knobs and
    low-activity thresholds mixed, so family batches split and regroup."""
    w, c, i = pkg.whatif, pkg.controller, pkg.imbalance
    rng = np.random.default_rng(seed)
    grid = [w.NoOpPolicy()]
    for _ in range(int(rng.integers(1, 4))):
        grid.append(w.DownscalePolicy(config=c.ControllerConfig(
            threshold_x_s=float(rng.uniform(0.5, 8.0)),
            cooldown_y_s=float(rng.uniform(1.0, 10.0)),
            interval_eps_s=float(rng.choice([0.5, 1.0, 2.0])),
            activity_threshold=float(rng.choice([0.05, 0.03])),
            mode=[c.DownscaleMode.SM_ONLY,
                  c.DownscaleMode.SM_AND_MEM][int(rng.integers(0, 2))])))
    for _ in range(int(rng.integers(1, 3))):
        n_dev = int(rng.choice([2, 4]))
        grid.append(w.ParkingPolicy(
            pool=i.PoolConfig(n_devices=n_dev, policy=i.PoolPolicy.CONSOLIDATED,
                              n_active=int(rng.integers(1, n_dev))),
            resume_latency_s=float(rng.uniform(2.0, 40.0))))
    for _ in range(int(rng.integers(1, 3))):
        grid.append(w.PowerCapPolicy(cap_fraction=float(rng.uniform(0.3, 0.9))))
    order = rng.permutation(len(grid))
    return [grid[k] for k in order]


def route_counts(text):
    """The replay route and fallback counters of an exposition."""
    out = {}
    for line in text.splitlines():
        m = re.match(r'repro_replay_configs_total\{path="(\w+)"\} (\S+)', line)
        if m:
            out[m.group(1)] = float(m.group(2))
        m = re.match(r"repro_replay_row_fallback_configs_total (\S+)", line)
        if m:
            out["row_fallback"] = float(m.group(1))
        m = re.match(r'repro_fallbacks_total\{from="(\w+)",reason="\w+",'
                     r'to="(\w+)"\} (\S+)', line)
        if m:
            out[f"{m.group(1)}->{m.group(2)}"] = float(m.group(3))
    return out


def with_counts(fn):
    obs.enable()
    obs.reset()
    try:
        result = fn()
        return result, route_counts(obs.render_prometheus())
    finally:
        obs.disable()
        obs.reset()


@pytest.fixture(scope="module")
def stores():
    """(reference store, port store) in ``npy_dir`` shards, from one seed,
    with more than one host label so ``workers=2`` really partitions."""
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d:
        ref_generate_cluster(store=RefStore(d_ref, shard_format="npy_dir"),
                             **FIXTURE)
        generate_cluster(store=TelemetryStore(d, shard_format="npy_dir"),
                         **FIXTURE)
        store = TelemetryStore(d)
        assert len({s["host"] for s in store.manifest["shards"]}) > 1
        yield RefStore(d_ref), store


# --------------------------------------------------------------------------- #
# core/intervals.py helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_duration_s,dt_s", [(1.0, 1.0), (5.0, 1.0),
                                                 (10.0, 2.0)])
def test_interval_helpers_match_reference(seed, min_duration_s, dt_s):
    rng = np.random.default_rng(seed)
    # runs of random length, so short and long execution-idle runs mix
    states = np.repeat(rng.integers(0, 3, 120).astype(np.int8),
                       rng.integers(1, 14, 120))
    out = intervals.apply_min_duration(states, min_duration_s, dt_s)
    ref = ref_intervals.apply_min_duration(states, min_duration_s, dt_s)
    assert out.dtype == ref.dtype and np.array_equal(out, ref)
    relabel = intervals.apply_min_duration(states, min_duration_s, dt_s,
                                           short_relabel=DeviceState.DEEP_IDLE)
    assert np.array_equal(relabel, ref_intervals.apply_min_duration(
        states, min_duration_s, dt_s,
        short_relabel=ref_intervals.DeviceState.DEEP_IDLE))
    assert intervals.interval_count(states, min_duration_s, dt_s) == \
        ref_intervals.interval_count(states, min_duration_s, dt_s) > 0
    ivs = intervals.extract_intervals(states, min_duration_s=min_duration_s,
                                      dt_s=dt_s)
    ref_ivs = ref_intervals.extract_intervals(
        states, min_duration_s=min_duration_s, dt_s=dt_s)
    for pcts in [(50, 90, 99), (5, 25, 75, 100)]:
        assert intervals.duration_percentiles(ivs, pcts, dt_s) == \
            ref_intervals.duration_percentiles(ref_ivs, pcts, dt_s)
    empty = intervals.duration_percentiles([], (50, 90))
    assert list(empty) == [50.0, 90.0]
    assert all(np.isnan(v) for v in empty.values())


# --------------------------------------------------------------------------- #
# PolicyReplayer, replay_store, sweep_frame: the same host code, bit for bit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", range(5))
def test_policy_replayer_matches_reference_any_chunking(k):
    """One replayer per family, fed the whole frame or chunks of 997 and
    1800 rows: the reference's result under the same chunking, exactly."""
    cs = generate_cluster(n_devices=3, horizon_s=2700, seed=21)
    ref_cs = ref_generate_cluster(n_devices=3, horizon_s=2700, seed=21)
    for chunk_rows in (None, 997, 1800):
        rep = whatif.PolicyReplayer(small_grid(PORT)[k], min_job_duration_s=600)
        ref_rep = r_whatif.PolicyReplayer(small_grid(REF)[k],
                                          min_job_duration_s=600)
        for r, frame in ((rep, cs.frame), (ref_rep, ref_cs.frame)):
            for chunk in ([frame] if chunk_rows is None
                          else frame.iter_chunks(chunk_rows)):
                r.update(chunk)
        assert rep.n_rows == ref_rep.n_rows > 0
        res, ref = rep.finalize(), ref_rep.finalize()
        assert res.n_rows == ref.n_rows
        assert [j.job_id for j in res.jobs] == [j.job_id for j in ref.jobs]
        assert dataclasses.asdict(sweep._outcome(res)) == \
            dataclasses.asdict(ref_sweep._outcome(ref))


def test_policy_replayer_merge_matches_reference(stores):
    """Host-partitioned replayers merged (the pool's reduction) equal one
    pass over the store, and the reference's; overlap and config mismatch
    raise as in tests/test_whatif.py."""
    ref_store, store = stores
    parts = store.partition_hosts(2)
    assert len(parts) == 2
    assert parts == ref_store.partition_hosts(2)
    pol = small_grid(PORT)[2]
    merged = None
    for part in parts:
        rep = whatif.PolicyReplayer(pol, min_job_duration_s=0.0)
        for frame in store.iter_shards(part):
            rep.update(frame)
        merged = rep if merged is None else merged.merge(rep)
    ref = r_whatif.replay_store(ref_store, small_grid(REF)[2],
                                min_job_duration_s=0.0)
    assert dataclasses.asdict(sweep._outcome(merged.finalize())) == \
        dataclasses.asdict(ref_sweep._outcome(ref))
    cs = generate_cluster(n_devices=2, horizon_s=900, seed=31)
    a = whatif.PolicyReplayer(whatif.NoOpPolicy(), min_job_duration_s=0.0)
    b = whatif.PolicyReplayer(whatif.NoOpPolicy(), min_job_duration_s=0.0)
    a.update(cs.frame)
    b.update(cs.frame)
    with pytest.raises(ValueError, match="overlapping"):
        a.merge(b)
    with pytest.raises(ValueError, match="configs"):
        a.merge(whatif.PolicyReplayer(whatif.NoOpPolicy(),
                                      min_job_duration_s=123.0))
    with pytest.raises(ValueError, match="configs"):
        a.merge(whatif.PolicyReplayer(whatif.PowerCapPolicy(),
                                      min_job_duration_s=0.0))
    bat = whatif.BatchedPolicyReplayer(small_grid(PORT), min_job_duration_s=0.0)
    bat.update(cs.frame)
    with pytest.raises(ValueError, match="overlapping"):
        bat.merge(bat)


@pytest.mark.parametrize("mmap", [False, True])
def test_replay_store_matches_reference(stores, mmap):
    ref_store, store = stores
    host = store.manifest["shards"][0]["host"]
    for hosts in (None, [host]):
        out = whatif.replay_store(store, small_grid(PORT)[1], hosts=hosts,
                                  mmap=mmap, min_job_duration_s=0.0)
        ref = r_whatif.replay_store(ref_store, small_grid(REF)[1], hosts=hosts,
                                    mmap=mmap, min_job_duration_s=0.0)
        assert out.n_rows == ref.n_rows > 0
        assert dataclasses.asdict(sweep._outcome(out)) == \
            dataclasses.asdict(ref_sweep._outcome(ref))


@pytest.mark.parametrize("batched", [True, False])
def test_sweep_frame_on_des_frame_matches_reference(batched):
    """The pool DES's telemetry (one platform for every stream) through
    ``sweep_frame`` on both packages."""
    from repro.core.power_model import get_platform as r_get_platform
    from repro.serving.des import simulate_pool as r_simulate_pool
    from repro.serving.latency import Request as RRequest
    from repro.serving.perf_model import LLAMA13B_L40S as R_L40S
    from repro_torch.core.power_model import get_platform
    from repro_torch.serving.des import simulate_pool
    from repro_torch.serving.latency import Request
    from repro_torch.serving.perf_model import LLAMA13B_L40S

    rng = np.random.default_rng(3)
    arrivals = rng.uniform(0, 100, 25)
    res = simulate_pool([Request(req_id=k, arrival_s=float(t), prompt_tokens=200,
                                 output_tokens=30) for k, t in enumerate(arrivals)],
                        get_platform("l40s"), LLAMA13B_L40S,
                        imbalance.PoolConfig(n_devices=2), duration_s=140.0)
    ref_res = r_simulate_pool(
        [RRequest(req_id=k, arrival_s=float(t), prompt_tokens=200,
                  output_tokens=30) for k, t in enumerate(arrivals)],
        r_get_platform("l40s"), R_L40S, r_imbalance.PoolConfig(n_devices=2),
        duration_s=140.0)
    kw = dict(batched=batched, platform_of="l40s", min_job_duration_s=0.0)
    out = whatif.sweep_frame(res.telemetry, small_grid(PORT), **kw)
    ref = r_whatif.sweep_frame(ref_res.telemetry, small_grid(REF), **kw)
    assert out.n_jobs > 0
    assert whatif.frontier_to_dict(out) == r_whatif.frontier_to_dict(ref)


# --------------------------------------------------------------------------- #
# run_sweep on rows, at workers 1 and 2: the reference's NumPy backend
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,args", [
    (0, dict(batched=False)),
    (1, dict(compact=False)),
    (2, dict(batched=False, compact=False, workers=2)),
    (3, dict(compact=False, workers=2, mmap=True)),
])
def test_run_sweep_rows_match_reference(stores, seed, args):
    """tests/test_whatif_batched.py's random grids through the row paths:
    the port's NumPy backend equals the reference's with the same
    arguments, bit for bit, and the batched rows equal the per-policy
    reference path."""
    ref_store, store = stores
    out = whatif.run_sweep(store, random_grid(PORT, seed), backend="numpy",
                           min_job_duration_s=300, **args)
    ref = r_whatif.run_sweep(ref_store, random_grid(REF, seed),
                             backend="numpy", min_job_duration_s=300, **args)
    assert out.n_rows == ref.n_rows > 0 and out.n_runs == ref.n_runs == 0
    assert whatif.frontier_to_dict(out) == r_whatif.frontier_to_dict(ref)
    serial = whatif.run_sweep(store, random_grid(PORT, seed), backend="numpy",
                              min_job_duration_s=300, batched=False)
    assert whatif.frontier_to_dict(serial) == whatif.frontier_to_dict(out)


def test_sweep_compact_false_on_torch_backend_is_the_row_path(stores):
    """``compact=False`` on the torch backend asks for rows: nothing goes to
    the card, and the frontier is the NumPy backend's bit for bit."""
    _, store = stores
    grid = small_grid(PORT)
    out, counts = with_counts(lambda: whatif.run_sweep(
        store, grid, device="cpu", compact=False, min_job_duration_s=0.0))
    ref = whatif.run_sweep(store, grid, backend="numpy", compact=False,
                           min_job_duration_s=0.0)
    assert counts == {"row_batched": float(len(grid))}
    assert whatif.frontier_to_dict(out) == whatif.frontier_to_dict(ref)


# --------------------------------------------------------------------------- #
# the torch backend on a mixed grid: card + rows, counted
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("batched", [True, False])
def test_torch_backend_routes_mixed_grid(stores, batched):
    """The dense grid plus two configs the IR cannot carry: the IR-capable
    configs replay on the card (here the plain versions), the other two on
    rows, counted as the reference counts its accelerator backend's split;
    every outcome meets the contract against the reference's NumPy oracle,
    and the row configs equal it exactly."""
    ref_store, store = stores
    grid = whatif.default_policy_grid() + non_ir_configs(PORT)
    ref_grid = r_whatif.default_policy_grid() + non_ir_configs(REF)
    cfg = ir_mod.ir_config_for(grid)
    n_ir = sum(ir_mod.ir_supported(p, cfg) for p in grid)
    assert n_ir == len(grid) - 2
    out, counts = with_counts(lambda: whatif.evaluate(
        grid, store, device="cpu", batched=batched, min_job_duration_s=0.0))
    rows = "row_batched" if batched else "row_serial"
    assert counts == {"torch": float(n_ir), "row_fallback": 2.0, rows: 2.0}
    ref = r_whatif.evaluate(ref_grid, ref_store, backend="numpy",
                            batched=batched, min_job_duration_s=0.0)
    assert_contract(ref, out)
    assert as_dicts(out[-2:]) == as_dicts(ref[-2:])
    host = whatif.evaluate(grid, store, backend="numpy", batched=batched,
                           min_job_duration_s=0.0)
    assert as_dicts(host) == as_dicts(ref)


@pytest.mark.parametrize("target", ["downscale_replay", "cap_bucket_scan"])
def test_card_error_propagates_with_no_host_fallback(stores, monkeypatch, target):
    """A kernel wrapper that raises makes ``evaluate(backend="torch")``
    raise, on a grid whose other configs would go to rows: no ``torch ->
    numpy`` fallback is counted and nothing replays on the host instead."""
    _, store = stores

    def broken(*args, **kwargs):
        raise RuntimeError(f"{target} kernel launch failed")

    monkeypatch.setattr(B, target, broken)
    grid = small_grid(PORT) + non_ir_configs(PORT)
    obs.enable()
    obs.reset()
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            whatif.evaluate(grid, store, device="cpu", min_job_duration_s=0.0)
        counts = route_counts(obs.render_prometheus())
    finally:
        obs.disable()
        obs.reset()
    assert counts == {}


def test_torch_backend_mmap_reads_match(stores):
    """``mmap=True`` hands read-only memory-mapped columns to the IR build
    and the row path; nothing writes through them or hands them to torch
    (no warning), and the outcomes equal the copied reads'."""
    _, store = stores
    grid = small_grid(PORT) + non_ir_configs(PORT)
    ir_mod._IR_CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mapped = whatif.evaluate(grid, store, device="cpu", mmap=True,
                                 min_job_duration_s=0.0)
    ir_mod._IR_CACHE.clear()
    copied = whatif.evaluate(grid, store, device="cpu", min_job_duration_s=0.0)
    assert as_dicts(mapped) == as_dicts(copied)
