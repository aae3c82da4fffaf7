"""The port's what-if replay against the JAX package's.

The same seeded fleet (``generate_cluster(n_devices=6, horizon_s=1500,
seed=7, shard_s=500)``, the fixture of tests/test_whatif_backend.py) goes
through both packages. The data path is a copy, so it must match bit for bit:
simulator frames, the run-level IR and the NumPy backend's outcomes. The
torch backend (here on the CPU, where the kernels run their plain versions)
meets the reference's oracle contract against the NumPy path: time and count
fields bit-identical, energies and penalties within 1e-9 relative (the float
sums run in another order).
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro.cluster import generate_cluster as ref_generate_cluster
from repro.core.energy import integrate_runs as ref_integrate_runs
from repro.telemetry import TelemetryStore as RefStore
from repro.whatif import evaluate as ref_evaluate
from repro.whatif import get_ir as ref_get_ir
from repro.whatif.ir import ir_config_for as ref_ir_config_for

from repro_torch.cluster import generate_cluster
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.core.energy import integrate_runs
from repro_torch.core.imbalance import PoolConfig, PoolPolicy
from repro_torch.core.states import ClassifierConfig
from repro_torch.telemetry import TelemetryStore
from repro_torch.telemetry.records import TelemetryFrame
from repro_torch.whatif import (CompositePolicy, DownscalePolicy, IRConfig,
                                ParkingPolicy, build_ir, default_policy_grid,
                                evaluate, get_ir, run_sweep)
from repro_torch.whatif import backend as B
from repro_torch.whatif.ir import ir_config_for
from repro_torch.whatif.policies import DownscaleBatch, _run_downscale
from repro_torch.whatif.replay import _resolve_platform

FIXTURE = dict(n_devices=6, horizon_s=1500, seed=7, shard_s=500)
RTOL = ATOL = 1e-9          # the reference's oracle tolerance for float fields
EXACT_FIELDS = ("name", "params", "n_jobs", "wake_events",
                "downscale_events", "throttled_time_s")
FLOAT_FIELDS = ("baseline_energy_j", "counterfactual_energy_j",
                "energy_saved_j", "saved_fraction", "penalty_s",
                "penalty_fraction", "exec_idle_energy_fraction_baseline",
                "exec_idle_energy_fraction_cf")


def assert_outcomes_equivalent(ref, out, exact_energies=False):
    """tests/test_whatif_backend.py's contract: exact fields equal, float
    fields within 1e-9 relative (or equal with ``exact_energies``)."""
    assert len(ref) == len(out)
    for a, b in zip(ref, out):
        for f in EXACT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.name, a.params, f)
        for f in FLOAT_FIELDS:
            if exact_energies:
                assert getattr(a, f) == getattr(b, f), (a.name, a.params, f)
            else:
                assert np.isclose(getattr(a, f), getattr(b, f),
                                  rtol=RTOL, atol=ATOL), (a.name, a.params, f)
        for f in ("per_job_saved_fraction", "per_job_penalty_s"):
            if exact_energies:
                assert getattr(a, f) == getattr(b, f), (a.name, a.params, f)
            else:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=RTOL, atol=ATOL)


def as_dicts(outcomes):
    return [dataclasses.asdict(o) for o in outcomes]


@pytest.fixture(scope="module")
def stores():
    """(reference store, port store), written from the same seed."""
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d:
        ref_generate_cluster(store=RefStore(d_ref, shard_format="npy_dir"), **FIXTURE)
        generate_cluster(store=TelemetryStore(d, shard_format="npy_dir"), **FIXTURE)
        yield RefStore(d_ref), TelemetryStore(d)


def family_grid():
    """Every IR-capable family, with both parking+downscale composites."""
    park = ParkingPolicy(pool=PoolConfig(n_devices=4,
                                         policy=PoolPolicy.CONSOLIDATED,
                                         n_active=2),
                         resume_latency_s=12.0)
    return default_policy_grid(dense=False) + [
        CompositePolicy((park, DownscalePolicy())),
        CompositePolicy((park, DownscalePolicy(config=ControllerConfig(
            threshold_x_s=3.0, cooldown_y_s=9.0,
            mode=DownscaleMode.SM_AND_MEM)))),
    ]


def ref_family_grid():
    """The same grid built from the reference's classes."""
    from repro.core.controller import ControllerConfig as RCC
    from repro.core.controller import DownscaleMode as RDM
    from repro.core.imbalance import PoolConfig as RPC
    from repro.core.imbalance import PoolPolicy as RPP
    from repro.whatif import CompositePolicy as RComp
    from repro.whatif import DownscalePolicy as RDown
    from repro.whatif import ParkingPolicy as RPark
    from repro.whatif import default_policy_grid as r_grid
    park = RPark(pool=RPC(n_devices=4, policy=RPP.CONSOLIDATED, n_active=2),
                 resume_latency_s=12.0)
    return r_grid(dense=False) + [
        RComp((park, RDown())),
        RComp((park, RDown(config=RCC(threshold_x_s=3.0, cooldown_y_s=9.0,
                                      mode=RDM.SM_AND_MEM)))),
    ]


# --------------------------------------------------------------------------- #
# the data path is a copy: bit for bit
# --------------------------------------------------------------------------- #
def test_simulator_frames_bit_identical():
    ref = ref_generate_cluster(n_devices=6, horizon_s=1500, seed=7)
    out = generate_cluster(n_devices=6, horizon_s=1500, seed=7)
    assert set(ref.frame.columns) == set(out.frame.columns)
    for k, v in ref.frame.columns.items():
        np.testing.assert_array_equal(out.frame.columns[k], v, err_msg=k)
        assert out.frame.columns[k].dtype == v.dtype, k


def test_store_shards_bit_identical(stores):
    ref_store, store = stores
    assert store.total_rows == ref_store.total_rows
    ref_shards = list(ref_store.iter_shards())
    shards = list(store.iter_shards())
    assert len(shards) == len(ref_shards)
    for a, b in zip(ref_shards, shards):
        for k, v in a.columns.items():
            np.testing.assert_array_equal(b.columns[k], v, err_msg=k)


def test_ir_arrays_match_reference(stores):
    ref_store, store = stores
    ref_ir = ref_get_ir(ref_store, ref_ir_config_for(ref_family_grid()), persist=False)
    ir = get_ir(store, ir_config_for(family_grid()), persist=False)
    assert list(ir.streams) == list(ref_ir.streams)
    assert ir.source_rows == ref_ir.source_rows
    for key, r in ref_ir.streams.items():
        s = ir.streams[key]
        assert (s.host_label, s.platform_id, s.ts_first, s.dt_s) == \
            (r.host_label, r.platform_id, r.ts_first, r.dt_s)
        for f in ("state", "low", "length", "power_sum", "power"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f), err_msg=f)
        np.testing.assert_array_equal(s.ts(), r.ts())


def test_numpy_backend_equals_reference_exactly(stores):
    ref_store, store = stores
    ref = ref_evaluate(ref_family_grid(), ref_store, backend="numpy",
                       min_job_duration_s=0.0)
    out = evaluate(family_grid(), store, backend="numpy", min_job_duration_s=0.0)
    assert as_dicts(out) == as_dicts(ref)


# --------------------------------------------------------------------------- #
# the torch backend meets the oracle contract
# --------------------------------------------------------------------------- #
def test_torch_cpu_matches_oracle_family_grid(stores):
    ref_store, store = stores
    oracle = evaluate(family_grid(), store, backend="numpy", min_job_duration_s=0.0)
    out = evaluate(family_grid(), store, backend="torch", device="cpu",
                   min_job_duration_s=0.0)
    assert_outcomes_equivalent(oracle, out)
    ref = ref_evaluate(ref_family_grid(), ref_store, backend="numpy",
                       min_job_duration_s=0.0)
    assert_outcomes_equivalent(ref, out)


@pytest.mark.parametrize("mjd,mis", [(300.0, 5.0), (0.0, 1.0), (0.0, 10.0)])
def test_torch_cpu_matches_oracle_interval_and_duration_variants(stores, mjd, mis):
    _, store = stores
    oracle = evaluate(family_grid(), store, backend="numpy",
                      min_job_duration_s=mjd, min_interval_s=mis)
    out = evaluate(family_grid(), store, backend="torch", device="cpu",
                   min_job_duration_s=mjd, min_interval_s=mis)
    assert_outcomes_equivalent(oracle, out)


def test_run_sweep_torch_cpu_frontier(stores):
    """The dense 200-config grid: same frontier, same Pareto flags."""
    _, store = stores
    ref = run_sweep(store, backend="numpy", min_job_duration_s=0.0)
    out = run_sweep(store, device="cpu", min_job_duration_s=0.0)
    assert (out.n_rows, out.n_runs, out.n_jobs) == (ref.n_rows, ref.n_runs, ref.n_jobs)
    assert_outcomes_equivalent(ref.outcomes, out.outcomes)
    assert [o.pareto for o in out.outcomes] == [o.pareto for o in ref.outcomes]


def test_torch_backend_errors_propagate(stores, monkeypatch):
    """No ``torch -> numpy`` rung: a kernel failure reaches the caller."""
    _, store = stores

    def broken(*args, **kwargs):
        raise RuntimeError("downscale_replay kernel launch failed")

    monkeypatch.setattr(B, "downscale_replay", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        evaluate([DownscalePolicy()], store, device="cpu", min_job_duration_s=0.0)


def test_backend_validation_errors(stores):
    _, store = stores
    grid = [DownscalePolicy()]
    ir = get_ir(store, ir_config_for(grid))
    with pytest.raises(ValueError, match="classifier"):
        B.replay_ir_outcomes(
            ir, grid, classifier=ClassifierConfig(activity_threshold_pct=10.0),
            device="cpu")
    with pytest.raises(ValueError, match="dt_s"):
        B.replay_ir_outcomes(ir, grid, dt_s=2.0, device="cpu")
    park = ParkingPolicy(pool=PoolConfig(n_devices=2,
                                         policy=PoolPolicy.CONSOLIDATED,
                                         n_active=1))
    with pytest.raises(ValueError):
        # downscale-then-parking composite is not IR-capable
        B.replay_ir_outcomes(ir, [CompositePolicy((DownscalePolicy(), park))],
                             device="cpu")


# --------------------------------------------------------------------------- #
# what the run-level IR cannot carry: the NumPy row path, refused on the card
# --------------------------------------------------------------------------- #
def _down_then_park(pkg):
    """A downscale-then-parking composite: not IR-capable."""
    park = pkg.ParkingPolicy(pool=pkg.PoolConfig(
        n_devices=2, policy=pkg.PoolPolicy.CONSOLIDATED, n_active=1))
    return [pkg.DownscalePolicy(), pkg.CompositePolicy((pkg.DownscalePolicy(), park))]


def _pkg(whatif, imbalance):
    import types
    return types.SimpleNamespace(
        ParkingPolicy=whatif.ParkingPolicy, DownscalePolicy=whatif.DownscalePolicy,
        CompositePolicy=whatif.CompositePolicy, PoolConfig=imbalance.PoolConfig,
        PoolPolicy=imbalance.PoolPolicy)


def _irregular_rows(gap_at=7):
    """One stream at 1 Hz with one sample missing: the IR cannot store it."""
    rows = []
    for i in range(40):
        if i == gap_at:
            continue
        busy = (i // 10) % 2 == 1
        rows.append({"timestamp": float(i), "job_id": 1, "program_resident": 1,
                     "power": 300.0 if busy else 80.0, "sm": 95.0 if busy else 1.0,
                     "hostname": 0, "device_id": 0, "platform": 0})
    return rows


def test_numpy_row_path_equals_reference_for_non_ir_configs(stores):
    """Exact equality (tolerance 0): configs the IR cannot carry replay on
    the row path in both packages."""
    import repro.core.imbalance as r_imb
    import repro.whatif as r_whatif
    import repro_torch.core.imbalance as imb
    import repro_torch.whatif as whatif

    ref_store, store = stores
    ref = ref_evaluate(_down_then_park(_pkg(r_whatif, r_imb)), ref_store,
                       backend="numpy", min_job_duration_s=0.0)
    out = evaluate(_down_then_park(_pkg(whatif, imb)), store, backend="numpy",
                   min_job_duration_s=0.0)
    assert as_dicts(out) == as_dicts(ref)


def test_torch_backend_refuses_non_ir_configs(stores):
    """The card never hands a config to the host: a grid holding one the IR
    cannot carry raises and points at the NumPy backend."""
    import repro_torch.core.imbalance as imb
    import repro_torch.whatif as whatif

    _, store = stores
    with pytest.raises(ValueError, match="backend='numpy'"):
        evaluate(_down_then_park(_pkg(whatif, imb)), store, device="cpu",
                 min_job_duration_s=0.0)


def test_irregular_store_row_path_and_torch_refusal():
    """A store the IR cannot compact: the NumPy backend replays it on rows,
    exactly as the reference does (tolerance 0); the torch backend raises."""
    from repro.telemetry.records import TelemetryFrame as RefFrame
    from repro_torch.whatif import IRUnsupportedError

    grid, ref_grid = family_grid(), ref_family_grid()
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d:
        RefStore(d_ref).write_shard(RefFrame.from_rows(_irregular_rows()), host="h0")
        store = TelemetryStore(d)
        store.write_shard(TelemetryFrame.from_rows(_irregular_rows()), host="h0")
        ref = ref_evaluate(ref_grid, RefStore(d_ref), backend="numpy",
                           min_job_duration_s=0.0)
        out = evaluate(grid, store, backend="numpy", min_job_duration_s=0.0)
        assert as_dicts(out) == as_dicts(ref)
        with pytest.raises(IRUnsupportedError, match="backend='numpy'"):
            evaluate(grid, store, device="cpu", min_job_duration_s=0.0)


@pytest.mark.parametrize("compact", [None, False])
def test_analyze_store_matches_reference(stores, compact):
    """Fleet analysis on the run tables (default) and on rows: times, counts
    and intervals exact, energies within 1e-9 relative."""
    from repro.telemetry import analyze_store as ref_analyze_store
    from repro_torch.telemetry import analyze_store

    ref_store, store = stores
    ref = ref_analyze_store(ref_store, min_job_duration_s=0.0, compact=compact)
    out = analyze_store(store, min_job_duration_s=0.0, compact=compact)
    assert len(out.jobs) == len(ref.jobs) > 0
    assert (out.n_intervals, out.coverage) == (ref.n_intervals, ref.coverage)
    assert out.unattributed_energy_j == ref.unattributed_energy_j
    for a, b in zip(ref.jobs, out.jobs):
        assert (a.job_id, a.duration_s, a.platform) == (b.job_id, b.duration_s, b.platform)
        assert [(i.start, i.end) for i in a.intervals] == \
            [(i.start, i.end) for i in b.intervals]
        assert {int(k): v for k, v in a.breakdown.time_s.items()} == \
            {int(k): v for k, v in b.breakdown.time_s.items()}
        for k, v in a.breakdown.energy_j.items():
            assert np.isclose(b.breakdown.energy_j[int(k)], v, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# pack_ir: round trip, padding isolation, device tensors cached
# --------------------------------------------------------------------------- #
def test_pack_ir_roundtrip_bit_identical(stores):
    from repro_torch.core.power_model import ClockLevel

    _, store = stores
    ir = get_ir(store, ir_config_for([DownscalePolicy()]))
    min_samples = 5
    packed = B.pack_ir(ir, min_samples, min_job_duration_s=0.0)
    assert packed.n_streams == len(ir.select(None))
    for s, plat, v in zip(packed.streams, packed.platforms, packed.unpack()):
        off, low_flags = s.controller_runs()
        low_j = np.flatnonzero(low_flags)
        np.testing.assert_array_equal(v["lr_s0"], off[low_j])
        np.testing.assert_array_equal(v["lr_len"], off[low_j + 1] - off[low_j])
        np.testing.assert_array_equal(
            v["lr_busy"], s.ts_first + s.dt_s * off[low_j + 1].astype(np.float64))
        np.testing.assert_array_equal(v["cum_res"], s.cum_resident())
        for j, (sm, mem) in enumerate(((ClockLevel.MIN, ClockLevel.MAX),
                                       (ClockLevel.MIN, ClockLevel.MIN))):
            delta = plat.exec_idle_w - plat.residency_floor_w(sm, mem)
            ce, ca = s.downscale_cums(float(delta), plat.deep_idle_w, min_samples)
            np.testing.assert_array_equal(v["ds_cum"][2 * j], ce)
            np.testing.assert_array_equal(v["ds_cum"][2 * j + 1], ca)
        cap = s.cap_buckets(min_samples)
        for st_key in (0, 1, 2):
            sp, top = v["cap_buckets"][st_key]
            np.testing.assert_array_equal(sp, cap[st_key][0])
            np.testing.assert_array_equal(top, cap[st_key][1])
        sp, top = v["cap_buckets"]["penalty"]
        np.testing.assert_array_equal(sp, cap["penalty"][0])
        np.testing.assert_array_equal(top, cap["penalty"][2])
        pk = s.parking_counterfactual(min_samples)
        np.testing.assert_array_equal(v["pk_state"], pk["cf_state"])
        np.testing.assert_array_equal(
            v["pk_energy"], pk["keep_sum"] + pk["idle_len"] * plat.deep_idle_w)
        np.testing.assert_array_equal(v["pk_len"], s.length)
        assert v["ts_first"] == s.ts_first
    # the pack is cached on the IR under the port's own key
    assert B.pack_ir(ir, min_samples, min_job_duration_s=0.0) is packed
    assert "_torch_packed" in ir.__dict__


def test_pack_ir_padding_never_leaks(stores):
    """Every stream forced into one giant padding bucket leaves outcomes
    EXACTLY identical: a fired padding lane would shift energies, counts or
    CDFs."""
    _, store = stores
    grid = family_grid()
    ir = get_ir(store, ir_config_for(grid))
    ref, _, _ = B.replay_ir_outcomes(ir, grid, min_job_duration_s=0.0, device="cpu")
    big, _, _ = B.replay_ir_outcomes(ir, grid, min_job_duration_s=0.0,
                                     pad_floor=2048, device="cpu")
    packed_small = B.pack_ir(ir, 5, min_job_duration_s=0.0)
    packed_big = B.pack_ir(ir, 5, min_job_duration_s=0.0, pad_floor=2048)
    assert len(packed_big.buckets) <= len(packed_small.buckets)
    assert len(packed_big.buckets) == 1
    assert_outcomes_equivalent(ref, big, exact_energies=True)


def test_device_tensors_uploaded_once(stores):
    """A repeat replay reuses each bucket's device tensors and the parking
    tables: nothing is uploaded again."""
    _, store = stores
    grid = family_grid()
    ir = get_ir(store, ir_config_for(grid))
    first, _, _ = B.replay_ir_outcomes(ir, grid, min_job_duration_s=0.0, device="cpu")
    packed = B.pack_ir(ir, 5, min_job_duration_s=0.0)
    cached = [b.device_tensors(torch.device("cpu")) for b in packed.buckets]
    park = packed.park["cpu"]
    again, _, _ = B.replay_ir_outcomes(ir, grid, min_job_duration_s=0.0, device="cpu")
    assert all(b.device_tensors(torch.device("cpu")) is c
               for b, c in zip(packed.buckets, cached))
    assert packed.park["cpu"] is park
    assert_outcomes_equivalent(first, again, exact_energies=True)


# --------------------------------------------------------------------------- #
# the integrator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_torch_integrate_runs_matches_numpy(seed):
    """Times exact, energies within 1e-9 relative (summation order)."""
    rng = np.random.default_rng(seed)
    n_runs, n_cfg = 150, 4
    states = rng.choice([0, 1, 2], size=n_runs).astype(np.int32)
    lengths = rng.integers(1, 12, size=n_runs)
    energy = rng.normal(100, 30, (n_cfg, n_runs)) * lengths
    min_samples = int(rng.integers(0, 8))
    ref = ref_integrate_runs(states, energy, lengths, min_samples, dt_s=1.0)
    own = integrate_runs(states, energy, lengths, min_samples, dt_s=1.0)
    out = B.torch_integrate_runs(states, energy, lengths, min_samples,
                                 dt_s=1.0, device="cpu")
    assert len(ref) == len(out) == len(own)
    for a, o, b in zip(ref, own, out):
        assert {int(k): v for k, v in a.time_s.items()} == \
            {int(k): v for k, v in o.time_s.items()}
        assert o.time_s == b.time_s
        for k in o.energy_j:
            assert np.isclose(o.energy_j[k], b.energy_j[k], rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# cooldown decisions pinned against a naive walk
# --------------------------------------------------------------------------- #
def _cooldown_frame():
    """Six cycles of [10 low-activity samples][3 busy samples]: short busy
    gaps make every later low run cooldown-risky for large-Y configs."""
    rows = []
    t = 0.0
    for _ in range(6):
        for sm, n in ((1.0, 10), (95.0, 3)):
            for _ in range(n):
                rows.append({"timestamp": t, "job_id": 1, "program_resident": 1,
                             "power": 300.0 if sm > 50 else 80.0, "sm": sm,
                             "hostname": 0, "device_id": 0, "platform": 0})
                t += 1.0
    return TelemetryFrame.from_rows(rows)


def _naive_decisions(stream, dt_s, y, trig):
    """Transparent per-(run, config) sequential reference for the fire
    sequence: full-window searchsorted, no screening, no hoisting."""
    off, low_flags = stream.controller_runs()
    low_j = np.flatnonzero(low_flags)
    s0s, e0s = off[low_j], off[low_j + 1]
    lens = e0s - s0s
    ts = stream.ts()
    busy_after = stream.ts_first + dt_s * e0s.astype(np.float64)
    fires = np.zeros((low_j.size, y.shape[0]), dtype=bool)
    rows = np.zeros((low_j.size, y.shape[0]), dtype=np.int64)
    last_busy = np.full(y.shape[0], -np.inf)
    for k in range(low_j.size):
        for c in range(y.shape[0]):
            i = max(int(trig[c]), int(np.searchsorted(
                ts[s0s[k]:e0s[k]], last_busy[c] + y[c], side="left")))
            if lens[k] > trig[c] and i < lens[k]:
                fires[k, c] = True
                rows[k, c] = s0s[k] + i
                last_busy[c] = busy_after[k]
    return fires, rows


def test_downscale_cooldown_decisions_pinned():
    grid = [DownscalePolicy(config=ControllerConfig(threshold_x_s=x, cooldown_y_s=y))
            for x, y in ((2.0, 1.0), (2.0, 10.0), (6.0, 10.0), (2.0, 20.0))]
    batch = DownscaleBatch(tuple(grid))
    with tempfile.TemporaryDirectory() as d:
        store = TelemetryStore(d)
        store.write_shard(_cooldown_frame(), host="h0")
        ir = build_ir(store, IRConfig())
        s = list(ir.streams.values())[0]
        plat = _resolve_platform(None, {}, s.platform_id)
        fires, rows = _naive_decisions(s, 1.0, batch._y, batch._trig)
        # the NumPy oracle
        n_down, n_rest, throttled, _, _ = _run_downscale(
            s, plat, 1, 1.0, batch._eps, batch._x, batch._y, batch._trig,
            batch._delta(plat))
        np.testing.assert_array_equal(n_down, fires.sum(axis=0))
        # (x=2,y=1) fires every run untouched; (x=2,y=10) and (x=6,y=10)
        # fire every run but the cooldown delays the trigger row; (x=2,y=20)
        # overshoots the whole next run, so every other run is suppressed
        np.testing.assert_array_equal(n_down, [6, 6, 6, 3])
        # the port's device path (plain K7 on the CPU) on the packed stream
        packed = B.pack_ir(ir, 1, min_job_duration_s=0.0)
        out = B._run_downscale_family(packed, batch, torch.device("cpu"), 1.0)
        np.testing.assert_array_equal(out[0][0], n_down)
        np.testing.assert_array_equal(out[1][0], n_rest)
        np.testing.assert_array_equal(out[2][0], throttled)
        # throttled samples are exactly the resident samples from each naive
        # trigger row to its run's end
        res = s.cum_resident()
        off, low_flags = s.controller_runs()
        e0s = off[np.flatnonzero(low_flags) + 1]
        naive_thr = np.where(fires, res[e0s][:, None] - res[rows], 0).sum(axis=0)
        np.testing.assert_array_equal(out[2][0], naive_thr)
