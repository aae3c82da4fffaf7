"""The port's dirty-telemetry layer against the JAX package's, case by case.

Mirrors tests/test_robustness.py: the hygiene contract's repairs,
quarantines and idempotence (the hypothesis case too), the DCGM adapter and
``ingest_dcgm``, ``scrub_store``, truncated and bit-flipped shards under
``strict``/``verify``, manifest drift, a poisoned manifest, a kill
mid-write, ``analyze_store`` and the sweep/search on a dirty store, and the
quarantine counters. Every verdict, repair and quarantine is held to the
reference's on the same input; the port's sweeps and searches run on the
torch backend on the CPU (the kernels' plain versions) and are held to the
reference's NumPy oracle (counts and times exact, floats within 1e-9).

The reference's four process-pool cases (a crashing, a hung and an
exhausted pool worker, and the sweep with a crashing worker) stay out: the
port runs in one process and has no pool.
"""
import shutil
import tempfile

import numpy as np
import pytest
from _hyp import given, settings, st

import repro_torch.obs as obs
from repro_torch.cluster import generate_cluster
from repro_torch.telemetry import (HygieneContract, ShardReadError,
                                   TelemetryStore, analyze_store, check_frame,
                                   dcgm_to_frame, ingest_dcgm, ingest_frame,
                                   scrub_store)
from repro_torch.telemetry.hygiene import DEFAULT_CONTRACT, check_columns
from repro_torch.telemetry.records import FIELDS, TelemetryFrame
from repro_torch.testing import faults
from repro_torch.whatif import (DownscalePolicy, IRConfig, NoOpPolicy,
                                frontier_from_dict, frontier_to_dict, get_ir,
                                run_sweep, search_frontier)
from repro_torch.whatif import ir as ir_mod
from repro_torch.whatif.search import default_families

RTOL = ATOL = 1e-9
EXACT_FIELDS = ("name", "params", "n_jobs", "wake_events",
                "downscale_events", "throttled_time_s", "pareto")
#: the port's replays: torch backend, kernels' plain versions on the CPU
TORCH = dict(backend="torch", device="cpu", min_job_duration_s=300)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's robustness stack (imported here so the module
    collects on a machine without JAX)."""
    import types

    from repro import obs as ref_obs
    from repro.cluster import generate_cluster as ref_generate_cluster
    from repro.telemetry import TelemetryStore as RefStore
    from repro.telemetry import analyze_store as ref_analyze_store
    from repro.telemetry import hygiene as ref_hygiene
    from repro.telemetry.records import TelemetryFrame as RefFrame
    from repro.whatif import DownscalePolicy as RefDownscale
    from repro.whatif import NoOpPolicy as RefNoOp
    from repro.whatif import frontier_to_dict as ref_f2d
    from repro.whatif import ir as ref_ir
    from repro.whatif import run_sweep as ref_run_sweep
    from repro.whatif import search_frontier as ref_search_frontier
    from repro.whatif.search import default_families as ref_families
    return types.SimpleNamespace(
        obs=ref_obs, generate_cluster=ref_generate_cluster, Store=RefStore,
        analyze_store=ref_analyze_store, hygiene=ref_hygiene, Frame=RefFrame,
        grid=[RefNoOp(), RefDownscale()], f2d=ref_f2d, ir=ref_ir,
        run_sweep=ref_run_sweep, search_frontier=ref_search_frontier,
        families=ref_families)


_GRID = [NoOpPolicy(), DownscalePolicy()]


def make_store(d, n_devices=4, horizon_s=900, seed=5, shard_s=300):
    store = TelemetryStore(d)
    generate_cluster(n_devices=n_devices, horizon_s=horizon_s, seed=seed,
                     store=store, shard_s=shard_s)
    return store


def clean_frame(n=60, power=120.0, job=3, t0=0.0, frame_cls=TelemetryFrame):
    return frame_cls({
        "timestamp": t0 + np.arange(n, dtype=np.float64),
        "hostname": np.zeros(n, np.int32),
        "device_id": np.zeros(n, np.int32),
        "platform": np.zeros(n, np.int32),
        "power": np.full(n, power),
        "sm": np.full(n, 50.0),
        "job_id": np.full(n, job, np.int64),
        "program_resident": np.ones(n, np.int8),
    })


def analysis_key(a):
    """Everything analysis produces except the robustness accounting."""
    return (a.fleet, a.unattributed_energy_j, a.n_intervals,
            [(j.job_id, j.duration_s, j.breakdown, tuple(j.intervals))
             for j in a.jobs])


def shard_path(store, entry):
    return store.root / entry["file"]


def clear_ir_caches(ref=None):
    ir_mod._IR_CACHE.clear()
    ir_mod._IR_UNSUPPORTED.clear()
    if ref is not None:
        ref.ir._IR_CACHE.clear()
        ref.ir._IR_UNSUPPORTED.clear()


def check_both(ref, cols, **kw):
    """``check_frame`` of the port and of the reference on the same columns:
    the verdicts must be equal, and so must the repaired rows."""
    out, v = check_frame(TelemetryFrame({k: c.copy() for k, c in cols.items()}), **kw)
    rout, rv = ref.hygiene.check_frame(
        ref.Frame({k: c.copy() for k, c in cols.items()}), **kw)
    assert v.__dict__ == rv.__dict__
    assert (out is None) == (rout is None)
    if out is not None:
        for k in FIELDS:
            np.testing.assert_array_equal(out[k], rout[k])
    return out, v


def assert_oracle(ref_payload: dict, payload: dict):
    for k in ("n_rows", "n_jobs", "n_runs", "coverage"):
        assert ref_payload[k] == payload[k], k
    assert len(ref_payload["outcomes"]) == len(payload["outcomes"])
    for a, b in zip(ref_payload["outcomes"], payload["outcomes"]):
        for f, v in a.items():
            if f in EXACT_FIELDS:
                assert v == b[f], (a["params"], f)
            else:
                np.testing.assert_allclose(b[f], v, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# hygiene contract: check_frame / check_columns
# --------------------------------------------------------------------------- #
def test_clean_frame_passes_unchanged(ref):
    f = clean_frame()
    out, v = check_frame(f)
    assert v.status == "ok" and not v.reasons and not v.repairs
    assert out is f                       # zero-fault path: same object
    check_both(ref, f.columns)


def test_repairs_are_subtractive_and_deterministic(ref):
    f = clean_frame(n=40)
    cols = {k: v.copy() for k, v in f.columns.items()}
    cols["timestamp"][7] = np.nan         # clock step
    cols["power"][3] = -5.0               # glitched rail
    cols["power"][4] = 5000.0             # physically impossible
    out, v = check_both(ref, cols)
    assert v.status == "repaired"
    assert v.repairs == {"nonfinite_timestamp": 1, "bad_power": 2}
    assert (v.rows_in, v.rows_out) == (40, 37)
    out2, v2 = check_frame(TelemetryFrame({k: c.copy()
                                           for k, c in cols.items()}))
    assert v2 == v
    for k in out.columns:
        assert np.array_equal(out[k], out2[k],
                              equal_nan=out[k].dtype.kind == "f")
    out3, v3 = check_frame(out)           # idempotent: a repaired frame is clean
    assert v3.status == "ok" and out3 is out


def test_duplicate_timestamps_keep_first(ref):
    f = clean_frame(n=20)
    cols = {k: np.concatenate([v, v[:5]]) for k, v in f.columns.items()}
    cols["power"] = cols["power"].copy()
    cols["power"][20:] = 999.0            # replayed rows differ: must lose
    out, v = check_both(ref, cols)
    assert v.repairs == {"duplicate_timestamp": 5}
    assert len(out) == 20
    assert np.array_equal(out["power"], f["power"])   # first-seen survives
    assert np.array_equal(out["timestamp"], f["timestamp"])  # input order


def test_garbage_shard_quarantined_not_repaired(ref):
    cols = {k: v.copy() for k, v in clean_frame(n=30).columns.items()}
    cols["power"][:20] = np.nan           # 66% drop > max_repair_fraction
    out, v = check_both(ref, cols)
    assert out is None and v.status == "quarantined"
    assert "excessive_repair" in v.reasons


def test_never_recorded_signal_quarantines(ref):
    cols = dict(clean_frame(n=10).columns)
    cols["power"] = np.full(10, np.nan)
    out, v = check_both(ref, cols)
    assert out is None and v.status == "quarantined"
    assert "missing_required:power" in v.reasons


def test_gaps_reported_never_filled(ref):
    cols = {k: v.copy() for k, v in clean_frame(n=30).columns.items()}
    cols["timestamp"][15:] += 10_000.0    # one hole > max_gap_s
    out, v = check_both(ref, cols)
    assert v.status == "ok" and len(out) == 30      # rows untouched
    assert v.reasons == ("gap_segments:1",)


def test_contract_fields_match_reference(ref):
    """A custom contract changes the verdict the same way on both sides."""
    cols = {k: v.copy() for k, v in clean_frame(n=30).columns.items()}
    cols["power"][2] = 1500.0
    tight = dict(max_power_w=1000.0, max_repair_fraction=0.01)
    _, v = check_frame(TelemetryFrame(cols), HygieneContract(**tight))
    _, rv = ref.hygiene.check_frame(ref.Frame(cols),
                                    ref.hygiene.HygieneContract(**tight))
    assert v.__dict__ == rv.__dict__ and v.status == "quarantined"
    assert HygieneContract().__dict__ == ref.hygiene.HygieneContract().__dict__


def test_check_columns_contract(ref):
    good = {f: np.zeros(3) for f in DEFAULT_CONTRACT.required_fields}
    assert check_columns(good).ok
    missing = dict(good)
    del missing["power"]
    v = check_columns(missing)
    assert v.status == "quarantined" and "missing_required:power" in v.reasons
    ragged = dict(good)
    ragged["power"] = np.zeros(2)
    assert "ragged_columns" in check_columns(ragged).reasons
    bad = dict(good)
    bad["power"] = np.array(["x", "y", "z"])
    assert any(r == "bad_dtype:power" for r in check_columns(bad).reasons)
    for cols in (good, missing, ragged, bad):
        assert check_columns(cols).__dict__ == \
            ref.hygiene.check_columns(cols).__dict__


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_hygiene_idempotent_on_random_dirt(seed):
    from repro.telemetry import hygiene as ref_hygiene
    from repro.telemetry.records import TelemetryFrame as RefFrame
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 120))
    cols = {k: v.copy() for k, v in clean_frame(n=n).columns.items()}
    for col, bad in (("timestamp", np.nan), ("power", -1.0), ("power", 1e6)):
        idx = rng.integers(0, n, size=rng.integers(0, max(1, n // 8)))
        cols[col][idx] = bad
    if rng.random() < 0.5:                # duplicated tail
        k = int(rng.integers(1, max(2, n // 4)))
        cols = {key: np.concatenate([c, c[:k]]) for key, c in cols.items()}
    out, v = check_frame(TelemetryFrame(cols))
    _, rv = ref_hygiene.check_frame(RefFrame(cols))
    assert v.__dict__ == rv.__dict__
    if v.status == "quarantined":
        assert out is None
        return
    assert v.rows_out == len(out) <= v.rows_in
    out2, v2 = check_frame(out)           # fixed point after one pass
    assert v2.status == "ok" and out2 is out


# --------------------------------------------------------------------------- #
# DCGM adapter
# --------------------------------------------------------------------------- #
def test_dcgm_adapter_scales_pads_and_synthesizes_time(ref):
    dump = {
        "DCGM_FI_DEV_POWER_USAGE": [100.0, 110.0, 120.0],
        "DCGM_FI_PROF_SM_ACTIVE": [0.5, 0.6],          # one missed sample
        "DCGM_FI_PROF_PCIE_TX_BYTES": [2e9, 2e9, 2e9],
        "DCGM_FI_SOME_FUTURE_FIELD": [1, 2, 3],        # unknown: ignored
    }
    frame = dcgm_to_frame(dump, device_id=3, job_id=9)
    assert len(frame) == 3
    assert np.array_equal(frame["timestamp"], [0.0, 1.0, 2.0])
    assert np.array_equal(frame["power"], [100.0, 110.0, 120.0])
    assert frame["sm"][0] == 50.0 and np.isnan(frame["sm"][2])  # % + NaN pad
    assert np.allclose(frame["pcie_tx"], 2.0)                   # GB/s
    assert frame["device_id"][0] == 3 and frame["job_id"][0] == 9
    assert set(frame.columns) == set(FIELDS)
    want = ref.hygiene.dcgm_to_frame(dump, device_id=3, job_id=9)
    for f in FIELDS:
        np.testing.assert_array_equal(frame[f], want[f])
        assert frame[f].dtype == want[f].dtype
    short = dcgm_to_frame({"DCGM_FI_DEV_POWER_USAGE": [1.0, 2.0, 3.0]},
                          timestamp=[10.0], dt_s=2.0)
    np.testing.assert_array_equal(short["timestamp"], [10.0, 12.0, 14.0])


def test_ingest_dcgm_lands_a_hygiene_clean_shard(ref):
    dump = {"DCGM_FI_DEV_POWER_USAGE": [100.0] * 30 + [-4.0],
            "DCGM_FI_PROF_SM_ACTIVE": [0.4] * 31}
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as rd:
        store = TelemetryStore(d)
        v = ingest_dcgm(store, dump, host="h0")
        assert v.status == "repaired" and v.repairs == {"bad_power": 1}
        assert store.total_rows == 30
        reread = TelemetryStore(d)
        _, rv = check_frame(reread.read_shard(
            reread.manifest["shards"][0]["file"], verify=True))
        assert rv.status == "ok"
        want = ref.hygiene.ingest_dcgm(ref.Store(rd), dump, host="h0")
        assert v.__dict__ == want.__dict__


def test_ingest_frame_refuses_garbage():
    with tempfile.TemporaryDirectory() as d:
        store = TelemetryStore(d)
        cols = dict(clean_frame(n=10).columns)
        cols["power"] = np.full(10, np.nan)
        v = ingest_frame(store, TelemetryFrame(cols))
        assert v.status == "quarantined"
        assert store.total_rows == 0 and store.manifest["shards"] == []


# --------------------------------------------------------------------------- #
# scrub_store: whole-store sweep
# --------------------------------------------------------------------------- #
def _scrub_fixture(d, store_cls, frame_cls):
    store = store_cls(d)
    store.write_shard(clean_frame(n=50, frame_cls=frame_cls), host="h0")
    dirty = {k: v.copy() for k, v in clean_frame(n=50, t0=100.0).columns.items()}
    dirty["power"][7] = -1.0
    store.write_shard(frame_cls(dirty), host="h0")
    truncated = store.write_shard(clean_frame(n=50, t0=200.0, frame_cls=frame_cls),
                                  host="h0")
    faults.truncate_file(truncated)
    return truncated


def test_scrub_store_repairs_quarantines_and_settles(ref):
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as rd:
        truncated = _scrub_fixture(d, TelemetryStore, TelemetryFrame)
        _scrub_fixture(rd, ref.Store, ref.Frame)

        dry = scrub_store(TelemetryStore(d), dry_run=True)
        assert [v.status for v in dry] == ["ok", "repaired", "quarantined"]
        assert TelemetryStore(d).total_rows == 150     # dry run: untouched

        verdicts = scrub_store(TelemetryStore(d))
        assert [v.status for v in verdicts] == ["ok", "repaired",
                                                "quarantined"]
        want = ref.hygiene.scrub_store(ref.Store(rd))
        assert [v.__dict__ for v in verdicts] == [v.__dict__ for v in want]
        after = TelemetryStore(d)
        assert after.total_rows == 99                  # 50 + 49 survive
        assert len(after.manifest["shards"]) == 2
        assert [q["reason"] for q in after.manifest["quarantine"]] \
            == ["corrupt"]
        assert (after.root / "quarantine" / truncated.name).exists()
        rafter = ref.Store(rd)
        assert [(s["file"], s["rows"]) for s in after.manifest["shards"]] == \
            [(s["file"], s["rows"]) for s in rafter.manifest["shards"]]
        assert all(v.status == "ok" for v in scrub_store(after))
        for s in after.manifest["shards"]:
            after.read_shard(s["file"], verify=True)


# --------------------------------------------------------------------------- #
# storage: corruption detection, drift, recovery, atomicity
# --------------------------------------------------------------------------- #
def test_truncated_shard_raises_strict_and_skips_tolerant():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d)
        entry = store.manifest["shards"][1]
        faults.truncate_file(shard_path(store, entry))
        with pytest.raises(ShardReadError) as ei:
            store.read_shard(entry["file"])
        assert ei.value.reason == "corrupt"
        skips = []
        assert store.read_shard_or_skip(entry["file"], skips,
                                        strict=False) is None
        assert skips == [{"file": entry["file"], "host": entry["host"],
                          "rows": entry["rows"], "reason": "corrupt"}]


@pytest.mark.parametrize("shard_format", ["npy_dir", "npz"])
def test_bitflip_caught_by_checksum_verification(shard_format):
    with tempfile.TemporaryDirectory() as d:
        store = TelemetryStore(d, shard_format=shard_format)
        store.write_shard(clean_frame(n=200), host="h0")
        name = store.manifest["shards"][0]["file"]
        fresh = TelemetryStore(d)
        if shard_format == "npy_dir":
            faults.bitflip_file(store.root / name / "power.npy", offset=180)
            fresh.read_shard(name)                     # plain read: no idea
        else:
            # a flip in the zip's trailing directory comment area still
            # parses; the recorded sha256 catches any byte
            data = bytearray((store.root / name).read_bytes())
            data.extend(b"\0")
            (store.root / name).write_bytes(bytes(data))
        with pytest.raises(ShardReadError) as ei:
            fresh.read_shard(name, verify=True)        # checksummed read
        assert ei.value.reason == "checksum_mismatch"
        skips = []
        assert list(fresh.iter_shards(strict=False, verify=True,
                                      skips=skips)) == []
        assert [s["reason"] for s in skips] == ["checksum_mismatch"]


def test_manifest_disk_drift_reported_as_verdicts():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d)
        assert store.verify_manifest() == []
        victim = store.manifest["shards"][0]["file"]
        (store.root / victim).unlink()
        stray = store.root / "telemetry_h9_d000_99999.npz"
        stray.write_bytes(b"not a shard")
        drift = {(r["file"], r["reason"]) for r in store.verify_manifest()}
        assert drift == {(victim, "missing_file"),
                         (stray.name, "orphan_file")}


def test_poisoned_manifest_recovers_by_rescan():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d)
        before = analysis_key(analyze_store(store, min_job_duration_s=300))
        n_shards = len(store.manifest["shards"])
        faults.poison_json(store.root / "manifest.json")
        recovered = TelemetryStore(d)
        assert recovered.manifest.get("recovered") is True
        assert len(recovered.manifest["shards"]) == n_shards
        after = analysis_key(analyze_store(recovered, min_job_duration_s=300))
        assert after == before


def test_kill_mid_write_never_tears_state():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d)
        baseline = analysis_key(analyze_store(store, min_job_duration_s=300))
        manifest_bytes = (store.root / "manifest.json").read_bytes()
        with faults.dying_renames():
            with pytest.raises(faults.SimulatedKill):
                store.write_shard(clean_frame(n=10), host="h0")
            with pytest.raises(faults.SimulatedKill):
                store.save_manifest()
            with pytest.raises(faults.SimulatedKill):
                ir_mod.save_sidecar(
                    ir_mod.build_ir(store, IRConfig()), store)
            with pytest.raises(faults.SimulatedKill):
                store.merge_manifest_key("run_ir", "deadbeef", {"file": "x"})
        survivor = TelemetryStore(d)
        assert (store.root / "manifest.json").read_bytes() == manifest_bytes
        assert analysis_key(analyze_store(
            survivor, min_job_duration_s=300)) == baseline
        assert survivor.verify_manifest() == []        # no half-written shard


# --------------------------------------------------------------------------- #
# quarantine == clean subset
# --------------------------------------------------------------------------- #
def _dirty_and_clean_pair(d, seed=17, gen=generate_cluster, store_cls=TelemetryStore):
    """One corpus twice: `dirty` has ~10% of shards truncated on disk,
    `clean` has exactly those shards quarantined away."""
    import pathlib
    d = pathlib.Path(d)
    dirty_dir, clean_dir = d / "dirty", d / "clean"
    gen(n_devices=8, horizon_s=900, seed=seed, store=store_cls(dirty_dir),
        shard_s=300)
    shutil.copytree(dirty_dir, clean_dir)
    dirty = store_cls(dirty_dir)
    names = [s["file"] for s in dirty.manifest["shards"]]
    k = max(2, round(0.1 * len(names)))
    victims = names[1:: max(1, len(names) // k)][:k]
    clean = store_cls(clean_dir)
    for name in victims:
        faults.truncate_file(shard_path(dirty, {"file": name}))
        clean.quarantine_shard(name, "corrupt", flush_manifest=False)
    clean.save_manifest()
    return dirty, clean, victims


def test_analyze_skips_quarantined_and_matches_clean_subset(ref):
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as rd:
        dirty, clean, victims = _dirty_and_clean_pair(d)
        assert len(victims) >= 2
        got = analyze_store(dirty, min_job_duration_s=300, strict=False)
        want = analyze_store(clean, min_job_duration_s=300)
        assert analysis_key(got) == analysis_key(want)
        assert sorted(s["file"] for s in got.skipped) == sorted(victims)
        assert 0.0 < got.coverage < 1.0
        lost = sum(s["rows"] for s in got.skipped)
        assert got.coverage == pytest.approx(
            1.0 - lost / dirty.rows_on_disk())
        assert want.coverage == 1.0 and want.skipped == ()
        with pytest.raises(ShardReadError):
            analyze_store(dirty, min_job_duration_s=300)
        rdirty, _, rvictims = _dirty_and_clean_pair(
            rd, gen=ref.generate_cluster, store_cls=ref.Store)
        assert rvictims == victims
        rgot = ref.analyze_store(rdirty, min_job_duration_s=300, strict=False)
        assert got.coverage == rgot.coverage
        assert got.fleet.total_time_s == rgot.fleet.total_time_s
        assert [j.job_id for j in got.jobs] == [j.job_id for j in rgot.jobs]


def test_sweep_and_search_survive_dirty_store_bit_identically(ref):
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as rd:
        dirty, clean, victims = _dirty_and_clean_pair(d, seed=23)
        rdirty, _, _ = _dirty_and_clean_pair(rd, seed=23,
                                             gen=ref.generate_cluster,
                                             store_cls=ref.Store)
        clear_ir_caches(ref)
        got = run_sweep(dirty, _GRID, strict=False, **TORCH)
        clear_ir_caches()
        want = run_sweep(clean, _GRID, **TORCH)
        assert got.outcomes == want.outcomes
        assert 0.0 < got.coverage < 1.0 and want.coverage == 1.0
        oracle = ref.run_sweep(rdirty, ref.grid, min_job_duration_s=300,
                               strict=False)
        assert_oracle(ref.f2d(oracle), frontier_to_dict(got))
        fams = [f for f in default_families(composites=False)
                if f.name == "powercap"]
        clear_ir_caches()
        sgot = search_frontier(dirty, families=fams, max_evals=6,
                               strict=False, **TORCH)
        clear_ir_caches()
        swant = search_frontier(clean, families=fams, max_evals=6, **TORCH)
        assert sgot.frontier.outcomes == swant.frontier.outcomes
        assert sgot.frontier.coverage < 1.0
        assert swant.frontier.coverage == 1.0
        rfams = [f for f in ref.families(composites=False)
                 if f.name == "powercap"]
        clear_ir_caches(ref)
        soracle = ref.search_frontier(rdirty, families=rfams, max_evals=6,
                                      min_job_duration_s=300, strict=False)
        assert_oracle(ref.f2d(soracle.frontier), frontier_to_dict(sgot.frontier))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_zero_faults_identical_to_strict_path(backend):
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d, seed=29)
        kw = dict(TORCH, backend=backend)
        strict = run_sweep(store, _GRID, **kw)
        clear_ir_caches()
        tolerant = run_sweep(store, _GRID, strict=False, verify=True, **kw)
        assert frontier_to_dict(strict) == frontier_to_dict(tolerant)
        assert tolerant.coverage == 1.0
        clear_ir_caches()
        fams = [f for f in default_families(composites=False)
                if f.name == "downscale"]
        a = search_frontier(store, families=fams, max_evals=16, **kw)
        clear_ir_caches()
        b = search_frontier(store, families=fams, max_evals=16, verify=True,
                            **kw)
        assert frontier_to_dict(a.frontier) == frontier_to_dict(b.frontier)


def test_verify_reaches_every_shard_read():
    """``verify=True`` is threaded into the IR build, the IR extend and the
    row path: a bit-flipped ``npy_dir`` column that a plain read accepts is
    skipped under ``strict=False`` and raises under ``strict=True``."""
    with tempfile.TemporaryDirectory() as d:
        store = TelemetryStore(d, shard_format="npy_dir")
        generate_cluster(n_devices=4, horizon_s=900, seed=5, store=store,
                         shard_s=300)
        victim = store.manifest["shards"][-1]
        faults.bitflip_file(store.root / victim["file"] / "power.npy",
                            offset=200)
        for kw in (dict(backend="numpy", min_job_duration_s=300), TORCH):
            clear_ir_caches()
            with pytest.raises(ShardReadError, match="checksum_mismatch"):
                run_sweep(store, _GRID, verify=True, **kw)
        clear_ir_caches()
        got = run_sweep(store, _GRID, verify=True, strict=False,
                        backend="numpy", min_job_duration_s=300)
        assert got.coverage < 1.0
        clear_ir_caches()
        ir = get_ir(store, IRConfig(), strict=False, verify=True)
        assert [s["reason"] for s in ir.skipped] == ["checksum_mismatch"]


def test_frontier_coverage_serializes_and_defaults():
    with tempfile.TemporaryDirectory() as d:
        dirty, _, _ = _dirty_and_clean_pair(d, seed=31)
        f = run_sweep(dirty, _GRID, strict=False, **TORCH)
        payload = frontier_to_dict(f)
        assert payload["coverage"] == f.coverage < 1.0
        assert frontier_from_dict(payload).coverage == f.coverage
        legacy = dict(payload)
        del legacy["coverage"]                 # pre-robustness payloads
        assert frontier_from_dict(legacy).coverage == 1.0


# --------------------------------------------------------------------------- #
# IR sidecar corruption -> rebuild
# --------------------------------------------------------------------------- #
def test_corrupt_sidecar_rebuilds_transparently():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d, seed=7)
        cfg = IRConfig()
        built = get_ir(store, cfg)
        sidecar = store.root / ir_mod.sidecar_name(cfg)
        assert sidecar.exists()
        faults.truncate_file(sidecar)
        clear_ir_caches()
        reloaded = get_ir(TelemetryStore(d), cfg)   # rebuild, not a crash
        assert reloaded.source_rows == built.source_rows
        assert sorted(reloaded.streams) == sorted(built.streams)
        assert sidecar.exists()
        clear_ir_caches()
        assert ir_mod.load_sidecar(TelemetryStore(d), cfg) is not None


def test_poisoned_ir_manifest_entry_rebuilds():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(d, seed=7)
        cfg = IRConfig()
        get_ir(store, cfg)
        fresh = TelemetryStore(d)
        fresh.manifest[ir_mod.MANIFEST_KEY] = {"oops": "not-a-dict-entry"}
        clear_ir_caches()
        assert ir_mod.load_sidecar(fresh, cfg) is None
        ir = get_ir(fresh, cfg)                # falls through to a build
        assert ir.source_rows == fresh.total_rows


# --------------------------------------------------------------------------- #
# observability families
# --------------------------------------------------------------------------- #
def test_degradation_families_registered_and_lintable(tmp_path, ref):
    obs.enable()
    try:
        obs.reset()
        obs.init_degradation_metrics()
        text = obs.render_prometheus()
    finally:
        obs.disable()
        obs.reset()
    for name, _, _ in obs.DEGRADATION_FAMILIES:
        assert f"\n{name} " in text or text.startswith(f"{name} ")
    assert obs.lint_exposition(text) == []
    # the reference's families, the pool's retry counter included
    assert list(ref.obs.DEGRADATION_FAMILIES) == list(obs.DEGRADATION_FAMILIES)
    prom = tmp_path / "metrics.prom"
    prom.write_text(text)
    import prom_lint
    assert prom_lint.check_file(str(prom), [
        "repro_fallbacks_total", "repro_shards_quarantined_total",
        "repro_shards_repaired_total", "repro_partition_retries_total",
        "repro_coverage_fraction"]) == []
    assert prom_lint.check_file(str(prom), ["repro_not_a_metric"]) != []


def test_quarantine_counters_emitted():
    with tempfile.TemporaryDirectory() as d:
        dirty, _, victims = _dirty_and_clean_pair(d, seed=41)
        obs.enable()
        try:
            obs.reset()
            analyze_store(dirty, min_job_duration_s=300, strict=False,
                          compact=False)
            scrub_store(dirty)
            text = obs.render_prometheus()
        finally:
            obs.disable()
            obs.reset()
        # once skipped by the analysis, once quarantined by the scrub
        assert f'repro_shards_quarantined_total{{reason="corrupt"}} ' \
            f'{2 * len(victims)}' in text
        assert 'repro_coverage_fraction{stage="analyze"}' in text
        assert len(TelemetryStore(d + "/dirty").manifest["quarantine"]) == \
            len(victims)
