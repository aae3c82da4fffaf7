"""The port's process pool against the JAX package's.

``map_shard_partitions`` splits a store by host label and runs the host
work (the row replay, the fleet accumulator, the IR build, ``replay_ir``)
in a forkserver pool under ``run_supervised``, merging in submit order, so
every worker count gives ``workers=1``'s bits. Each case here holds the
port at ``workers=2`` to ``workers=1`` and to the reference, mirrors
tests/test_robustness.py's four pool-worker cases (a crashed worker retried
to the same answer, a hung one timed out, retries exhausted and degraded
to the parent, a crash and corrupt shards in one sweep), checks that a
worker's spans and metrics come home with obs on and leave the answer as it
is with obs off, and runs the live controller at ``workers=2``. The fixture
stores have two host labels, so ``workers=2`` really starts a pool; the
cases that start one are few, since each start costs the fork server's
children their imports.
"""
import dataclasses
import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest

from repro.cluster import generate_cluster as ref_generate_cluster
from repro.telemetry import TelemetryStore as RefStore
from repro.telemetry import analyze_store as ref_analyze_store
from repro.whatif import build_ir as ref_build_ir

from repro_torch import obs
from repro_torch.cluster import generate_cluster
from repro_torch.live import LiveConfig, LiveController, SimulatorProducer
from repro_torch.telemetry import (FaultTolerance, FleetAccumulator,
                                   TelemetryStore, analyze_store)
from repro_torch.telemetry.pipeline import map_shard_partitions, run_supervised
from repro_torch.testing import faults
from repro_torch.whatif import (DownscalePolicy, IRBuilder, IRConfig, NoOpPolicy,
                                PowerCapPolicy, build_ir, frontier_to_dict,
                                replay_ir, run_sweep)
from repro_torch.whatif import ir as ir_mod
from repro_torch.whatif.search import default_families

_GRID = [NoOpPolicy(), DownscalePolicy()]


def make_store(d, n_devices=8, horizon_s=900, seed=13, shard_s=300,
               shard_format="npz"):
    store = TelemetryStore(d, shard_format=shard_format)
    generate_cluster(n_devices=n_devices, horizon_s=horizon_s, seed=seed,
                     store=store, shard_s=shard_s)
    assert len({s["host"] for s in store.manifest["shards"]}) > 1
    return store


def analysis_key(a):
    """tests/test_robustness.py's witness: everything analysis produces but
    the robustness accounting."""
    return (a.fleet, a.unattributed_energy_j, a.n_intervals,
            [(j.job_id, j.duration_s, j.breakdown, tuple(j.intervals))
             for j in a.jobs])


def ref_key(a):
    """The same witness from either package, with the state enums as ints."""
    def bd(b):
        return ({int(k): v for k, v in b.time_s.items()},
                {int(k): v for k, v in b.energy_j.items()})
    return (bd(a.fleet), a.unattributed_energy_j, a.n_intervals,
            [(j.job_id, j.duration_s, bd(j.breakdown),
              [(i.start, i.end, int(i.state)) for i in j.intervals])
             for j in a.jobs])


def clear_ir_caches():
    ir_mod._IR_CACHE.clear()
    ir_mod._IR_UNSUPPORTED.clear()


@pytest.fixture(scope="module")
def pair():
    """(reference store, port store) from one seed, two host labels."""
    with tempfile.TemporaryDirectory() as d_ref, tempfile.TemporaryDirectory() as d:
        ref_generate_cluster(n_devices=8, horizon_s=900, seed=13,
                             store=RefStore(d_ref), shard_s=300)
        store = make_store(d)
        yield RefStore(d_ref), store


# --------------------------------------------------------------------------- #
# partitions, merges and the pool's identities
# --------------------------------------------------------------------------- #
def test_partition_hosts_and_merges_match_reference(pair):
    ref_store, store = pair
    for workers in (1, 2, 3, 8):
        assert store.partition_hosts(workers) == ref_store.partition_hosts(workers)
    hosts = [s["host"] for s in store.manifest["shards"]][:1]
    assert store.partition_hosts(2, hosts) == ref_store.partition_hosts(2, hosts)
    # disjoint accumulators merge to the one-pass result; overlap raises
    kw = dict(min_job_duration_s=300)
    whole = FleetAccumulator(**kw)
    parts = []
    for part in store.partition_hosts(2):
        acc = FleetAccumulator(**kw)
        for frame in store.iter_shards(part):
            acc.update(frame)
            whole.update(frame)
        parts.append(acc)
    merged = parts[0].merge(parts[1])
    assert analysis_key(merged.finalize()) == analysis_key(whole.finalize())
    with pytest.raises(ValueError, match="overlapping"):
        parts[1].merge(parts[1])
    with pytest.raises(ValueError, match="configs"):
        FleetAccumulator(min_job_duration_s=1.0).merge(
            FleetAccumulator(min_job_duration_s=2.0))
    builder = IRBuilder(IRConfig())
    for frame in store.iter_shards(store.partition_hosts(2)[0]):
        builder.update(frame)
    with pytest.raises(ValueError, match="overlapping"):
        builder.merge(builder)


def test_build_ir_and_analyze_store_workers_match_reference(pair):
    """``build_ir(workers=2)`` equals ``workers=1`` and the reference's
    (counts and run tables); ``analyze_store(workers=2)`` on rows equals
    ``workers=1`` and the reference's."""
    ref_store, store = pair
    one = build_ir(store, IRConfig(), workers=1)
    two = build_ir(store, IRConfig(), workers=2, mmap=True)
    ref = ref_build_ir(ref_store, workers=2)
    assert list(one.streams) == list(two.streams) == list(ref.streams)
    assert one.source_rows == two.source_rows == ref.source_rows
    assert one.n_runs == two.n_runs == ref.n_runs
    for key, r in ref.streams.items():
        for f in ("state", "low", "length", "power_sum", "power"):
            np.testing.assert_array_equal(getattr(two.streams[key], f),
                                          getattr(r, f), err_msg=f)
            np.testing.assert_array_equal(getattr(one.streams[key], f),
                                          getattr(r, f), err_msg=f)
    # the per-chunk unattributed pairs arrive in partition order; their
    # consumers sum them with math.fsum, which is exact in any order
    assert sorted(one.unattributed) == sorted(two.unattributed)
    a1 = analyze_store(store, min_job_duration_s=300, compact=False)
    a2 = analyze_store(store, min_job_duration_s=300, compact=False, workers=2)
    ar = ref_analyze_store(ref_store, min_job_duration_s=300, compact=False,
                           workers=2)
    assert analysis_key(a1) == analysis_key(a2)
    assert ref_key(a2) == ref_key(ar)


def test_replay_ir_workers_and_obs_transport(pair):
    """``replay_ir(workers=2)`` equals ``workers=1``; with obs on, each
    worker's ``replay_ir.partition`` span hangs off the parent's span and
    its metrics fold into the parent's registry, in task order, and the
    answer is the obs-off answer bit for bit."""
    _, store = pair
    ir = build_ir(store, IRConfig())
    grid = _GRID + [PowerCapPolicy(cap_fraction=0.5)]
    kw = dict(min_job_duration_s=300)
    one = replay_ir(ir, grid, **kw)
    two = replay_ir(ir, grid, workers=2, **kw)
    assert [dataclasses.asdict(r) for r in one] == \
        [dataclasses.asdict(r) for r in two]
    obs.enable()
    try:
        obs.reset()
        with obs.span("outer"):
            traced = replay_ir(ir, grid, workers=2, **kw)
        spans = obs.spans()
        text = obs.render_prometheus()
    finally:
        obs.disable()
        obs.reset()
    assert [dataclasses.asdict(r) for r in traced] == \
        [dataclasses.asdict(r) for r in one]
    outer = next(s for s in spans if s.name == "outer")
    parts = [s for s in spans if s.name == "replay_ir.partition"]
    assert len(parts) == 2
    assert all(s.parent_id == outer.span_id and s.pid != os.getpid()
               for s in parts)
    assert 'repro_pool_workers{stage="replay_ir"} 2' in text


def test_run_supervised_returns_in_task_order():
    out = run_supervised(divmod, [(7, 2), (9, 4), (1, 3)], stage="test")
    assert out == [(3, 1), (2, 1), (0, 1)]


def test_map_shard_partitions_serial_in_process(pair):
    """One partition (or ``workers=1``) runs the worker in this process."""
    _, store = pair
    from repro_torch.telemetry.pipeline import _accumulate_shards
    acc_kw = dict(min_job_duration_s=300)
    acc, skips = map_shard_partitions(
        store, None, 1, _accumulate_shards, (False, acc_kw, True, False),
        merge=lambda a, b: a.merge(b), stage="analyze")
    assert skips == [] and acc.n_rows == store.total_rows


# --------------------------------------------------------------------------- #
# tests/test_robustness.py's pool fault supervisor cases
# --------------------------------------------------------------------------- #
def test_crashing_worker_is_retried_to_the_same_answer():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(pathlib.Path(d) / "store")
        want = analysis_key(analyze_store(store, min_job_duration_s=300,
                                          compact=False))
        tol = FaultTolerance(max_retries=2, backoff_s=0.01)
        obs.enable()
        try:
            obs.reset()
            with faults.plan(pathlib.Path(d) / "plan", crash=("analyze",)):
                got = analyze_store(store, min_job_duration_s=300, workers=2,
                                    fault=tol, compact=False)
            text = obs.render_prometheus()
        finally:
            obs.disable()
            obs.reset()
        assert analysis_key(got) == want and got.coverage == 1.0
        assert 'repro_partition_retries_total{reason="BrokenProcessPool",' \
            'stage="analyze"}' in text
        assert 'from="pool"' not in text


def test_hung_worker_times_out_and_retries():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(pathlib.Path(d) / "store")
        want = analysis_key(analyze_store(store, min_job_duration_s=300,
                                          compact=False))
        tol = FaultTolerance(max_retries=1, timeout_s=2.0, backoff_s=0.01)
        with faults.plan(pathlib.Path(d) / "plan", hang=("analyze",),
                         hang_s=60.0):
            got = analyze_store(store, min_job_duration_s=300, workers=2,
                                fault=tol, compact=False)
        assert analysis_key(got) == want


def test_exhausted_retries_degrade_to_in_process():
    with tempfile.TemporaryDirectory() as d:
        store = make_store(pathlib.Path(d) / "store")
        want = analysis_key(analyze_store(store, min_job_duration_s=300,
                                          compact=False))
        obs.enable()
        try:
            obs.reset()
            with faults.plan(pathlib.Path(d) / "plan", crash=("analyze",)):
                got = analyze_store(store, min_job_duration_s=300, workers=2,
                                    fault=FaultTolerance(max_retries=0,
                                                         backoff_s=0.01),
                                    compact=False)
            text = obs.render_prometheus()
        finally:
            obs.disable()
            obs.reset()
        assert analysis_key(got) == want      # parent redid the lost work
        assert 'repro_fallbacks_total{from="pool"' in text
        assert "repro_partition_retries_total" in text


def test_sweep_survives_crashing_worker_and_corrupt_shards_together():
    """~10% corrupt shards and a crashing pool worker in one run: the
    torch backend's sweep completes, skips exactly the damaged shards, and
    equals the clean subset's bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        dirty = make_store(d / "dirty", seed=37)
        shutil.copytree(d / "dirty", d / "clean")
        names = [s["file"] for s in dirty.manifest["shards"]]
        k = max(2, round(0.1 * len(names)))
        victims = names[1:: max(1, len(names) // k)][:k]
        clean = TelemetryStore(d / "clean")
        for name in victims:
            faults.truncate_file(dirty.root / name)
            clean.quarantine_shard(name, "test")
        clear_ir_caches()
        want = run_sweep(clean, _GRID, device="cpu", min_job_duration_s=300)
        clear_ir_caches()
        with faults.plan(d / "plan", crash=("replay_ir",)):
            got = run_sweep(dirty, _GRID, device="cpu", min_job_duration_s=300,
                            workers=2, strict=False,
                            fault=FaultTolerance(max_retries=2, backoff_s=0.01))
        assert got.outcomes == want.outcomes
        assert got.coverage < 1.0
        clear_ir_caches()
        with faults.plan(d / "plan2", crash=("sweep",)):
            rows = run_sweep(dirty, _GRID, device="cpu", min_job_duration_s=300,
                             workers=2, strict=False, compact=False,
                             fault=FaultTolerance(max_retries=2, backoff_s=0.01))
        clean_rows = run_sweep(clean, _GRID, device="cpu",
                               min_job_duration_s=300, compact=False)
        assert rows.outcomes == clean_rows.outcomes and rows.coverage < 1.0


# --------------------------------------------------------------------------- #
# the live controller at workers=2
# --------------------------------------------------------------------------- #
def test_live_controller_workers_match_workers_1(tmp_path):
    """Two controllers on one drip-fed fleet, one at ``workers=2``: every
    tick refreshes to the same frontier bit for bit, the pool's rounds on
    rows (``compact=False``) included."""
    fams = [f for f in default_families(composites=False)
            if f.name == "downscale"]
    results = {}
    for workers in (1, 2):
        store = TelemetryStore(tmp_path / f"w{workers}" / "store")
        prod = SimulatorProducer(store, n_devices=8, horizon_s=1200,
                                 window_s=600, seed=5, min_job_s=300)
        cfg = LiveConfig(device="cpu", max_evals=16, workers=workers,
                         search_kwargs={"max_rounds": 1, "families": fams,
                                        "compact": False,
                                        "min_job_duration_s": 0.0})
        ctrl = LiveController(store, tmp_path / f"w{workers}" / "ckpt.json",
                              cfg)
        keys = []
        while not prod.exhausted:
            prod.step()
            r = ctrl.tick()
            assert r.result == "refreshed" and r.rung == "warm_torch"
            keys.append(frontier_to_dict(ctrl.frontier))
        assert len({s["host"] for s in store.manifest["shards"]}) > 1
        results[workers] = keys
    assert len(results[1]) == 2
    assert results[1] == results[2]
