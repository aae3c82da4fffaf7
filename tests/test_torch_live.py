"""The port's live controller against the JAX package's, case by case.

Mirrors tests/test_live.py: store polling, the tick loop, coalescing,
publish, crash/resume at every tick-phase boundary, checkpoints, the
supervisor's ladder, the producers and the metric families. Each case runs
the port on ``device="cpu"`` beside the reference on the same shard
sequence (``SyntheticProducer(n_streams=16, window_s=30, dt_s=5.0,
seed=3)``, 3 windows).

The searches replay at the producer's own ``dt_s=5.0`` and keep every job
(``min_job_duration_s=0.0``): at the default ``dt_s=1.0`` the run-level IR
refuses 5-second samples, so the torch backend could not carry the store,
and the default 2-hour job filter would drop every 30-second job.

What "the same frontier" means, per backend:

* the port on ``backend="numpy"`` runs the reference's code and gives its
  canonical frontier JSON byte for byte;
* the port on ``backend="torch"`` (the kernels' plain versions here) sums
  in another order, so its frontier holds to the reference's under the
  oracle contract (the same configs in the same order, counts and times
  exact, floats within 1e-9, the same knee), and a restart of it gives
  *its own* uninterrupted frontier byte for byte.

Ported beside the reference: a ``KernelError`` inside an attempt
propagates out of the supervisor; on the torch rung so does every error
but the host's IR data errors, which descend as in the reference, and so
does a deadline miss; the torch ladder, a checkpoint round trip across the two packages, and the entry
point's default device.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro_torch.kernels import KernelError
from repro_torch.live import (Checkpoint, DcgmDirectoryProducer, LiveConfig,
                              LiveController, Rung, SimulatorProducer,
                              SyntheticProducer, TickSupervisor, ladder,
                              load_checkpoint, parse_power_json,
                              remove_checkpoint, save_checkpoint,
                              watermark_valid)
from repro_torch.live import checkpoint as checkpoint_mod
from repro_torch.live import controller as controller_mod
from repro_torch.live.checkpoint import MID_CHECKPOINT_STAGE
from repro_torch.live.controller import PRE_CHECKPOINT_STAGE, PRE_EXTEND_STAGE
from repro_torch.live.supervisor import (DEVICE_ERRORS, HOST_DATA_ERRORS,
                                         DeviceDeadlineError)
from repro_torch.telemetry import FaultTolerance, TelemetryStore, analyze_store
from repro_torch.telemetry.storage import MANIFEST_NAME
from repro_torch.testing import faults
from repro_torch.whatif import frontier_to_dict
from repro_torch.whatif import ir as ir_mod
from repro_torch.whatif.search import default_families

chaos = pytest.mark.skipif(not os.environ.get("REPRO_CHAOS"),
                           reason="kill -9 crash/resume lane; "
                                  "set REPRO_CHAOS=1 to run")

N_WINDOWS = 3
PRODUCER_KW = dict(n_streams=16, window_s=30, dt_s=5.0, seed=3)
#: replay at the producer's sample interval, keep every job
REPLAY_KW = dict(dt_s=5.0, min_job_duration_s=0.0)
RTOL = ATOL = 1e-9
EXACT_FIELDS = ("name", "params", "n_jobs", "wake_events",
                "downscale_events", "throttled_time_s", "pareto")
BACKENDS = ("torch", "numpy")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's live stack (imported here so the module collects
    on a machine without JAX)."""
    import types

    from repro import live
    from repro import obs as ref_obs
    from repro.telemetry import TelemetryStore as RefStore
    from repro.telemetry import analyze_store as ref_analyze_store
    from repro.whatif import frontier_to_dict as ref_f2d
    from repro.whatif import ir as ref_ir
    from repro.whatif.search import default_families as ref_families
    return types.SimpleNamespace(live=live, obs=ref_obs, Store=RefStore,
                                 f2d=ref_f2d, ir=ref_ir,
                                 families=ref_families,
                                 analyze_store=ref_analyze_store)


def clear_ir_caches(ref=None):
    ir_mod._IR_CACHE.clear()
    ir_mod._IR_UNSUPPORTED.clear()
    if ref is not None:
        ref.ir._IR_CACHE.clear()
        ref.ir._IR_UNSUPPORTED.clear()


def search_kwargs(families_fn, **kw):
    fams = [f for f in families_fn(composites=False) if f.name == "downscale"]
    return {"max_rounds": 1, "families": fams, **REPLAY_KW, **kw}


def fast_cfg(backend="torch", **kw):
    """The port's controller config: the reference tests' fast search."""
    sk = search_kwargs(default_families, **kw.pop("search_kwargs", {}))
    kw.setdefault("max_evals", 16)
    return LiveConfig(backend=backend, device="cpu", search_kwargs=sk, **kw)


def ref_cfg(ref, **kw):
    sk = search_kwargs(ref.families, **kw.pop("search_kwargs", {}))
    kw.setdefault("max_evals", 16)
    return ref.live.LiveConfig(search_kwargs=sk, **kw)


def fkey(frontier):
    """The bit-identity witness: canonical JSON of the frontier codec."""
    return json.dumps(frontier_to_dict(frontier), sort_keys=True)


def close(a, b) -> bool:
    return bool(np.isclose(a, b, rtol=RTOL, atol=ATOL))


def assert_oracle(ref_payload: dict, payload: dict):
    """The port's frontier (codec payload) against the reference's under
    the oracle contract."""
    for k in ("n_rows", "n_jobs", "n_runs", "coverage"):
        assert ref_payload[k] == payload[k], k
    assert len(ref_payload["outcomes"]) == len(payload["outcomes"])
    for a, b in zip(ref_payload["outcomes"], payload["outcomes"]):
        for f, v in a.items():
            if f in EXACT_FIELDS:
                assert v == b[f], (a["params"], f)
            else:
                np.testing.assert_allclose(b[f], v, rtol=RTOL, atol=ATOL)
    assert [(t["i"], t["round"], t["family"]) for t in ref_payload["trace"]] \
        == [(t["i"], t["round"], t["family"]) for t in payload["trace"]]
    for a, b in zip(ref_payload["trace"], payload["trace"]):
        assert close(a["saved_fraction"], b["saved_fraction"])
        assert close(a["penalty_s"], b["penalty_s"])


def assert_same_frontier(ref, ref_frontier, frontier, backend):
    """Byte for byte on the NumPy backend, the oracle contract on torch."""
    want = ref.f2d(ref_frontier)
    if backend == "numpy":
        assert fkey(frontier) == json.dumps(want, sort_keys=True)
    else:
        assert_oracle(want, frontier_to_dict(frontier))


def drive(root, ckpt_path, n_windows, cfg=None, producer_kw=None):
    """The daemon loop in test form (tests/test_live.py's ``drive``):
    drain pending shards before the next append, append windows until
    ``n_windows`` have been emitted, stop when drained. A fresh store,
    producer and controller on every call *is* the restart."""
    store = TelemetryStore(root)
    prod = SyntheticProducer(store, **(producer_kw or PRODUCER_KW))
    prod.window = len(store.manifest["shards"])
    ctrl = LiveController(store, ckpt_path, cfg or fast_cfg())
    for _ in range(20 * n_windows + 20):
        store.refresh()
        if store.shards_since(ctrl.n_shards):
            ctrl.tick()
        elif prod.window < n_windows:
            prod.step()
        else:
            return ctrl
    raise AssertionError("the loop did not drain — controller wedged?")


def ref_drive(ref, root, ckpt_path, n_windows):
    store = ref.Store(root)
    prod = ref.live.SyntheticProducer(store, **PRODUCER_KW)
    prod.window = len(store.manifest["shards"])
    ctrl = ref.live.LiveController(store, ckpt_path, ref_cfg(ref))
    for _ in range(20 * n_windows + 20):
        store.refresh()
        if store.shards_since(ctrl.n_shards):
            ctrl.tick()
        elif prod.window < n_windows:
            prod.step()
        else:
            return ctrl
    raise AssertionError("the reference loop did not drain")


class SimCrash(RuntimeError):
    """In-process stand-in for kill -9 at a tick-phase boundary."""


def arm_crash(monkeypatch, stage, skip=0):
    """Patch the fault hook to raise once at the ``skip``-th occurrence of
    ``stage``; both namespaces, as tests/test_live.py does."""
    state = {"remaining": skip, "fired": False}

    def hook(s):
        if s != stage or state["fired"]:
            return
        if state["remaining"] > 0:
            state["remaining"] -= 1
            return
        state["fired"] = True
        raise SimCrash(s)

    monkeypatch.setattr(controller_mod, "fault_hook", hook)
    monkeypatch.setattr(checkpoint_mod, "fault_hook", hook)
    return state


def with_obs(fn):
    """Run ``fn`` with the port's obs on; return (fn's value, exposition)."""
    obs.enable()
    try:
        obs.reset()
        value = fn()
        text = obs.render_prometheus()
    finally:
        obs.disable()
        obs.reset()
    return value, text


# --------------------------------------------------------------------------- #
# storage: O(1) polling
# --------------------------------------------------------------------------- #
def make_frame(n=10, t0=0.0, job=1, frame_cls=None):
    if frame_cls is None:
        from repro_torch.telemetry.records import TelemetryFrame as frame_cls
    return frame_cls({
        "timestamp": t0 + np.arange(n, dtype=np.float64),
        "hostname": np.zeros(n, np.int32),
        "device_id": np.zeros(n, np.int32),
        "platform": np.zeros(n, np.int32),
        "power": np.full(n, 120.0),
        "sm": np.full(n, 50.0),
        "job_id": np.full(n, job, np.int64),
        "program_resident": np.ones(n, np.int8),
    })


def test_generation_counts_shard_mutations(tmp_path, ref):
    from repro.telemetry.records import TelemetryFrame as RefFrame
    gens = []
    for store, frame_cls in ((TelemetryStore(tmp_path / "s"), None),
                             (ref.Store(tmp_path / "r"), RefFrame)):
        g = [store.generation]
        store.append(make_frame(t0=0.0, frame_cls=frame_cls), host="h0")
        g.append(store.generation)
        store.append(make_frame(t0=100.0, frame_cls=frame_cls), host="h0")
        g.append(store.generation)
        store.quarantine_shard(store.manifest["shards"][-1]["file"], "test")
        store.save_manifest()
        g.append(store.generation)
        gens.append(g)
    assert gens[0][0] == 0 and gens[0][3] > gens[0][2] > gens[0][1] > 0
    assert gens[0] == gens[1]


def test_shards_since_slices_the_suffix(tmp_path, ref):
    store = TelemetryStore(tmp_path / "s")
    rstore = ref.Store(tmp_path / "r")
    from repro.telemetry.records import TelemetryFrame as RefFrame
    for i in range(3):
        store.append(make_frame(t0=100.0 * i), host="h0")
        rstore.append(make_frame(t0=100.0 * i, frame_cls=RefFrame), host="h0")
    assert len(store.shards_since(0)) == 3
    suffix = store.shards_since(2)
    assert [s["file"] for s in suffix] == \
        [store.manifest["shards"][2]["file"]]
    assert [s["file"] for s in suffix] == \
        [s["file"] for s in rstore.shards_since(2)]
    assert store.shards_since(3) == []
    with pytest.raises(ValueError):
        store.shards_since(-1)


def test_refresh_adopts_concurrent_appends(tmp_path):
    reader = TelemetryStore(tmp_path / "s")
    writer = TelemetryStore(tmp_path / "s")
    assert reader.refresh() is False          # nothing changed
    writer.append(make_frame(), host="h0")
    assert reader.refresh() is True
    assert len(reader.manifest["shards"]) == 1
    assert reader.generation == writer.generation
    assert reader.refresh() is False          # idempotent


def test_refresh_keeps_snapshot_on_torn_manifest(tmp_path):
    store = TelemetryStore(tmp_path / "s")
    store.append(make_frame(), host="h0")
    snapshot = json.dumps(store.manifest, sort_keys=True)
    manifest = tmp_path / "s" / MANIFEST_NAME
    manifest.write_text('{"shards": [{"file": "tele')   # mid-write read
    assert store.refresh() is False
    assert json.dumps(store.manifest, sort_keys=True) == snapshot


# --------------------------------------------------------------------------- #
# controller: tick loop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_idle_refreshed_and_published(tmp_path, ref, backend):
    store = TelemetryStore(tmp_path / "store")
    prod = SyntheticProducer(store, **PRODUCER_KW)
    pub = tmp_path / "knee.json"
    ctrl = LiveController(store, tmp_path / "ckpt.json", fast_cfg(backend),
                          publish_path=pub)
    r = ctrl.tick()
    assert r.result == "idle" and not pub.exists()
    prod.step()
    r = ctrl.tick()
    assert r.result == "refreshed" and r.rung == f"warm_{backend}"
    assert r.n_new_shards == 1 and r.coalesced == 0
    assert r.knee is not None and r.staleness_s >= 0
    assert ctrl.n_shards == 1
    published = json.loads(pub.read_text())
    assert published["stale"] is False and published["tick"] == 1
    ckpt = load_checkpoint(tmp_path / "ckpt.json", store)
    assert ckpt.tick == 1 and ckpt.n_shards == 1
    assert ckpt.frontier is not None
    # beside the reference on the same shard
    rstore = ref.Store(tmp_path / "ref")
    ref.live.SyntheticProducer(rstore, **PRODUCER_KW).step()
    rpub = tmp_path / "ref_knee.json"
    rr = ref.live.LiveController(rstore, tmp_path / "ref_ckpt.json",
                                 ref_cfg(ref), publish_path=rpub).tick()
    assert_same_frontier(ref, rr.frontier, r.frontier, backend)
    want = json.loads(rpub.read_text())
    assert published["params"] == want["params"]
    for k in ("energy_saved_j", "saved_fraction", "penalty_s"):
        assert close(published[k], want[k])


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_coalesces_backlog_into_one_extend(tmp_path, ref, backend):
    store = TelemetryStore(tmp_path / "store")
    prod = SyntheticProducer(store, **PRODUCER_KW)
    ctrl = LiveController(store, tmp_path / "ckpt.json", fast_cfg(backend))
    for _ in range(3):
        prod.step()
    r = ctrl.tick()
    assert r.result == "refreshed" and r.rung == f"warm_{backend}"
    assert r.n_new_shards == 3 and r.coalesced == 2
    assert ctrl.n_shards == 3
    assert ctrl.tick_no == 1                  # one tick covered the backlog
    rstore = ref.Store(tmp_path / "ref")
    rprod = ref.live.SyntheticProducer(rstore, **PRODUCER_KW)
    for _ in range(3):
        rprod.step()
    rr = ref.live.LiveController(rstore, tmp_path / "rc.json",
                                 ref_cfg(ref)).tick()
    assert (rr.n_new_shards, rr.coalesced) == (r.n_new_shards, r.coalesced)
    assert_same_frontier(ref, rr.frontier, r.frontier, backend)


def test_run_drains_then_stops_when_idle(tmp_path):
    store = TelemetryStore(tmp_path / "store")
    prod = SyntheticProducer(store, **PRODUCER_KW)
    prod.step()
    ctrl = LiveController(store, tmp_path / "ckpt.json", fast_cfg())
    results = ctrl.run(max_ticks=5, stop_when_idle=True)
    assert [r.result for r in results] == ["refreshed", "idle"]


def test_publish_is_idempotent_across_restart(tmp_path):
    store = TelemetryStore(tmp_path / "store")
    prod = SyntheticProducer(store, **PRODUCER_KW)
    prod.step()
    pub = tmp_path / "knee.json"
    ctrl = LiveController(store, tmp_path / "ckpt.json", fast_cfg(),
                          publish_path=pub)
    ctrl.tick()
    published = pub.read_text()
    pub.unlink()                    # crash between checkpoint and publish
    LiveController(store, tmp_path / "ckpt.json", fast_cfg(),
                   publish_path=pub)
    assert pub.read_text() == published


def test_controller_defaults_to_the_card(monkeypatch, tmp_path):
    """``LiveConfig`` defaults to the torch backend on CUDA, with the JAX
    package's pool and read knobs at its defaults (one process, no mmap);
    without CUDA the controller raises before any tick, and an unknown
    backend raises."""
    cfg = LiveConfig()
    assert (cfg.backend, cfg.device) == ("torch", "cuda")
    assert (cfg.workers, cfg.mmap) == (1, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = TelemetryStore(tmp_path / "store")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveController(store, tmp_path / "ckpt.json")
    with pytest.raises(ValueError, match="unknown backend"):
        LiveController(store, None, LiveConfig(backend="jax", device="cpu"))


# --------------------------------------------------------------------------- #
# crash/resume bit-identity
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_baseline(tmp_path_factory, ref):
    """The reference's uninterrupted frontier over the shard sequence."""
    root = tmp_path_factory.mktemp("ref_baseline")
    clear_ir_caches(ref)
    ctrl = ref_drive(ref, root / "store", root / "ckpt.json", N_WINDOWS)
    assert ctrl.tick_no == N_WINDOWS
    return ctrl.frontier


@pytest.fixture(scope="module")
def baseline_key(tmp_path_factory, ref, ref_baseline):
    """The port's uninterrupted frontier per backend, each held to the
    reference's first."""
    keys = {}
    for backend in BACKENDS:
        root = tmp_path_factory.mktemp(f"baseline_{backend}")
        clear_ir_caches()
        ctrl = drive(root / "store", root / "ckpt.json", N_WINDOWS,
                     fast_cfg(backend))
        assert ctrl.frontier is not None and ctrl.tick_no == N_WINDOWS
        assert_same_frontier(ref, ref_baseline, ctrl.frontier, backend)
        keys[backend] = fkey(ctrl.frontier)
    return keys


@pytest.mark.parametrize("backend", BACKENDS)
def test_restart_every_tick_is_bit_identical(tmp_path, baseline_key, backend):
    """A controller rebuilt from its checkpoint after *every* tick
    converges to the uninterrupted frontier."""
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    prod = SyntheticProducer(store, **PRODUCER_KW)
    for _ in range(N_WINDOWS):
        prod.step()
        clear_ir_caches()
        ctrl = drive(root, ckpt, n_windows=0, cfg=fast_cfg(backend))
    assert ctrl.tick_no == N_WINDOWS
    assert fkey(ctrl.frontier) == baseline_key[backend]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("crash_tick", [0, 1])
@pytest.mark.parametrize("stage", [PRE_EXTEND_STAGE, PRE_CHECKPOINT_STAGE,
                                   MID_CHECKPOINT_STAGE])
def test_crash_at_any_boundary_resumes_bit_identical(
        tmp_path, monkeypatch, baseline_key, stage, crash_tick, backend):
    """Crash at every tick-phase boundary x tick index; the restarted run's
    final frontier equals the uninterrupted baseline byte for byte."""
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    clear_ir_caches()
    state = arm_crash(monkeypatch, stage, skip=crash_tick)
    with pytest.raises(SimCrash):
        drive(root, ckpt, N_WINDOWS, fast_cfg(backend))
    assert state["fired"]
    monkeypatch.undo()              # the "process" died; restart clean
    clear_ir_caches()               # a real restart has cold IR caches
    ctrl = drive(root, ckpt, N_WINDOWS, fast_cfg(backend))
    assert ctrl.tick_no == N_WINDOWS
    assert ctrl.n_shards == N_WINDOWS
    assert fkey(ctrl.frontier) == baseline_key[backend]


@chaos
@pytest.mark.parametrize("stage", [PRE_EXTEND_STAGE, PRE_CHECKPOINT_STAGE,
                                   MID_CHECKPOINT_STAGE])
def test_kill9_child_resumes_bit_identical(tmp_path, stage):
    """The real thing: a child process running the loop is killed by a fire-once
    ``os._exit(13)`` plan at the given boundary, relaunched, and must
    converge to the clean baseline's frontier."""
    child = (
        "import json, pathlib, sys\n"
        "from repro_torch.telemetry.storage import TelemetryStore\n"
        "from repro_torch.live import LiveController, LiveConfig, "
        "SyntheticProducer\n"
        "from repro_torch.whatif.report import frontier_to_dict\n"
        "from repro_torch.whatif.search import default_families\n"
        "root, ckpt, out, n_windows = (sys.argv[1], sys.argv[2], "
        "sys.argv[3], int(sys.argv[4]))\n"
        f"producer_kw = {PRODUCER_KW!r}\n"
        "store = TelemetryStore(root)\n"
        "prod = SyntheticProducer(store, **producer_kw)\n"
        "prod.window = len(store.manifest['shards'])\n"
        "fams = [f for f in default_families(composites=False) "
        "if f.name == 'downscale']\n"
        "cfg = LiveConfig(device='cpu', max_evals=16, "
        "search_kwargs={'max_rounds': 1, 'families': fams, "
        f"**{REPLAY_KW!r}}})\n"
        "ctrl = LiveController(store, ckpt, cfg)\n"
        "for _ in range(20 * n_windows + 20):\n"
        "    store.refresh()\n"
        "    if store.shards_since(ctrl.n_shards):\n"
        "        ctrl.tick()\n"
        "    elif prod.window < n_windows:\n"
        "        prod.step()\n"
        "    else:\n"
        "        break\n"
        "else:\n"
        "    sys.exit(2)\n"
        "pathlib.Path(out).write_text(json.dumps("
        "frontier_to_dict(ctrl.frontier), sort_keys=True))\n"
    )

    def launch(root, ckpt, out):
        return subprocess.run(
            [sys.executable, "-c", child, str(root), str(ckpt), str(out),
             str(N_WINDOWS)],
            env=os.environ.copy(), timeout=600).returncode

    base_out = tmp_path / "baseline.json"
    assert launch(tmp_path / "base_store", tmp_path / "base_ckpt.json",
                  base_out) == 0
    out = tmp_path / "frontier.json"
    with faults.plan(tmp_path / "plan", crash=[stage]):
        rc = launch(tmp_path / "store", tmp_path / "ckpt.json", out)
        assert rc == faults.CRASH_EXIT_CODE     # died at the boundary
        assert not out.exists()
        rc = launch(tmp_path / "store", tmp_path / "ckpt.json", out)
        assert rc == 0                          # fire-once: restart is clean
    assert out.read_text() == base_out.read_text()


# --------------------------------------------------------------------------- #
# checkpoint: atomicity + tolerant restore
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ckpt.json"
    ckpt = Checkpoint(tick=4, n_shards=7, source_rows=9000, generation=11,
                      frontier={"schema_version": 1, "outcomes": []})
    save_checkpoint(ckpt, path)
    assert load_checkpoint(path) == ckpt
    remove_checkpoint(path)
    assert load_checkpoint(path) is None


def test_checkpoint_roundtrip_across_packages(tmp_path, ref):
    """A checkpoint the reference wrote loads in the port and the port's in
    the reference, field for field; a port controller resumed from the
    reference's checkpoint after two ticks ends on the reference's
    uninterrupted frontier, byte for byte on the NumPy backend."""
    rstore = ref.Store(tmp_path / "ref")
    rprod = ref.live.SyntheticProducer(rstore, **PRODUCER_KW)
    rctrl = ref.live.LiveController(rstore, tmp_path / "ref_ckpt.json",
                                    ref_cfg(ref))
    for _ in range(2):
        rprod.step()
        rctrl.tick()
    ref_ckpt = ref.live.load_checkpoint(tmp_path / "ref_ckpt.json")
    mine = load_checkpoint(tmp_path / "ref_ckpt.json")
    assert mine is not None and mine.frontier is not None
    assert dataclass_tuple(mine) == dataclass_tuple(ref_ckpt)
    save_checkpoint(mine, tmp_path / "port_ckpt.json")
    assert (tmp_path / "port_ckpt.json").read_bytes() == \
        (tmp_path / "ref_ckpt.json").read_bytes()
    assert dataclass_tuple(ref.live.load_checkpoint(
        tmp_path / "port_ckpt.json")) == dataclass_tuple(ref_ckpt)

    store = TelemetryStore(tmp_path / "port")
    prod = SyntheticProducer(store, **PRODUCER_KW)
    for _ in range(2):
        prod.step()
    ctrl = LiveController(store, tmp_path / "port_ckpt.json",
                          fast_cfg("numpy"))
    assert (ctrl.tick_no, ctrl.n_shards) == (2, 2)
    prod.step()
    rprod.step()
    assert ctrl.tick().result == "refreshed"
    rctrl.tick()
    assert fkey(ctrl.frontier) == json.dumps(ref.f2d(rctrl.frontier),
                                             sort_keys=True)


def dataclass_tuple(ckpt):
    return (ckpt.tick, ckpt.n_shards, ckpt.source_rows, ckpt.generation,
            json.dumps(ckpt.frontier, sort_keys=True))


def test_checkpoint_commit_is_atomic(tmp_path):
    path = tmp_path / "ckpt.json"
    first = Checkpoint(tick=1, n_shards=1, source_rows=10, generation=1,
                       frontier=None)
    save_checkpoint(first, path)
    with faults.dying_renames():
        with pytest.raises(faults.SimulatedKill):
            save_checkpoint(Checkpoint(tick=2, n_shards=2, source_rows=20,
                                       generation=2, frontier=None), path)
    assert load_checkpoint(path) == first       # destination untouched
    assert path.with_name(path.name + ".tmp").exists()  # orphaned temp
    remove_checkpoint(path)
    assert not path.with_name(path.name + ".tmp").exists()


@pytest.mark.parametrize("mode", ["truncate", "poison"])
def test_corrupt_checkpoint_cold_starts_never_crashes(tmp_path, mode):
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    prod = SyntheticProducer(store, **PRODUCER_KW)
    prod.step()
    LiveController(store, ckpt, fast_cfg()).tick()
    faults.corrupt_checkpoint(ckpt, mode=mode)

    def restart():
        ctrl = LiveController(store, ckpt, fast_cfg())
        assert ctrl.tick_no == 0 and ctrl.frontier is None  # cold start
        return ctrl, ctrl.tick()                   # and the loop still works

    (ctrl, r), text = with_obs(restart)
    assert r.result == "refreshed" and ctrl.n_shards == 1
    assert r.rung == "warm_torch"
    assert ('repro_fallbacks_total{from="checkpoint",'
            'reason="checkpoint_corrupt",to="cold_start"} 1') in text
    assert "repro_live_checkpoint_corrupt_total" in text


def test_bitflipped_checkpoint_never_crashes(tmp_path):
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    SyntheticProducer(store, **PRODUCER_KW).step()
    LiveController(store, ckpt, fast_cfg()).tick()
    faults.corrupt_checkpoint(ckpt, mode="bitflip")
    ctrl = LiveController(store, ckpt, fast_cfg())
    assert ctrl.tick().result in ("refreshed", "idle")


def test_broken_watermark_cold_starts(tmp_path):
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    SyntheticProducer(store, **PRODUCER_KW).step()
    rows = store.total_rows
    save_checkpoint(Checkpoint(tick=3, n_shards=1, source_rows=rows + 1,
                               generation=1, frontier=None), ckpt)
    assert not watermark_valid(load_checkpoint(ckpt), store)
    ctrl, text = with_obs(lambda: LiveController(store, ckpt, fast_cfg()))
    assert ctrl.tick_no == 0
    assert ('repro_fallbacks_total{from="checkpoint",'
            'reason="watermark_broken",to="cold_start"} 1') in text


# --------------------------------------------------------------------------- #
# degradation: poisoned + unreadable shards
# --------------------------------------------------------------------------- #
def test_skewed_shard_serves_stale_knee_and_holds_watermark(tmp_path, ref):
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    prod = SyntheticProducer(store, **PRODUCER_KW)
    prod.step()
    cfg = fast_cfg(fault=FaultTolerance(max_retries=0, timeout_s=None,
                                        backoff_s=0.0))
    ctrl = LiveController(store, ckpt, cfg)
    assert ctrl.tick().result == "refreshed"
    good_key = fkey(ctrl.frontier)
    prod.step()
    # byte-valid shard, clock stepped back an hour: per-stream ordering
    # is violated across shards, poisoning both the IR and row paths
    faults.skew_shard(store, store.manifest["shards"][-1]["file"])

    def stale_tick():
        clear_ir_caches()
        return ctrl.tick()

    r, text = with_obs(stale_tick)
    assert r.result == "stale" and r.stale
    assert r.knee is not None                    # previous knee still served
    assert fkey(ctrl.frontier) == good_key       # frontier unchanged
    assert ctrl.n_shards == 1                    # watermark held: stays pending
    assert 'to="stale_knee"' in text
    # the whole torch ladder was walked before the stale knee
    assert 'from="warm_torch"' in text and 'to="cold_numpy"' in text
    assert 'repro_live_ticks_total{result="stale"} 1' in text
    ckpt_state = load_checkpoint(ckpt, store)
    assert ckpt_state.n_shards == 1              # checkpoint not advanced


def test_unreadable_shard_skipped_with_coverage(tmp_path, ref):
    root, ckpt = tmp_path / "store", tmp_path / "ckpt.json"
    store = TelemetryStore(root)
    prod = SyntheticProducer(store, **PRODUCER_KW)
    prod.step()
    ctrl = LiveController(store, ckpt, fast_cfg())
    assert ctrl.tick().result == "refreshed"
    prod.step()
    faults.truncate_file(root / store.manifest["shards"][-1]["file"])
    clear_ir_caches()
    r = ctrl.tick()                  # strict=False: skip, account, proceed
    assert r.result == "refreshed"
    assert r.coverage < 1.0
    assert ctrl.n_shards == 2        # watermark advances past the skip
    # the reference over the same damage
    rroot = tmp_path / "ref"
    rstore = ref.Store(rroot)
    rprod = ref.live.SyntheticProducer(rstore, **PRODUCER_KW)
    rprod.step()
    rctrl = ref.live.LiveController(rstore, tmp_path / "rc.json", ref_cfg(ref))
    rctrl.tick()
    rprod.step()
    faults.truncate_file(rroot / rstore.manifest["shards"][-1]["file"])
    clear_ir_caches(ref)
    rr = rctrl.tick()
    assert rr.coverage == r.coverage
    assert_oracle(ref.f2d(rr.frontier), frontier_to_dict(r.frontier))


# --------------------------------------------------------------------------- #
# supervisor: retry, ladder, deadline, device errors
# --------------------------------------------------------------------------- #
def test_ladder_shapes(ref):
    assert [r.name for r in ladder("numpy")] == ["warm_numpy", "cold_numpy"]
    assert [r.name for r in ladder("torch")] == \
        ["warm_torch", "warm_numpy", "cold_numpy"]
    assert ladder("torch")[0] == Rung("warm_torch", "torch", True)
    # the reference's jax ladder, shape for shape
    assert [(r.backend, r.warm) for r in ladder("torch")][1:] == \
        [(r.backend, r.warm) for r in ref.live.ladder("jax")][1:]
    assert [r.name for r in ladder("numpy")] == \
        [r.name for r in ref.live.ladder("numpy")]
    with pytest.raises(ValueError):
        TickSupervisor(rungs=[])


def test_supervisor_first_rung_success():
    sup = TickSupervisor(backend="numpy")
    res, rung, err = sup.run(lambda rung: rung.name)
    assert (res, rung.name, err) == ("warm_numpy", "warm_numpy", None)


def test_supervisor_retries_then_descends_ladder():
    calls = []

    def attempt(rung):
        calls.append(rung.name)
        if rung.warm:
            raise ir_mod.IRUnsupportedError("warm poisoned")
        return "cold ok"

    fault = FaultTolerance(max_retries=1, timeout_s=None, backoff_s=0.0)
    (res, rung, err), text = with_obs(
        lambda: TickSupervisor(fault, backend="torch").run(attempt))
    assert res == "cold ok" and rung.name == "cold_numpy" and err is None
    # each failing rung attempted max_retries + 1 times
    assert calls == ["warm_torch", "warm_torch", "warm_numpy", "warm_numpy",
                     "cold_numpy"]
    assert "repro_live_tick_retries_total 2" in text
    assert ('repro_fallbacks_total{from="warm_torch",'
            'reason="IRUnsupportedError",to="warm_numpy"} 1') in text
    assert ('from="warm_numpy",reason="IRUnsupportedError",'
            'to="cold_numpy"') in text


def test_supervisor_exhausted_returns_last_error():
    boom = ValueError("all rungs poisoned")

    def attempt(rung):
        raise boom

    fault = FaultTolerance(max_retries=0, timeout_s=None, backoff_s=0.0)
    res, rung, err = TickSupervisor(fault, backend="numpy").run(attempt)
    assert res is None and rung is None and err is boom


@pytest.mark.parametrize("timeout_s", [None, 30.0])
@pytest.mark.parametrize("error", [
    KernelError("downscale_replay kernel launch failed: CUDA error 700"),
    torch.OutOfMemoryError("CUDA out of memory")])
def test_supervisor_device_errors_propagate(timeout_s, error):
    """A kernel, out-of-memory or CUDA error inside an attempt propagates
    out of ``run`` at once, inline and on the deadline thread: no retry, no
    descent to the host."""
    calls = []

    def attempt(rung):
        calls.append(rung.name)
        raise error

    fault = FaultTolerance(max_retries=2, timeout_s=timeout_s, backoff_s=0.0)

    def run():
        with pytest.raises(type(error)) as ei:
            TickSupervisor(fault, backend="torch").run(attempt)
        return ei.value

    raised, text = with_obs(run)
    assert raised is error and calls == ["warm_torch"]
    assert "repro_fallbacks_total" not in text
    assert "repro_live_tick_retries_total" not in text
    assert isinstance(error, DEVICE_ERRORS)


def test_supervisor_value_error_descends_as_in_the_reference(ref):
    """A data error descends the ladder exactly as the reference's
    supervisor does: the run-level IR's refusal of the store's data (an
    ``IRUnsupportedError``, a ``ValueError``) from the device rung on the
    torch ladder as on its jax ladder, and any ``ValueError`` from a host
    rung on the numpy ladder."""
    def walk(supervisor_cls, fault_cls, backend, error):
        calls = []

        def attempt(rung):
            calls.append((rung.backend, rung.warm))
            if rung.backend != "numpy" or (backend == "numpy" and rung.warm):
                raise error
            return rung.name

        fault = fault_cls(max_retries=1, timeout_s=None, backoff_s=0.0)
        res, rung, err = supervisor_cls(fault, backend=backend).run(attempt)
        return calls, res, err

    from repro.telemetry import FaultTolerance as RefFault
    skew = ir_mod.IRUnsupportedError("stream not time-ordered")
    assert isinstance(skew, ValueError)
    mine = walk(TickSupervisor, FaultTolerance, "torch", skew)
    theirs = walk(ref.live.TickSupervisor, RefFault, "jax", skew)
    assert mine[0] == [("torch", True), ("torch", True), ("numpy", True)]
    assert [c[1] for c in mine[0]] == [c[1] for c in theirs[0]]
    assert mine[1] == theirs[1] == "warm_numpy" and mine[2] is theirs[2] is None
    bad = ValueError("stream not time-ordered")
    mine = walk(TickSupervisor, FaultTolerance, "numpy", bad)
    theirs = walk(ref.live.TickSupervisor, RefFault, "numpy", bad)
    assert mine == theirs == ([("numpy", True), ("numpy", True),
                               ("numpy", False)], "cold_numpy", None)


@pytest.mark.parametrize("timeout_s", [None, 30.0])
@pytest.mark.parametrize("error", [
    ValueError("float64 inputs only"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED"),
    KeyError("bucket")])
def test_supervisor_device_rung_errors_propagate(timeout_s, error):
    """On the torch rung only the host's data errors descend: a wrapper's
    ``ValueError``, a ``RuntimeError`` from torch or any other error
    propagates at once, inline and on the deadline thread, where the host
    rungs would descend on it."""
    calls = []

    def attempt(rung):
        calls.append(rung.name)
        raise error

    fault = FaultTolerance(max_retries=2, timeout_s=timeout_s, backoff_s=0.0)

    def run():
        with pytest.raises(type(error)) as ei:
            TickSupervisor(fault, backend="torch").run(attempt)
        return ei.value

    raised, text = with_obs(run)
    assert raised is error and calls == ["warm_torch"]
    assert "repro_fallbacks_total" not in text
    assert "repro_live_tick_retries_total" not in text
    assert not isinstance(error, DEVICE_ERRORS + HOST_DATA_ERRORS)


def wrong_dtype_cap_scan(sorted_p, caps, *args, **kwargs):
    """The K4 wrapper handed a float32 row: its own guard raises."""
    from repro_torch.kernels.run_replay import cap_bucket_scan
    return cap_bucket_scan(sorted_p.float(), caps, *args, **kwargs)


def failing_chain(*args, **kwargs):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("timeout_s", [None, 30.0])
@pytest.mark.parametrize("family,target,replacement,error,match", [
    ("powercap", "cap_bucket_scan", wrong_dtype_cap_scan, ValueError,
     "float64 inputs only"),
    ("downscale", "downscale_replay", failing_chain, RuntimeError,
     "illegal memory access")])
def test_tick_errors_past_packing_propagate(tmp_path, monkeypatch, timeout_s,
                                            family, target, replacement, error,
                                            match):
    """An error raised once the tick's IR is packed for the card (K4's
    guard, a RuntimeError in place of K7's launch) comes out of
    ``LiveController.tick``: no rung descends to the host, the watermark
    and the checkpoint stay where they were."""
    from repro_torch.whatif import backend as torch_backend
    store = TelemetryStore(tmp_path / "store")
    SyntheticProducer(store, **PRODUCER_KW).step()
    fams = [f for f in default_families(composites=False) if f.name == family]
    cfg = LiveConfig(device="cpu", max_evals=16, fault=FaultTolerance(
        max_retries=1, timeout_s=timeout_s, backoff_s=0.0), search_kwargs={
            "max_rounds": 1, "families": fams, **REPLAY_KW})
    ctrl = LiveController(store, tmp_path / "ckpt.json", cfg)
    monkeypatch.setattr(torch_backend, target, replacement)
    clear_ir_caches()

    def tick():
        with pytest.raises(error, match=match):
            ctrl.tick()

    _, text = with_obs(tick)
    assert "repro_fallbacks_total" not in text
    assert "repro_live_tick_retries_total" not in text
    assert ctrl.n_shards == 0 and ctrl.frontier is None
    assert not (tmp_path / "ckpt.json").exists()


def test_supervisor_deadline_on_device_rung_raises():
    """A deadline miss on the torch rung raises: the abandoned attempt may
    still be running on the card, so the tick does not move to the host."""
    import threading
    release = threading.Event()
    calls = []

    def attempt(rung):
        calls.append(rung.name)
        release.wait(30)

    fault = FaultTolerance(max_retries=3, timeout_s=0.3, backoff_s=0.0)

    def run():
        with pytest.raises(DeviceDeadlineError, match="warm_torch"):
            TickSupervisor(fault, backend="torch").run(attempt)

    try:
        _, text = with_obs(run)
    finally:
        release.set()
    assert calls == ["warm_torch"]
    assert "repro_live_deadline_misses_total 1" in text
    assert "repro_fallbacks_total" not in text


def test_supervisor_deadline_abandons_hung_attempt():
    import time

    def attempt(rung):
        time.sleep(30)

    fault = FaultTolerance(max_retries=3, timeout_s=0.3, backoff_s=0.0)
    (res, rung, err), text = with_obs(
        lambda: TickSupervisor(fault, backend="numpy").run(attempt))
    assert (res, rung, err) == (None, None, None)   # err None -> "deadline"
    assert "repro_live_deadline_misses_total 1" in text


def test_supervisor_threaded_path_still_succeeds():
    def attempt(rung):
        if rung.warm:
            raise RuntimeError("warm fails fast")
        return 42

    fault = FaultTolerance(max_retries=0, timeout_s=30.0, backoff_s=0.0)
    res, rung, err = TickSupervisor(fault, backend="numpy").run(attempt)
    assert res == 42 and rung.name == "cold_numpy" and err is None


# --------------------------------------------------------------------------- #
# producers
# --------------------------------------------------------------------------- #
def test_simulator_producer_matches_one_shot_emission(tmp_path, ref):
    from repro_torch.cluster import generate_cluster
    kw = dict(n_devices=4, horizon_s=900, seed=5, min_job_s=300)
    one_shot = TelemetryStore(tmp_path / "one_shot")
    generate_cluster(store=one_shot, shard_s=300, **kw)
    drip = TelemetryStore(tmp_path / "drip")
    prod = SimulatorProducer(drip, window_s=300, **kw)
    total = 0
    while not prod.exhausted:
        total += prod.step()
    assert total == one_shot.total_rows == drip.total_rows
    a = analyze_store(one_shot, min_job_duration_s=300, compact=False)
    b = analyze_store(drip, min_job_duration_s=300, compact=False)
    assert a.fleet == b.fleet
    assert {j.job_id: j.breakdown for j in a.jobs} == \
        {j.job_id: j.breakdown for j in b.jobs}
    # the reference's producer drips the same shards
    rdrip = ref.Store(tmp_path / "ref_drip")
    rprod = ref.live.SimulatorProducer(rdrip, window_s=300, **kw)
    while not rprod.exhausted:
        rprod.step()
    assert [(s["host"], s["rows"]) for s in rdrip.manifest["shards"]] == \
        [(s["host"], s["rows"]) for s in drip.manifest["shards"]]
    for s, rs in zip(drip.manifest["shards"], rdrip.manifest["shards"]):
        mine, theirs = drip.read_shard(s["file"]), rdrip.read_shard(rs["file"])
        for f in mine.columns:
            np.testing.assert_array_equal(mine[f], theirs[f])


def test_synthetic_producer_deterministic(tmp_path, ref):
    stores = []
    for name in ("a", "b"):
        store = TelemetryStore(tmp_path / name)
        prod = SyntheticProducer(store, **PRODUCER_KW)
        prod.step()
        prod.step()
        stores.append(store)
    rows = [[(s["file"], s["rows"], s["sha256"])
             for s in st.manifest["shards"]] for st in stores]
    assert rows[0] == rows[1]        # byte-identical shard sequences
    rstore = ref.Store(tmp_path / "ref")
    rprod = ref.live.SyntheticProducer(rstore, **PRODUCER_KW)
    rprod.step()
    rprod.step()
    for s, rs in zip(stores[0].manifest["shards"], rstore.manifest["shards"]):
        assert (s["file"], s["rows"]) == (rs["file"], rs["rows"])
        mine, theirs = stores[0].read_shard(s["file"]), rstore.read_shard(rs["file"])
        for f in mine.columns:
            np.testing.assert_array_equal(mine[f], theirs[f])


def test_dcgm_directory_producer_both_layouts(tmp_path, ref):
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    n = 30
    (dumps / "a_dcgm.json").write_text(json.dumps({
        "DCGM_FI_DEV_POWER_USAGE": [150.0 + i for i in range(n)],
        "DCGM_FI_PROF_SM_ACTIVE": [0.5] * n,
        "timestamp": list(range(n)),
        "device_id": 0,
    }))
    (dumps / "b_power.json").write_text(json.dumps({
        "samples": [{"ts": float(i), "power_w": 200.0, "sm_pct": 40.0,
                     "device": 1} for i in range(n)],
    }))
    (dumps / "c_garbage.json").write_text("{not json")
    store = TelemetryStore(tmp_path / "store")

    def poll():
        prod = DcgmDirectoryProducer(store, dumps)
        assert prod.step() == 3
        return prod

    prod, text = with_obs(poll)
    assert len(prod.verdicts) == 2            # garbage skipped, not ingested
    assert len(store.manifest["shards"]) == 2
    assert store.total_rows == 2 * n
    assert ('repro_shards_quarantined_total{reason="unparseable_dump"} 1'
            in text)
    assert prod.step() == 0                   # repoll is idempotent
    rprod = ref.live.DcgmDirectoryProducer(ref.Store(tmp_path / "ref"), dumps)
    rprod.step()
    assert [v.__dict__ for v in prod.verdicts] == \
        [v.__dict__ for v in rprod.verdicts]


def test_parse_power_json_shapes(ref):
    for payload in ({"DCGM_FI_DEV_POWER_USAGE": [1.0], "timestamp": [0.0],
                     "hostname": 4},
                    [{"ts": 1.0, "power_w": 99.0, "sm_pct": 50.0}]):
        assert parse_power_json(payload) == ref.live.parse_power_json(payload)
    cols, kw = parse_power_json({"DCGM_FI_DEV_POWER_USAGE": [1.0],
                                 "timestamp": [0.0], "hostname": 4})
    assert "DCGM_FI_DEV_POWER_USAGE" in cols and kw["hostname"] == 4
    cols, kw = parse_power_json([{"ts": 1.0, "power_w": 99.0,
                                  "sm_pct": 50.0}])
    assert cols["DCGM_FI_DEV_POWER_USAGE"] == [99.0]
    assert cols["DCGM_FI_PROF_SM_ACTIVE"] == [0.5]   # percent -> ratio
    with pytest.raises(ValueError):
        parse_power_json({"neither": "layout"})
    with pytest.raises(ValueError):
        parse_power_json("a string")


# --------------------------------------------------------------------------- #
# observability families
# --------------------------------------------------------------------------- #
def test_live_families_registered_and_lintable(tmp_path, ref):
    def render():
        obs.init_live_metrics()
        return obs.render_prometheus()

    text, _ = with_obs(render)
    assert obs.lint_exposition(text) == []
    assert obs.LIVE_FAMILIES == ref.obs.LIVE_FAMILIES
    for name, kind, _ in obs.LIVE_FAMILIES:
        sample = f"{name}_count" if kind == "histogram" else name
        assert f"\n{sample}" in text or text.startswith(sample)
    prom = tmp_path / "metrics.prom"
    prom.write_text(text)
    import prom_lint
    assert prom_lint.check_file(str(prom), [
        "repro_live_ticks_total", "repro_live_staleness_seconds_count",
        "repro_live_checkpoint_writes_total",
        "repro_live_checkpoint_restores_total",
        "repro_live_coalesced_shards_total"]) == []
