"""The port's pool DES, perf model and telemetry spill against the JAX
package's.

Mirrors tests/test_serving.py's DES, perf-model, inter-arrival and engine
spill cases on the port, and holds the port to the reference exactly where
both run the same host arithmetic:

* ``simulate_pool`` on copies of the same trace gives the reference's
  ``PoolResult`` bit for bit (energy, every fraction, every latency
  statistic, every request's device, start and finish, every telemetry
  column), for ``bench_fig10``'s three pool policies and ``bench_fig11_12``'s
  three controller modes (benchmarks/paper_benches.py), with and without
  the store spill;
* ``RuntimeSampler.drain_to`` on the same busy/idle sequence writes the
  same shards;
* ``inter_arrival_cdf`` and ``from_roofline`` give the same numbers.

``LLAMA13B_L40S`` is the paper's L40S calibration; nothing here measures a
card.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.core.controller import ControllerConfig as JControllerConfig
from repro.core.controller import DownscaleMode as JDownscaleMode
from repro.core.imbalance import PoolConfig as JPoolConfig
from repro.core.imbalance import PoolPolicy as JPoolPolicy
from repro.core.power_model import SimulatedDevice as JSimDevice
from repro.core.power_model import get_platform as jget_platform
from repro.configs import get_smoke_config as jax_smoke_config
from repro.serving import perf_model as jperf
from repro.serving.des import simulate_pool as jsimulate_pool
from repro.serving.latency import inter_arrival_cdf as jinter_arrival_cdf
from repro.telemetry import RuntimeSampler as JSampler
from repro.telemetry import TelemetryStore as JTelemetryStore
from repro.traces import TRACES as JTRACES
from repro.traces import generate_trace as jgenerate_trace

from repro_torch.configs import get_smoke_config
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.core.imbalance import PoolConfig, PoolPolicy
from repro_torch.core.power_model import SimulatedDevice, get_platform
from repro_torch.models import api
from repro_torch.serving.des import simulate_pool
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.latency import Request, inter_arrival_cdf
from repro_torch.serving.perf_model import LLAMA13B_L40S, PerfModel, from_roofline
from repro_torch.telemetry import RuntimeSampler, TelemetryStore
from repro_torch.traces import TRACES, generate_trace

PLAT = get_platform("l40s")


def small_trace(n=20, gap=5.0, work=1.0):
    perf = LLAMA13B_L40S
    return [Request(req_id=i, arrival_s=i * gap,
                    prompt_tokens=int(perf.prefill_tps * work / 2),
                    output_tokens=int(perf.decode_tps * work / 2))
            for i in range(n)]


def _assert_frames_equal(a, b):
    assert len(a) == len(b)
    assert set(a.columns) == set(b.columns)
    for name in b.columns:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype, name
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), name


# --------------------------------------------------------------------------- #
# tests/test_serving.py's DES and perf-model cases, on the port
# --------------------------------------------------------------------------- #
def test_all_requests_complete_when_underloaded():
    trace = small_trace(n=10, gap=10.0, work=1.0)
    res = simulate_pool(trace, PLAT, LLAMA13B_L40S, PoolConfig(n_devices=1),
                        duration_s=200.0)
    assert res.latency.n == 10
    assert res.latency.p95_s >= 1.0


def test_energy_decreases_with_consolidation():
    """§5.1: consolidating onto fewer devices cuts energy, raises latency."""
    trace = generate_trace(TRACES["azure_code"], 600.0, n_devices=8, seed=0)
    results = {}
    for n_active, policy in ((8, PoolPolicy.BALANCED), (2, PoolPolicy.CONSOLIDATED)):
        pool = PoolConfig(n_devices=8, policy=policy, n_active=n_active,
                          park_inactive=False)
        results[n_active] = simulate_pool(
            [dataclasses.replace(r) for r in trace], PLAT, LLAMA13B_L40S, pool, 600.0)
    assert results[2].energy_j < results[8].energy_j
    assert results[2].latency.p95_s > results[8].latency.p95_s


def test_controller_reduces_power_increases_latency():
    """§5.3: Algorithm 1 cuts average power at a latency cost."""
    trace = generate_trace(TRACES["azure_code"], 900.0, 1, seed=1)
    base = simulate_pool([dataclasses.replace(r) for r in trace], PLAT,
                         LLAMA13B_L40S, PoolConfig(n_devices=1), 900.0)
    ctl = simulate_pool([dataclasses.replace(r) for r in trace], PLAT,
                        LLAMA13B_L40S, PoolConfig(n_devices=1), 900.0,
                        controller_cfg=ControllerConfig(mode=DownscaleMode.SM_AND_MEM))
    assert ctl.avg_power_w < base.avg_power_w * 0.9
    assert ctl.latency.p95_s >= base.latency.p95_s


@given(st.integers(0, 100))
@settings(max_examples=10, deadline=None)
def test_des_energy_time_consistency(seed):
    trace = generate_trace(TRACES["qwen_chat"], 300.0, 1, seed=seed)
    res = simulate_pool(trace, PLAT, LLAMA13B_L40S, PoolConfig(n_devices=1), 300.0)
    assert 0 <= res.exec_idle_time_fraction <= 1
    assert 0 <= res.exec_idle_energy_fraction <= 1
    assert PLAT.deep_idle_w <= res.avg_power_w <= PLAT.tdp_w
    if 0 < res.exec_idle_time_fraction < 1:
        assert res.exec_idle_energy_fraction <= res.exec_idle_time_fraction


def test_perf_model_roofline_derivation():
    cfg = get_smoke_config("gemma-2b")
    pm = from_roofline(cfg, peak_tflops=197.0, hbm_gbps=819.0, n_params=2_500_000_000)
    assert pm.decode_tps > 100
    assert pm.prefill_tps > pm.decode_tps


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-moe-3b-a800m", "qwen1.5-4b"])
@pytest.mark.parametrize("n_params", [None, 2_500_000_000])
def test_perf_model_matches_reference(arch, n_params):
    """``from_roofline`` (its dense parameter estimate too) and the L40S
    calibration are the reference's, float for float."""
    got = from_roofline(get_smoke_config(arch), 989.0, 3350.0, n_params=n_params)
    want = jperf.from_roofline(jax_smoke_config(arch), 989.0, 3350.0, n_params=n_params)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert dataclasses.astuple(LLAMA13B_L40S) == dataclasses.astuple(jperf.LLAMA13B_L40S)
    assert isinstance(got, PerfModel)
    assert got.service_time_s(100, 20) == want.service_time_s(100, 20)


def test_des_store_spill_matches_monolithic_frame(tmp_path):
    """simulate_pool(store=...) spills telemetry into shards instead of
    materializing the full frame; the shards concatenate back to exactly
    the monolithic telemetry."""
    trace = small_trace(n=15, gap=5.0, work=0.5)
    mono = simulate_pool(list(trace), PLAT, LLAMA13B_L40S, PoolConfig(n_devices=2),
                         duration_s=120.0)
    store = TelemetryStore(tmp_path)
    streamed = simulate_pool(list(trace), PLAT, LLAMA13B_L40S, PoolConfig(n_devices=2),
                             duration_s=120.0, store=store, drain_every_s=30.0)
    assert len(streamed.telemetry) == 0
    assert len(store.manifest["shards"]) >= 4
    assert streamed.energy_j == mono.energy_j
    _assert_frames_equal(store.read_all(), mono.telemetry)


@pytest.mark.parametrize("name", list(JTRACES))
def test_inter_arrival_cdf_matches_reference(name):
    """Fig 6's per-device gaps: the port's equal the reference's on every
    trace (bench_fig6's 4 devices x 1,800 s)."""
    reqs = [Request(req_id=i, arrival_s=float(i * 2), prompt_tokens=1,
                    output_tokens=1, device=0) for i in range(5)]
    np.testing.assert_allclose(inter_arrival_cdf(reqs), [2.0] * 4)
    trace = jgenerate_trace(JTRACES[name], 1800.0, n_devices=4, seed=0)
    got = inter_arrival_cdf([Request(*dataclasses.astuple(r)) for r in trace])
    want = jinter_arrival_cdf(trace)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# --------------------------------------------------------------------------- #
# exact parity with the reference's simulate_pool
# --------------------------------------------------------------------------- #
def _fig10_trace():
    spec = dataclasses.replace(JTRACES["azure_code"],
                               gap_median_s=JTRACES["azure_code"].gap_median_s * 1.9)
    return spec, jgenerate_trace(spec, 1800.0, n_devices=8, seed=2)


def _assert_pool_results_equal(got, want, got_trace, want_trace):
    for f in ("energy_j", "avg_power_w", "busy_fraction", "exec_idle_time_fraction",
              "exec_idle_energy_fraction", "avg_sm_util"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.astuple(got.latency) == dataclasses.astuple(want.latency)
    assert [dataclasses.astuple(r) for r in got.requests] == \
        [dataclasses.astuple(r) for r in want.requests]
    # the trace's own Request objects were updated in place
    assert [dataclasses.astuple(r) for r in got_trace] == \
        [dataclasses.astuple(r) for r in want_trace]
    _assert_frames_equal(got.telemetry, want.telemetry)


def _run_both(trace, platform, perf, pool_kw, duration, tmp_path=None, **kw):
    """The port and the reference on copies of ``trace``; with ``tmp_path``
    both spill into stores, returned with the results."""
    jtrace = [dataclasses.replace(r) for r in trace]
    ttrace = [Request(*dataclasses.astuple(r)) for r in trace]
    jpool = JPoolConfig(**{k: JPoolPolicy(v.value) if k == "policy" else v
                           for k, v in pool_kw.items()})
    tpool = PoolConfig(**{k: PoolPolicy(v.value) if k == "policy" else v
                          for k, v in pool_kw.items()})
    jkw, tkw = dict(kw), dict(kw)
    if "mode" in kw:
        mode = jkw.pop("mode")
        tkw.pop("mode")
        if mode is not None:
            jkw["controller_cfg"] = JControllerConfig(mode=JDownscaleMode(mode))
            tkw["controller_cfg"] = ControllerConfig(mode=DownscaleMode(mode))
    stores = None
    if tmp_path is not None:
        stores = (TelemetryStore(tmp_path / "port"), JTelemetryStore(tmp_path / "ref"))
        tkw["store"], jkw["store"] = stores
    want = jsimulate_pool(jtrace, jget_platform(platform.name), perf, jpool, duration, **jkw)
    got = simulate_pool(ttrace, platform, PerfModel(*dataclasses.astuple(perf)), tpool,
                        duration, **tkw)
    _assert_pool_results_equal(got, want, ttrace, jtrace)
    return got, want, stores


FIG10_POOLS = {
    "8active": dict(policy=JPoolPolicy.BALANCED, n_active=8),
    "4active": dict(policy=JPoolPolicy.CONSOLIDATED, n_active=4),
    "2active": dict(policy=JPoolPolicy.CONSOLIDATED, n_active=2),
}


@pytest.mark.parametrize("label", list(FIG10_POOLS))
def test_simulate_pool_matches_reference_fig10(label):
    """bench_fig10's deployment (8 devices, azure_code at 1.9x the median
    gap, 1,800 s, seed 2), each pool policy: the same PoolResult bit for
    bit."""
    spec, trace = _fig10_trace()
    perf = dataclasses.replace(jperf.LLAMA13B_L40S, busy_util=spec.busy_util)
    pool = dict(n_devices=8, park_inactive=False, spill_every=13, **FIG10_POOLS[label])
    got, _, _ = _run_both(trace, get_platform("l40s"), perf, pool, 1800.0, tick_s=0.1)
    assert got.latency.n > 1000


@pytest.mark.parametrize("mode", [None, "sm_only", "sm_and_mem"])
def test_simulate_pool_matches_reference_fig11_12(mode):
    """bench_fig11_12's controller replay (one device, azure_code seed 3,
    0.05 s ticks) at 600 of its 1,175 s, each mode: the same PoolResult bit
    for bit."""
    trace = jgenerate_trace(JTRACES["azure_code"], 600.0, 1, seed=3)
    perf = dataclasses.replace(jperf.LLAMA13B_L40S,
                               busy_util=JTRACES["azure_code"].busy_util)
    got, want, _ = _run_both(trace, get_platform("l40s"), perf, dict(n_devices=1), 600.0,
                             tick_s=0.05, mode=mode)
    assert got.latency.n > 50


def test_simulate_pool_spill_matches_reference(tmp_path):
    """The 2-active pool spilled every 300 s: the port's shards hold the
    reference's rows, shard by shard, and equal its own monolithic frame;
    the parked devices' controllers start downscaled in both."""
    spec, trace = _fig10_trace()
    trace = [r for r in trace if r.arrival_s < 900.0]
    perf = dataclasses.replace(jperf.LLAMA13B_L40S, busy_util=spec.busy_util)
    pool = dict(n_devices=8, park_inactive=False, spill_every=13, **FIG10_POOLS["2active"])
    got, want, (tstore, jstore) = _run_both(trace, get_platform("l40s"), perf, pool, 900.0,
                                            tmp_path=tmp_path, tick_s=0.1,
                                            drain_every_s=300.0)
    assert len(got.telemetry) == len(want.telemetry) == 0
    tshards, jshards = tstore.manifest["shards"], jstore.manifest["shards"]
    assert len(tshards) == len(jshards) == 3
    for ts, js in zip(tshards, jshards):
        _assert_frames_equal(tstore.read_shard(ts["file"]), jstore.read_shard(js["file"]))
    mono, _, _ = _run_both(trace, get_platform("l40s"), perf, pool, 900.0, tick_s=0.1)
    _assert_frames_equal(tstore.read_all(), mono.telemetry)
    assert got.energy_j == mono.energy_j
    frame = mono.telemetry
    parked = frame["device_id"] >= 2
    assert (frame["sm_clk"][parked] < frame["sm_clk"][~parked].max()).any()


# --------------------------------------------------------------------------- #
# the sampler's drain and the engine's spill
# --------------------------------------------------------------------------- #
def _drive(sampler, store, seed):
    rng = np.random.default_rng(seed)
    sampler.load_program()
    drained = []
    for i in range(200):
        if rng.random() < 0.4:
            sampler.idle(float(rng.uniform(0.1, 3.0)))
        else:
            sampler.busy(float(rng.uniform(0.01, 1.5)),
                         compute_util=float(rng.uniform(0.0, 1.0)),
                         hbm_util=float(rng.uniform(0.0, 1.0)))
        if i % 37 == 36:
            drained.append(sampler.drain_to(store, host="h1", flush_manifest=False))
    sampler.unload_program()
    sampler.idle(5.0)
    drained.append(sampler.drain_to(store, host="h1"))
    return drained


def test_drain_to_matches_reference(tmp_path):
    tsamp = RuntimeSampler(SimulatedDevice(get_platform("h100")), job_id=3)
    jsamp = JSampler(JSimDevice(jget_platform("h100")), job_id=3)
    tstore, jstore = TelemetryStore(tmp_path / "port"), JTelemetryStore(tmp_path / "ref")
    assert _drive(tsamp, tstore, 4) == _drive(jsamp, jstore, 4)
    assert len(tsamp.frame()) == 0 and tsamp.last_row() == jsamp.last_row() is not None
    tshards, jshards = tstore.manifest["shards"], jstore.manifest["shards"]
    assert [s["file"] for s in tshards] == [s["file"] for s in jshards]
    assert len(tshards) >= 5
    for ts, js in zip(tshards, jshards):
        _assert_frames_equal(tstore.read_shard(ts["file"]), jstore.read_shard(js["file"]))
    assert len(tsamp.drain()) == 0


def test_engine_serves_requests_end_to_end(tmp_path):
    """The port's CPU engine spills its telemetry into a store
    (tests/test_serving.py's engine case)."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    eng = ServingEngine(cfg, params, EngineConfig(
        n_slots=2, max_seq_len=64, prefill_bucket=16, max_new_tokens=4, device="cpu"))
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, arrival_s=i * 0.3, prompt_tokens=8, output_tokens=4)
            for i in range(5)]
    prompts = {i: rng.integers(2, cfg.vocab_size, 8) for i in range(5)}
    store = TelemetryStore(tmp_path)
    stats = eng.run(reqs, prompts, store=store, drain_every_s=2.0)
    assert stats.n == 5
    assert len(eng.sampler.frame()) == 0      # drained, not retained
    assert eng.sampler.last_row() is not None
    assert len(store.manifest["shards"]) >= 1
    rows = store.read_all()
    assert len(rows) > 0
    assert (rows["job_id"] == 1).all()
    assert np.all(np.diff(rows["timestamp"]) == 1.0)
