"""The port's serving stack against the JAX package's.

* Both engines, on the same float32 weights, are driven tick by tick on the
  same requests; greedy tokens, slot states and the shared cache length must
  agree after every tick, past the end of the cache as well (for hymba: its
  window layers' rings wrap and its global layers clamp; for RWKV-6: the
  state absorbs left-padded prompts and inactive rows, as the reference's
  does; for whisper and the VLM: the cross caches of zero frames and zero
  vision are spliced with the self caches, at the VLM's batch axis 2 for
  its self cache).
* Sampler rows and ``analyze_job``, driven by explicit busy/idle durations,
  and the Algorithm-1 controller on seeded signal sequences must agree
  exactly.
* The pieces of the captured serve step that run here: the eager decode
  step advances the cache's ``len`` in place (a CUDA graph of it replays
  into the same tensors), the engine runs eagerly on the CPU, and the
  launch counters take a capture's calls out and add them back per replay.
  The replays themselves run on the card
  (tests/test_torch_serving_graphs.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import controller as jctl
from repro.core.power_model import SimulatedDevice as JSimDevice
from repro.core.power_model import get_platform as jget_platform
from repro.models import api as japi
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.latency import Request as JRequest
from repro.telemetry import RuntimeSampler as JSampler
from repro.telemetry import analyze_job as janalyze_job
from repro.traces import generate_trace as jgenerate_trace
import torch

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as tctl
from repro_torch.core.power_model import SimulatedDevice, get_platform
from repro_torch.kernels import decode_attention, flash_attention, rmsnorm
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving.engine import EngineConfig, ServingEngine, clone_cache
from repro_torch.serving.latency import Request
from repro_torch.telemetry import RuntimeSampler, analyze_job
from repro_torch.traces import TRACES, generate_trace

ENGINE = dict(n_slots=2, max_seq_len=16, prefill_bucket=8, max_new_tokens=6,
              controller=True, platform="h100")


def _engines(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    np_params = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), jcfg))
    jeng = JServingEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                          JEngineConfig(**ENGINE))
    teng = ServingEngine(tcfg, params_from_jax(np_params, tcfg, "cpu"),
                         EngineConfig(**ENGINE, device="cpu"))
    return jeng, teng


@pytest.mark.parametrize("arch", ["llama-13b", "gemma-2b", "hymba-1.5b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "whisper-tiny",
                                  "llama-3.2-vision-90b", "deepseek-v3-671b"])
def test_engine_tokens_match_jax_tick_by_tick(arch):
    jeng, teng = _engines(arch)
    rng = np.random.default_rng(0)
    n_req = 12
    prompts = [rng.integers(2, 256, int(rng.integers(3, 12))) for _ in range(n_req)]
    outputs = [int(rng.integers(2, 8)) for _ in range(n_req)]
    nxt, past_end = 0, False
    for tick in range(50):
        # admit in order while a slot is free (same decision for both)
        while nxt < n_req and any(not s.active for s in teng.slots):
            ok_t = teng.submit(Request(nxt, 0.0, len(prompts[nxt]), outputs[nxt]),
                               prompts[nxt])
            ok_j = jeng.submit(JRequest(nxt, 0.0, len(prompts[nxt]), outputs[nxt]),
                               prompts[nxt].astype(np.int32))
            assert ok_t and ok_j
            if tick == 0 and nxt == 0:
                # a prefill leaves the shared length alone
                assert int(teng.cache["len"]) == int(jeng.cache["len"]) == 0
            nxt += 1
        n_t, n_j = teng.decode_tick(), jeng.decode_tick()
        assert n_t == n_j
        assert [s.last_token for s in teng.slots] == [s.last_token for s in jeng.slots]
        assert [s.active for s in teng.slots] == [s.active for s in jeng.slots]
        assert int(teng.cache["len"]) == int(jeng.cache["len"])
        past_end |= int(teng.cache["len"]) > ENGINE["max_seq_len"]
    assert past_end, "the run should carry the shared length past the cache"
    assert len(teng.completed) == len(jeng.completed) > 0
    assert [r.req_id for r in teng.completed] == [r.req_id for r in jeng.completed]


def _drive(sampler, seed):
    rng = np.random.default_rng(seed)
    sampler.load_program()
    for _ in range(300):
        u = rng.random()
        if u < 0.4:
            sampler.idle(float(rng.uniform(0.1, 3.0)))
        else:
            sampler.busy(float(rng.uniform(0.01, 1.5)),
                         compute_util=float(rng.uniform(0.0, 1.0)),
                         hbm_util=float(rng.uniform(0.0, 1.0)),
                         ici_gbs=float(rng.uniform(0.0, 2.0)) if u > 0.9 else 0.0)
    sampler.unload_program()
    sampler.idle(5.0)


@pytest.mark.parametrize("platform,seed", [("h100", 0), ("l40s", 1), ("tpu_v5e", 2)])
def test_sampler_rows_and_analyze_job_match_jax(platform, seed):
    tsamp = RuntimeSampler(SimulatedDevice(get_platform(platform)), job_id=1)
    jsamp = JSampler(JSimDevice(jget_platform(platform)), job_id=1)
    _drive(tsamp, seed)
    _drive(jsamp, seed)
    tf, jf = tsamp.frame(), jsamp.frame()
    assert len(tf) == len(jf) > 100
    assert set(tf.columns) == set(jf.columns)
    for name in jf.columns:
        a, b = tf[name], jf[name]
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name
    for min_s in (1.0, 5.0):
        ta, ja = analyze_job(tf, 1, min_s), janalyze_job(jf, 1, min_s)
        assert np.array_equal(ta.states, ja.states)
        assert {int(k): v for k, v in ta.breakdown.time_s.items()} == \
            {int(k): v for k, v in ja.breakdown.time_s.items()}
        assert {int(k): v for k, v in ta.breakdown.energy_j.items()} == \
            {int(k): v for k, v in ja.breakdown.energy_j.items()}
        assert [(int(i.state), i.start, i.end) for i in ta.intervals] == \
            [(int(i.state), i.start, i.end) for i in ja.intervals]
        assert ta.exec_idle_time_fraction == ja.exec_idle_time_fraction
        assert ta.exec_idle_energy_fraction == ja.exec_idle_energy_fraction


@pytest.mark.parametrize("mode", ["sm_only", "sm_and_mem"])
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_matches_jax(mode, seed):
    rng = np.random.default_rng(seed)
    tdev, jdev = SimulatedDevice(get_platform("h100")), JSimDevice(jget_platform("h100"))
    tc = tctl.ExecutionIdleController(tdev, tctl.ControllerConfig(
        threshold_x_s=2.0, cooldown_y_s=4.0, mode=tctl.DownscaleMode(mode)))
    jc = jctl.ExecutionIdleController(jdev, jctl.ControllerConfig(
        threshold_x_s=2.0, cooldown_y_s=4.0, mode=jctl.DownscaleMode(mode)))
    names = ["sm", "tensor", "dram", "pcie_rx", "nvlink_tx", "ici_rx"]
    t = 0.0
    for _ in range(2000):
        # long quiet stretches with bursts, so both branches fire often
        quiet = rng.random() < 0.8
        sample = {k: float(rng.uniform(0, 0.04 if quiet else 0.5)) for k in names
                  if rng.random() < 0.8}
        if quiet and rng.random() < 0.05:
            sample["pcie_rx"] = 2.0
        t += 1.0
        assert tc.step(t, sample) == jc.step(t, sample)
        assert tdev.clocks() == tuple(jdev.clocks())
    assert dataclasses.asdict(tc.stats) == dataclasses.asdict(jc.stats)
    assert tc.stats.downscale_events > 5 and tc.stats.restore_events > 5
    assert tdev.switch_count == jdev.switch_count


def test_traces_match_jax():
    for name in TRACES:
        a = generate_trace(TRACES[name], 600.0, n_devices=2, seed=3)
        b = jgenerate_trace(TRACES[name], 600.0, n_devices=2, seed=3)
        assert [dataclasses.astuple(r) for r in a] == [dataclasses.astuple(r) for r in b]


def test_serve_launcher_runs_past_cache_end_on_cpu():
    """``launch.serve`` end to end on the CPU; with a 32-slot cache the
    shared length runs past its end and serving goes on."""
    out = serve.main(["--arch", "llama-13b", "--smoke", "--device", "cpu",
                      "--duration", "60", "--max-seq", "32", "--controller"])
    assert out["completed"] >= 1
    assert out["cache_len"] > 32
    tel = out["telemetry"]
    assert 0.0 <= tel["exec_idle_time_fraction"] <= 1.0
    assert out["controller_downscales"] >= 1


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b"])
def test_serve_launcher_runs_recurrent_archs_on_cpu(arch):
    """``launch.serve --arch hymba-1.5b|rwkv6-3b --smoke --device cpu``: the
    recurrent families serve end to end with the controller on."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--duration", "30", "--max-seq", "32", "--controller"])
    assert out["arch"] == arch + "-smoke"
    assert out["completed"] >= 1
    assert 0.0 <= out["telemetry"]["exec_idle_time_fraction"] <= 1.0


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b",
                                  "deepseek-v3-671b"])
def test_serve_launcher_runs_new_families_on_cpu(arch):
    """``launch.serve --arch whisper-tiny|llama-3.2-vision-90b|deepseek-v3-671b
    --smoke --device cpu``: the encoder-decoder, the VLM and MLA serve end to
    end with the controller on, past the cache's end."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--duration", "30", "--max-seq", "32", "--controller"])
    assert out["arch"] == arch + "-smoke"
    assert out["completed"] >= 1
    assert 0.0 <= out["telemetry"]["exec_idle_time_fraction"] <= 1.0


# --------------------------------------------------------------------------- #
# the captured serve step: what runs on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama-13b", "gemma-2b", "hymba-1.5b", "rwkv6-3b",
                                  "whisper-tiny", "llama-3.2-vision-90b",
                                  "deepseek-v3-671b"])
def test_eager_decode_step_advances_len_in_place(arch):
    """``decode_step`` returns the cache it was given, ``len`` advanced in
    its own tensor, and past the cache's end the shared length goes on and
    the keys clamp to the last slot (the dense family), as the reference's."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    cache = api.init_cache(cfg, 2, 16, "cpu")
    length = cache["len"]
    length.fill_(13)
    rows = [t.clone() for t, _ in api.cache_rows(cfg, cache)]
    tokens = torch.tensor([[5], [9]])
    for step in range(5):                  # len 13 -> 18, past the 16 slots
        out, logits = api.decode_step(params, cache, tokens, cfg)
        assert out is cache and out["len"] is length
        assert length.dtype == torch.int32 and int(length) == 14 + step
        assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert any(not torch.equal(a, t) for a, (t, _) in zip(rows, api.cache_rows(cfg, cache)))
    if cfg.family == "dense":
        k = cache["k"]
        assert torch.equal(k[:, :, :13], rows[0][:, :, :13])     # untouched
        assert not torch.equal(k[:, :, 15], rows[0][:, :, 15])   # the clamped slot


def test_cpu_engine_steps_are_eager():
    """On the CPU the engine captures nothing: its decode and prefill are the
    model's functions on its own cache."""
    cfg = dataclasses.replace(get_smoke_config("llama-13b"), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    eng = ServingEngine(cfg, params, EngineConfig(**ENGINE, device="cpu"))
    assert eng.graphs == {} and eng.bucket == ENGINE["prefill_bucket"]
    before = clone_cache(eng.cache)
    tokens = torch.tensor([[3], [4]])
    logits = eng.decode(tokens)
    _, want = api.decode_step(params, before, tokens, cfg)
    assert torch.equal(logits, want) and int(eng.cache["len"]) == 1
    for (a, _), (b, _) in zip(api.cache_rows(cfg, eng.cache), api.cache_rows(cfg, before)):
        assert torch.equal(a, b)
    prompt = torch.arange(2, 2 + eng.bucket)[None]
    (got_cache, got), (want_cache, want) = eng.prefill(prompt), api.prefill(params, prompt, cfg)
    assert torch.equal(got, want) and torch.equal(got_cache["k"], want_cache["k"])


def test_graph_launch_accounting():
    """A capture's wrapper calls are the graph's launches: taken out of the
    counters (a capture launches nothing), added back once per replay, the
    tensor-core count too; a capture that raises is taken out as well."""
    before = kernels.launch_counts()
    wgmma = flash_attention.WGMMA_LAUNCHES
    with kernels.captured_launches() as graph:
        rmsnorm.LAUNCHES += 3          # as three wrapper calls would count
        decode_attention.LAUNCHES += 2
        flash_attention.LAUNCHES += 1
        flash_attention.WGMMA_LAUNCHES += 1
    assert graph == dict(dict.fromkeys(before, 0), rmsnorm=3, decode_attention=2,
                         flash_attention=1, **{kernels.WGMMA: 1})
    assert kernels.launch_counts() == before and flash_attention.WGMMA_LAUNCHES == wgmma
    kernels.count_replay(graph)
    kernels.count_replay(graph)
    assert kernels.launch_counts() == {k: n + 2 * graph[k] for k, n in before.items()}
    assert flash_attention.WGMMA_LAUNCHES == wgmma + 2
    after = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        with kernels.captured_launches() as failed:
            rmsnorm.LAUNCHES += 5
            raise RuntimeError("capture failed")
    assert failed["rmsnorm"] == 5 and kernels.launch_counts() == after
    kernels.count_replay(graph, -2)
    assert kernels.launch_counts() == before and flash_attention.WGMMA_LAUNCHES == wgmma
