"""The program's own spans and marks, on the CPU.

Under ``torch.profiler`` the serving engine's ``submit`` and ``decode_tick``
and the trainer's loop body annotate the trace with their spans, under the
names and the nesting their modules document; with no profiler and obs off
``obs.span`` is the shared no-op and builds no ``record_function``; a
recorded span's start, placed on the trace's clock, lies inside its trace
event; both train step functions launch their marks in the order forward,
backward, update, done; greedy tokens and losses are the same bit for bit
with the profiler on and off. And the trainer's controller reads the newest
telemetry row as the whole frame's last row read it. The file imports no
JAX.
"""
import dataclasses
import importlib
import json
import time

import pytest
import torch
import torch.distributed as tdist
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels, obs
from repro_torch.configs import get_smoke_config
from repro_torch.models import api
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.latency import Request
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
from test_torch_sharded_graphs import _CpuGraph, cpu_graphs  # noqa: F401  (fixture)

#: the module (``repro_torch.obs.spans`` the attribute is the function)
spans_mod = importlib.import_module("repro_torch.obs.spans")

ENGINE = dict(n_slots=2, max_seq_len=32, prefill_bucket=8, max_new_tokens=4,
              controller=True, eos_token=-1, device="cpu")
#: what the engine's and the trainer's spans nest in, by the modules' docs
SUBMIT = ["engine.stage", "engine.prefill", "engine.splice_cache", "engine.first_token"]
TICK = ["engine.stage", "engine.decode", "engine.read_tokens", "engine.controller"]
HARNESS = {"window", "submit", "decode_tick", "client", "batch", "step", "host"}


@pytest.fixture(autouse=True)
def obs_off():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def annotations(prof, tmp_path) -> tuple[list[dict], int]:
    """The trace's ``user_annotation`` events, each with its ``parent`` (the
    innermost event that holds it), and the trace's base time."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                    key=lambda e: (e["ts"], -e["dur"]))
    for i, e in enumerate(events):
        holders = [p for p in events[:i] if p["ts"] + p["dur"] >= e["ts"] + e["dur"]]
        e["parent"] = holders[-1]["name"] if holders else None
    return events, trace["baseTimeNanoseconds"]


def children(events, parent: str) -> list[list[str]]:
    """For each event named ``parent``, its children's names in order."""
    out = []
    for p in (e for e in events if e["name"] == parent):
        end = p["ts"] + p["dur"]
        out.append([e["name"] for e in events if e["parent"] == parent
                    and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end])
    return out


def hymba_engine() -> ServingEngine:
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    return ServingEngine(cfg, params, EngineConfig(**ENGINE))


def serve(engine: ServingEngine, ticks: int = 5) -> list[list[int]]:
    """Two requests admitted, then ``ticks`` decode ticks; each tick's
    tokens."""
    engine.sampler.load_program()
    for j in range(2):
        req = Request(req_id=j, arrival_s=0.0, prompt_tokens=6, output_tokens=4)
        assert engine.submit(req, torch.arange(3 + j, 9 + j).numpy())
    out = []
    for _ in range(ticks):
        engine.decode_tick()
        out.append([s.last_token for s in engine.slots])
    return out


def test_engine_spans_name_and_nest_as_documented(tmp_path):
    engine = hymba_engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve(engine, ticks=6)
    events, _ = annotations(prof, tmp_path)
    names = {e["name"] for e in events}
    assert all(n.split(".")[0] in ("engine", "data", "trainer") for n in names)
    assert not names & HARNESS
    assert children(events, "engine.submit") == [SUBMIT, SUBMIT]
    ticks = children(events, "engine.decode_tick")
    # requests of 4 output tokens decode 4 ticks; the rest are idle ticks,
    # whose only child is the controller
    assert ticks == [TICK] * 4 + [["engine.controller"]] * 2
    assert {e["parent"] for e in events if e["name"] in ("engine.submit", "engine.decode_tick")} \
        == {None}


def loop_body(tr: Trainer, graph, index: int) -> float:
    """The body of ``Trainer.run`` around a step graph, as the benchmark
    drives it."""
    batch = tr.dataset.device_batch_at(index, tr.torch_device)
    tr.params, tr.opt_state, metrics = graph(tr.params, tr.opt_state, batch)
    loss = float(metrics["loss"])
    tr._telemetry_tick(busy_s=1.3, idle_s=0.1)
    return loss


def small_trainer(**kw) -> Trainer:
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), dtype="float32")
    return Trainer(cfg, TrainerConfig(steps=3, checkpoint_dir=None), global_batch=2,
                   seq_len=8, controller=True, device="cpu", **kw)


class _ZeroedCpuGraph(_CpuGraph):
    """The stand-in graph, its "capture" run on zeroed inputs (a real
    capture computes nothing; the stand-in's reads its buffers)."""

    def __init__(self, fn, inputs, stream):
        for v in inputs.values():
            v.zero_()
        super().__init__(fn, inputs, stream)


def test_trainer_spans_name_and_nest_as_documented(tmp_path, cpu_graphs,  # noqa: F811
                                                   monkeypatch):
    monkeypatch.setattr(trainer_mod, "StepGraph", _ZeroedCpuGraph)
    tr = small_trainer()
    graph = trainer_mod.TrainStepGraph(tr.step_fn, torch.device("cpu"))
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            loop_body(tr, graph, i)
    events, _ = annotations(prof, tmp_path)
    top = [e["name"] for e in events if e["parent"] is None]
    assert top == ["data.device_batch_at", "trainer.step_graph", "trainer.telemetry"] * 5
    assert children(events, "trainer.telemetry") == [["trainer.controller"]] * 5
    assert not {e["name"] for e in events} & HARNESS
    modes = [r.attrs["mode"] for r in obs.spans() if r.name == "trainer.step_graph"]
    assert modes == ["eager", "eager", "capture", "replay", "replay"]


def test_no_profiler_and_obs_off_builds_no_record_function(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not obs.profiling()
    assert obs.span("engine.submit", req_id=1) is spans_mod._NOOP
    serve(hymba_engine(), ticks=2)
    tr = small_trainer()
    for i in range(2):
        loop_body(tr, tr.step_fn, i)
    assert obs.spans() == []


def test_a_recorded_span_lies_inside_its_trace_event(tmp_path):
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with torch.profiler.record_function("outer"):
                with obs.span("engine.test", i=i):
                    time.sleep(0.002)
    events, base = annotations(prof, tmp_path)
    inner = [e for e in events if e["name"] == "engine.test"]
    assert len(inner) == 5 and all(e["parent"] == "outer" for e in inner)
    for rec, e in zip(sorted(obs.spans(), key=lambda r: r.t_start), inner):
        at = obs.trace_us(rec, base)
        assert e["ts"] <= at <= e["ts"] + e["dur"]
        assert at + rec.dur_s * 1e6 <= e["ts"] + e["dur"]


class _Recorder:
    """An optimizer whose ``step`` notes itself in ``log``."""

    def __init__(self, optimizer, log):
        self.optimizer, self.log = optimizer, log

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def step(self, *args):
        self.log.append("optimizer.step")
        return self.optimizer.step(*args)


def _logged_step(monkeypatch, log):
    monkeypatch.setattr(kernels, "mark", lambda name, device: log.append(("mark", name,
                                                                         torch.device(device).type)))
    grad = torch.autograd.grad
    monkeypatch.setattr(torch.autograd, "grad",
                        lambda *a, **kw: (log.append("autograd.grad"), grad(*a, **kw))[1])


WANT = [("mark", "forward", "cpu"), ("mark", "backward", "cpu"), "autograd.grad",
        ("mark", "update", "cpu"), "optimizer.step", ("mark", "done", "cpu")]


def test_the_step_marks_forward_backward_update_done_in_order(monkeypatch):
    tr = small_trainer()
    log = []
    _logged_step(monkeypatch, log)
    step = make_train_step(tr.cfg, _Recorder(tr.optimizer, log))
    step(tr.params, tr.opt_state, tr.dataset.device_batch_at(0, "cpu"))
    assert log == WANT


def test_the_sharded_step_marks_forward_backward_update_done_in_order(monkeypatch, tmp_path):
    from repro_torch.distributed.context import DistContext, make_mesh
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                             world_size=1)
    try:
        dist = DistContext(mesh=make_mesh((1, 1), ("data", "model")))
        tr = small_trainer(dist=dist)
        log = []
        _logged_step(monkeypatch, log)
        step = make_train_step(tr.cfg, _Recorder(tr.optimizer, log), dist)
        step(tr.params, tr.opt_state, tr.dataset.device_batch_at(0, "cpu"))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    assert log == WANT


def test_tokens_and_losses_are_the_same_with_the_profiler_on(tmp_path):
    quiet = serve(hymba_engine())
    with profile(activities=[ProfilerActivity.CPU]):
        traced = serve(hymba_engine())
    assert traced == quiet

    quiet = small_trainer().run().losses
    with profile(activities=[ProfilerActivity.CPU]):
        traced = small_trainer().run().losses
    assert traced == quiet and len(quiet) == 3


def test_the_trainers_controller_reads_the_newest_row_as_the_frame_gave_it(monkeypatch):
    tr = small_trainer()
    seen = []
    monkeypatch.setattr(tr.controller, "step", lambda now, sig: seen.append((now, sig)))
    want = []
    for i in range(50):
        tr._telemetry_tick(busy_s=0.35 + 0.5 * (i % 3), idle_s=0.05 * (i % 4))
        frame = tr.sampler.frame()
        if len(frame):
            row = frame.row(len(frame) - 1)
            want.append((tr.sampler.now, {"sm": float(row["sm"]) / 100.0,
                                          "dram": float(row["dram"]) / 100.0,
                                          "pcie_rx": float(row["pcie_rx"])}))
    assert len(want) > 40 and seen == want
