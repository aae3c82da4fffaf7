"""Whole runs of the drivers on the CPU at smoke size, past the harness's
look for a chip: a sound run comes out correct; in float32 the reference
and the program agree to rounding; each fault a cell can have, planted in
the timed path underneath, makes ``correct`` false; and the float8 control
reads further from the reference than the program does.

``@pytest.mark.gpu``: the command itself, on the card at the cell's size."""
import os
import subprocess
import sys

import pytest
import torch

from perfbench import run as bench_run
from perfbench.lib import compare
from perfbench.lib.cell import HERE, ROOT, load_module
from perfbench.tests.smoke import smoke_cell

SERVE = load_module(HERE / "kinds" / "serve.py")
TRAIN = load_module(HERE / "kinds" / "train.py")
SEED = 2**33 + 17


def correct(ctx) -> bool:
    return all(v <= lim for v, lim in ctx["checks"].values()) and ctx["failed"] == 0


def serve(cell, fault=None, seconds=1.0):
    return SERVE.run(cell, SEED, seconds, False, device="cpu", fault=fault)


def train(cell, fault=None):
    return TRAIN.run(cell, SEED, 0.5, False, device="cpu", fault=fault)


@pytest.mark.parametrize("config", ["hymba-1.5b", "rwkv6-3b"])
def test_a_sound_serving_run_is_correct(config):
    ctx = serve(smoke_cell("hymba-1.5b.serve.code", config))
    assert correct(ctx), ctx["checks"]
    assert ctx["check"]["rows"] == 8 and ctx["attempted"] > 0


@pytest.mark.parametrize("config", ["hymba-1.5b", "rwkv6-3b"])
def test_serving_in_float32_agrees_with_the_reference(config):
    ctx = serve(smoke_cell("hymba-1.5b.serve.code", config, dtype="float32"))
    assert ctx["checks"]["served_gap"][0] < 1e-4
    assert ctx["checks"]["position"][0] == 0


@pytest.mark.parametrize("config", ["rwkv6-3b", "hymba-1.5b"])
def test_a_sound_training_run_is_correct(config):
    ctx = train(smoke_cell("hymba-1.5b.train.2x2048", config))
    assert correct(ctx), ctx["checks"]
    assert ctx["attempted"] > 0


@pytest.mark.parametrize("config", ["rwkv6-3b", "hymba-1.5b"])
def test_training_in_float32_agrees_with_the_reference(config):
    ctx = train(smoke_cell("hymba-1.5b.train.2x2048", config, dtype="float32"))
    checks = {k: v for k, (v, _) in ctx["checks"].items()}
    assert checks["loss_gap"] < 1e-5 and checks["grad_median_gap"] < 1e-3, checks


def _state_unchanged(engine):
    from repro_torch.models import api
    from repro_torch.serving.engine import clone_cache
    engine.decode = lambda t: api.decode_step(engine.params, clone_cache(engine.cache), t,
                                              engine.cfg)[1]


def _half_batch(engine):
    decode = engine.decode

    def half(t):
        logits = decode(t).clone()
        logits[1::2] = logits[0::2][:logits[1::2].shape[0]]
        return logits
    engine.decode = half


def _token_altered(engine):
    decode = engine.decode

    def altered(t):
        logits = decode(t).clone()
        logits[:, -1, 3] += 1e3
        return logits
    engine.decode = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered])
def test_a_serving_fault_makes_the_run_incorrect(fault):
    assert not correct(serve(smoke_cell("hymba-1.5b.serve.code"), fault))


def _train_state_unchanged(tr):
    from repro_torch.models import api
    tr.step_fn = lambda p, o, b: (p, o, {"loss": api.loss_fn(p, b, tr.cfg)[0].detach()})


def _train_half_batch(tr):
    step = tr.step_fn
    tr.step_fn = lambda p, o, b: step(p, o, {k: v[:v.shape[0] // 2] for k, v in b.items()})


@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch])
def test_a_training_fault_makes_the_run_incorrect(fault):
    assert not correct(train(smoke_cell("hymba-1.5b.train.2x2048"), fault))


def test_the_serving_control_reads_above_the_program():
    cell = smoke_cell("hymba-1.5b.serve.code")
    check = serve(cell)["check"]
    low = SERVE.reference_logits(cell, check["sample"], 32, 64, SEED, "cpu", mm=compare.fp8_mm)
    control = max(compare.control_gaps(check["logits"], low))
    assert control > 3 * check["gap"], (control, check["gap"])


def test_the_training_control_reads_above_the_program():
    control = load_module(HERE / "control.py")
    cell = smoke_cell("hymba-1.5b.train.2x2048")
    prog = {k: v for k, (v, _) in train(cell)["checks"].items()}
    low = control.train_readings(cell, TRAIN, SEED, "cpu")
    assert any(low["fp8"][k] > 3 * prog[k] for k in prog), (low, prog)
    assert any(low["half_batch"][k] > 3 * prog[k] for k in prog), (low, prog)


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_run.require_chips(1)
    assert e.value.code == 2
    assert "needs 1 CUDA device" in capsys.readouterr().err


def test_a_jax_module_is_found_by_its_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in bench_run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"repro", "jax"} <= set(bench_run.forbidden_loaded())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["hymba-1.5b.serve.code", "hymba-1.5b.train.2x2048"])
def test_the_command_runs_a_cell_correctly_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload,
                          "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
