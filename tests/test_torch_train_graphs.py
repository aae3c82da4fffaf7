"""The trainer's compiled step: one CUDA graph of forward, backward, clip and
update per trainer on the card, as the reference jit-compiles
``make_train_step``.

Here on the CPU: both optimizers ``for_arch`` picks update every leaf of the
parameters and of their state in place, ``count`` included, so a graph
captured on the trees reads and writes the same tensors at every replay;
and a CPU ``Trainer`` still steps eagerly and still equals the reference's
trainer (AdamW is held so by ``tests/test_torch_train.py``; Adafactor, whose
``beta2`` reads ``count``, here).

On the card (``gpu``, skipped elsewhere), for each family with a loss at
smoke size: 6 steps of the graphed trainer across its warm-up equal an
eager run of ``make_train_step``'s function from the same seed bit for bit,
losses and final trees; the capture adds no launch and each replay adds one
eager step's launches, among them one dQ and one dK/dV launch of K2's
backward a hymba layer. The file imports no JAX at module level, so it also
collects on a machine without it.
"""
import dataclasses
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import train as launch_train
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.optimizer import for_arch
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
from repro_torch.train.tree import flatten, leaves, unflatten

#: chip_smoke.py, for the rule that holds a graphed run to its eager run
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

#: a smoke config of each family with a loss
FAMILY_ARCHS = ["qwen1.5-0.5b", "hymba-1.5b", "rwkv6-3b", "whisper-tiny",
                "granite-moe-3b-a800m", "llama-3.2-vision-90b", "deepseek-v3-671b"]
STEPS = 6
CURVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's smoke configs and trainer, imported here: the card,
    where the ``gpu`` tests run, has no JAX."""
    jax = pytest.importorskip("jax")

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.train import trainer as jtrainer
    return types.SimpleNamespace(jax=jax, smoke=jax_smoke_config, trainer=jtrainer)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state_leaves(params, opt_state):
    return flatten({"params": params, "opt_state": opt_state})


@pytest.mark.parametrize("arch,optimizer,wide", [("qwen1.5-0.5b", "adamw", {}),
                                                 ("llama-3.2-vision-90b", "adafactor",
                                                  dict(d_model=128, d_ff=256))])
def test_the_step_updates_every_leaf_in_place(arch, optimizer, wide):
    """Two steps of ``make_train_step``'s function: the trees that come back
    are the trees passed in, every leaf the same tensor at the same address
    (``count`` too), holding the state a step on copies of the trees
    computes, ``count`` the number of steps. The VLM is widened so that
    Adafactor factors some leaves (both last axes at least 128)."""
    cfg = dataclasses.replace(get_smoke_config(arch), **wide)
    opt = for_arch(cfg.name)
    assert opt.init.__qualname__.startswith(optimizer)
    tr = Trainer(cfg, TrainerConfig(steps=2), global_batch=2, seq_len=16, device="cpu")
    params, state = tr.params, tr.opt_state
    before = [(path, leaf, leaf.data_ptr()) for path, leaf in _state_leaves(params, state)]
    cp = unflatten(params, [t.detach().clone() for t in leaves(params)])
    cs = unflatten(state, [t.clone() for t in leaves(state)])
    step = make_train_step(cfg, opt)
    for i in range(2):
        batch = tr.dataset.device_batch_at(i, "cpu")
        new_params, new_state, _ = step(params, state, batch)
        assert new_params is params and new_state is state
        cp, cs, _ = step(cp, cs, batch)
    after = _state_leaves(params, state)
    assert [p for p, _ in after] == [p for p, _, _ in before]
    for (path, leaf, ptr), (_, now) in zip(before, after):
        assert now is leaf and now.data_ptr() == ptr, path
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 2
    if optimizer == "adafactor":        # a factored leaf's row and column statistics
        assert any("['vr']" in path for path, _, _ in before)
    for (path, got), (_, want) in zip(after, _state_leaves(cp, cs)):
        assert torch.equal(got.detach(), want.detach()), path


def test_a_cpu_trainer_steps_eagerly_and_equals_the_reference(jx):
    """Adafactor (the VLM's ``for_arch`` pick), whose ``beta2`` reads the
    advancing ``count``: 4 steps of the CPU ``Trainer`` from the JAX
    trainer's converted parameters, each loss within 1e-4 of the
    reference's, no step replayed and no graph made."""
    from repro_torch.convert import params_from_jax

    arch = "llama-3.2-vision-90b"
    jcfg = dataclasses.replace(jx.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jt = jx.trainer.Trainer(jcfg, jx.trainer.TrainerConfig(steps=4), global_batch=2,
                            seq_len=16)
    np_params = jx.jax.tree.map(np.asarray, jt.params)
    tt = Trainer(tcfg, TrainerConfig(steps=4), global_batch=2, seq_len=16, device="cpu")
    tt.params = params_from_jax(np_params, tcfg, "cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    want = jt.run().losses
    report = tt.run()
    assert tt.graph is None and report.replayed_steps == 0
    assert launch_train.summarize(tt, report)["replayed_steps"] == 0
    assert int(tt.opt_state["count"]) == 4
    np.testing.assert_allclose(report.losses, want, rtol=CURVE_RTOL)


def test_a_capture_builds_its_own_masks(monkeypatch):
    """The attention backward's masks come from a small cache, which drops
    them when other shapes come through, while a CUDA graph reads what it
    captured at its addresses at every replay: under capture the backward
    builds its masks anew, outside the cache, into the same gradients."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 4, 32), generator=g).requires_grad_(True)
               for _ in range(3))

    def backward():
        return torch.autograd.grad(ops.flash_attention(q, k, v, causal=True).sum(), (q, k, v))

    ops._backward_masks.cache_clear()
    cached = backward()
    calls = ops._backward_masks.cache_info()
    assert calls.misses == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    captured = backward()
    assert ops._backward_masks.cache_info() == calls
    for a, b in zip(captured, cached):
        assert torch.equal(a, b)


def test_chip_smoke_holds_a_graphed_run_to_its_eager_run():
    """``chip_smoke.hold_to_eager``: equal losses and checksums pass with no
    second eager run; otherwise a second eager run must differ from the
    first (else the graph's difference is a fault) by at least as much as
    the graphed run does."""
    def run(losses, checksum=(1.0,)):
        return {"losses": list(losses), "checksum": list(checksum)}

    reruns = []

    def rerun(losses):
        def again():
            reruns.append(losses)
            return list(losses)
        return again

    eager = run([2.0, 1.5])
    held = chip_smoke.hold_to_eager("m", run([2.0, 1.5]), eager, rerun([9.0, 9.0]))
    assert held["bitwise"] and not reruns
    held = chip_smoke.hold_to_eager("m", run([2.0, 1.5 + 1e-6]), eager, rerun([2.0, 1.5 - 3e-6]))
    assert not held["bitwise"] and held["graphed_vs_eager"] < held["eager_vs_eager"]
    assert "spread" in chip_smoke.held_line(held)
    with pytest.raises(AssertionError, match="graphed losses"):      # eager runs agree
        chip_smoke.hold_to_eager("m", run([2.0, 1.5 + 1e-6]), eager, rerun([2.0, 1.5]))
    with pytest.raises(AssertionError, match="graphed losses"):      # outside the spread
        chip_smoke.hold_to_eager("m", run([2.0, 1.6]), eager, rerun([2.0, 1.5 - 3e-6]))
    with pytest.raises(AssertionError, match="checksums equal: False"):  # the last update
        chip_smoke.hold_to_eager("m", run([2.0, 1.5], (2.0,)), eager, rerun([2.0, 1.5]))
    assert chip_smoke.median_ms([0.3, 0.1, 0.2]) == 200.0
    assert chip_smoke.median_ms([0.4, 0.1, 0.2, 0.3]) == 250.0


def _card_cfg(arch):
    cfg = get_smoke_config(arch)
    if cfg.resolved_head_dim not in HEAD_DIMS:       # hymba's, the VLM's: 16 wide
        cfg = dataclasses.replace(cfg, head_dim=32)
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_graphed_trainer_equals_the_eager_step_on_card(cuda, arch):
    cfg = _card_cfg(arch)
    kw = dict(global_batch=2, seq_len=16, device="cuda")
    graphed = Trainer(cfg, TrainerConfig(steps=STEPS), **kw)
    kernels.reset_launch_counts()
    ops._backward_masks.cache_clear()
    report = graphed.run()
    torch.cuda.synchronize()
    replayed = kernels.launch_counts()
    graphed_masks = ops._backward_masks.cache_info()
    graph = graphed.graph
    assert graph is not None and graph.eager_steps == trainer_mod.WARMUP
    assert graph.replays == report.replayed_steps == STEPS - trainer_mod.WARMUP
    assert launch_train.summarize(graphed, report)["replayed_steps"] == graph.replays

    eager = Trainer(cfg, TrainerConfig(steps=STEPS), **kw)
    kernels.reset_launch_counts()
    ops._backward_masks.cache_clear()
    losses = []
    for step in range(STEPS):
        batch = eager.dataset.device_batch_at(step, cuda)
        eager.params, eager.opt_state, metrics = eager.step_fn(
            eager.params, eager.opt_state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    eager_masks = ops._backward_masks.cache_info()

    assert report.losses == losses
    for (path, got), (_, want) in zip(_state_leaves(graphed.params, graphed.opt_state),
                                      _state_leaves(eager.params, eager.opt_state)):
        assert got.dtype == want.dtype and torch.equal(got.detach(), want.detach()), path
    # the capture launched nothing: the run's counts are the eager run's,
    # and one replay's launches are one eager step's
    assert replayed == launched
    assert {k: n for k, n in graph.launches.items() if k != kernels.WGMMA} == \
        {k: n // STEPS for k, n in launched.items()}
    # K2′: one dQ and one dK/dV launch a K2 call's backward (bf16 at these
    # head dims), one a layer in hymba's step
    assert graph.launches["flash_attention_bwd_dq"] == graph.launches["flash_attention_bwd_dkv"]
    if arch == "hymba-1.5b":
        assert graph.launches["flash_attention_bwd_dkv"] == cfg.n_layers
    # only the warm-up read the masks' cache: the capture built its own
    assert (graphed_masks.hits + graphed_masks.misses) * STEPS == \
        (eager_masks.hits + eager_masks.misses) * trainer_mod.WARMUP
    # the graph holds to its buffers' shapes and to the trees it was captured on
    batch = graphed.dataset.device_batch_at(0, cuda)
    with pytest.raises(ValueError, match="captured for"):
        graph(graphed.params, graphed.opt_state, {k: v[:1] for k, v in batch.items()})
    with pytest.raises(ValueError, match="captured on"):
        graph(eager.params, eager.opt_state, batch)
