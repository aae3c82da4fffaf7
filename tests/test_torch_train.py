"""The port's training substrate: optimizers, data, checkpoints, the train
step and the trainer, against the JAX package's and on their own.

The first block mirrors ``tests/test_train_substrate.py`` on the port
(quadratic minimisation, AdamW's clip, Adafactor's factored state, the
dataset's determinism and shifted labels, the trainer's telemetry and
controller, the restart to the exact state). The second holds the port to
the JAX package on the same inputs, in float32:

* optimizers: three steps of ``adamw`` and ``adafactor`` from identical
  parameters, gradients and state (``convert.opt_state_from_jax``), a
  factored and an unfactored leaf: new parameters, every state leaf and
  ``grad_norm`` within 1e-6 relative (of each element, or of the leaf's
  largest where an update cancels);
* data: ``SyntheticDataset.batch_at`` bit-identical for tokens, labels,
  frames and vision;
* one train step (loss, clip, AdamW) from identical state: new parameters
  within 1e-5 relative, as above;
* the loss curve of 5 ``Trainer`` steps, started from the JAX trainer's
  converted parameters on the same dataset seed: each step within 1e-4
  relative;
* checkpoints both ways: the JAX trainer's restores into the port equal to
  the converted trees, and the port's through ``repro.train.checkpoint``.
"""
import dataclasses
import tempfile
import types

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro_torch.configs import get_smoke_config
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.distributed.context import DistContext
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.optimizer import adafactor, adamw, for_arch
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
from repro_torch.train.tree import flatten, leaves

OPT_RTOL = 1e-6
STEP_RTOL = 1e-5
CURVE_RTOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    from repro.train import trainer as jtrainer
    from repro.train.data import SyntheticDataset as JDataset
    return types.SimpleNamespace(jax=jax, jnp=jnp, smoke=jax_smoke_config, opt=jopt,
                                 ckpt=jckpt, trainer=jtrainer, Dataset=JDataset)


def f32_cfgs(jx, arch):
    return (dataclasses.replace(jx.smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def to_np(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def assert_trees_close(got, want_np, rtol, exact=False):
    """Every leaf of the torch tree ``got`` against the numpy tree
    ``want_np``: the same paths and shapes, and values equal (``exact``) or
    within ``rtol`` of each element or of the leaf's largest magnitude
    (a difference of a few f32 roundings where an update cancels)."""
    g, w = flatten(got), flatten(want_np)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.detach().numpy()
        assert a.shape == np.shape(b), path
        if exact:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
        else:
            b = np.asarray(b)
            atol = rtol * float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)


# --------------------------------------------------------------------------- #
# counterparts of tests/test_train_substrate.py
# --------------------------------------------------------------------------- #
def quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.0]), "b": torch.tensor(5.0)}


@pytest.mark.parametrize("make_opt", [lambda: adamw(lr=0.05, weight_decay=0.0),
                                      lambda: adafactor(lr=0.1)])
def test_optimizer_minimizes_quadratic(make_opt):
    opt = make_opt()
    params = quadratic_params()
    state = opt.init(params)

    def loss_fn(p):
        return p["w"].square().sum() + p["b"].square()

    for _ in range(200):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        gw, gb = torch.autograd.grad(loss_fn(params), [params["w"], params["b"]])
        params, state, _ = opt.step(params, {"w": gw, "b": gb}, state)
    assert loss_fn(params).item() < 0.5


def test_adamw_grad_clip():
    opt = adamw(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, _, stats = opt.step(params, {"w": torch.full((4,), 1e6)}, state)
    assert float(stats["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_adafactor_factored_state_is_small():
    opt = adafactor()
    state = opt.init({"w": torch.zeros((512, 512)), "b": torch.zeros(512)})
    w_stats = state["stats"]["w"]
    assert set(w_stats) == {"vr", "vc"}
    assert w_stats["vr"].shape == (512,)
    assert set(state["stats"]["b"]) == {"v"}


def test_for_arch_picks_adafactor_for_the_giant_archs():
    assert "stats" in for_arch("deepseek-v3-671b").init({"w": torch.zeros(2)})
    assert "m" in for_arch("qwen1.5-0.5b").init({"w": torch.zeros(2)})


@given(st.integers(0, 1000), st.integers(0, 1000))
@settings(max_examples=20, deadline=None)
def test_dataset_deterministic_and_step_dependent(step_a, step_b):
    cfg = get_smoke_config("qwen1.5-0.5b")
    ds = SyntheticDataset(cfg, global_batch=2, seq_len=16, seed=5)
    a1 = ds.batch_at(step_a)
    a2 = ds.batch_at(step_a)
    np.testing.assert_array_equal(a1["tokens"], a2["tokens"])
    if step_a != step_b:
        b = ds.batch_at(step_b)
        assert not np.array_equal(a1["tokens"], b["tokens"])


def test_dataset_labels_are_shifted_tokens():
    cfg = get_smoke_config("qwen1.5-0.5b")
    ds = SyntheticDataset(cfg, global_batch=2, seq_len=16, seed=1)
    b = ds.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    dev = ds.device_batch_at(0, "cpu")
    assert dev["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(dev["labels"].numpy(), b["labels"])


def test_trainer_telemetry_and_controller_integration():
    cfg = get_smoke_config("gemma-2b")
    tr = Trainer(cfg, TrainerConfig(steps=4), global_batch=2, seq_len=16,
                 controller=True, device="cpu")
    report = tr.run()
    assert report.steps_run == 4 and len(report.step_s) == 4
    assert np.isfinite(report.final_loss)
    frame = tr.sampler.frame()
    if len(frame):
        assert (frame["power"] >= 0).all()
        assert (frame["power"] <= tr.device.platform.tdp_w + 1).all()


def test_checkpoint_restart_exact_state():
    cfg = get_smoke_config("qwen1.5-0.5b")
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(steps=4, checkpoint_every=2, checkpoint_dir=d)
        t1 = Trainer(cfg, tc, global_batch=2, seq_len=16, device="cpu")
        t1.run()
        assert ckpt.latest_step(d) == 4
        # a fresh trainer resumes exactly at step 4 and holds t1's state
        t2 = Trainer(cfg, tc, global_batch=2, seq_len=16, device="cpu")
        rep2 = t2.run()
        assert rep2.resumed_from == 4 and rep2.steps_run == 0
        for a, b in zip(leaves({"p": t1.params, "o": t1.opt_state}),
                        leaves({"p": t2.params, "o": t2.opt_state})):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b)


def test_checkpoint_resume_continues_the_run():
    """A trainer restarted from the step-2 checkpoint runs steps 3-4 to the
    uninterrupted run's losses and parameters (bit for bit on the CPU)."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d2:
        full = Trainer(cfg, TrainerConfig(steps=4, checkpoint_every=2, checkpoint_dir=d),
                       global_batch=2, seq_len=16, device="cpu")
        losses = full.run().losses
        half = Trainer(cfg, TrainerConfig(steps=2, checkpoint_every=2, checkpoint_dir=d2),
                       global_batch=2, seq_len=16, device="cpu")
        half.run()
        resumed = Trainer(cfg, TrainerConfig(steps=4, checkpoint_every=2,
                                             checkpoint_dir=d2),
                          global_batch=2, seq_len=16, device="cpu")
        rep = resumed.run()
        assert rep.resumed_from == 2 and rep.losses == losses[2:]
        for a, b in zip(leaves(full.params), leaves(resumed.params)):
            assert torch.equal(a.detach(), b.detach())


def test_a_step_half_written_is_ignored(tmp_path):
    params = {"w": torch.arange(4.0)}
    state = adamw().init(params)
    ckpt.save(tmp_path, 3, params, state)
    (tmp_path / ".tmp_step_00000005").mkdir()
    (tmp_path / "step_00000007").mkdir()       # no manifest: never pointed to
    assert ckpt.latest_step(tmp_path) == 3
    p, s, step = ckpt.restore(tmp_path, {"w": torch.zeros(4)}, adamw().init(params))
    assert step == 3 and torch.equal(p["w"], params["w"])
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(tmp_path, {"v": torch.zeros(4)}, state)


def test_dist_with_a_mesh_is_taken(tmp_path):
    """A mesh of one rank (a gloo group of this process): the Trainer and
    make_train_step take it, and on a world of one every collective is an
    identity, so the sharded step's losses are the LOCAL run's bit for bit
    and its parameters are DTensors placed by their specs; its checkpoint
    resumes onto the same placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.context import make_mesh

    cfg = get_smoke_config("granite-moe-3b-a800m")
    local = Trainer(cfg, TrainerConfig(steps=3), global_batch=2, seq_len=16, device="cpu")
    want = local.run().losses
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        dist = DistContext(mesh=make_mesh((1, 1), ("data", "model")))
        tr = Trainer(cfg, TrainerConfig(steps=3), dist=dist, global_batch=2, seq_len=16,
                     device="cpu")
        assert all(isinstance(p, DTensor) for p in leaves(tr.params))
        assert tr.run().losses == want
        step = make_train_step(cfg, adamw(), dist)
        params, _, metrics = step(local.params, adamw().init(local.params),
                                  tr.dataset.device_batch_at(0, "cpu"))
        assert isinstance(params["embed"], DTensor) and np.isfinite(float(metrics["loss"]))
        # a checkpoint of DTensor state, and a resume onto the like trees' placements
        tc = TrainerConfig(steps=2, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"))
        first = Trainer(cfg, tc, dist=dist, global_batch=2, seq_len=16, device="cpu")
        first.run()
        again = Trainer(cfg, tc, dist=dist, global_batch=2, seq_len=16, device="cpu")
        assert again.run().resumed_from == 2
        for a, b in zip(leaves({"p": first.params, "o": first.opt_state}),
                        leaves({"p": again.params, "o": again.opt_state})):
            assert isinstance(b, DTensor) and b.placements == a.placements
            assert torch.equal(a.full_tensor(), b.full_tensor())
    finally:
        torch.distributed.destroy_process_group()


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "1"])


def test_launcher_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "3", "--batch", "2",
                      "--seq", "16", "--controller", "--checkpoint-dir", str(tmp_path),
                      "--checkpoint-every", "3", "--device", "cpu"])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert out["controller_downscales"] is not None and out["resumed_from"] is None
    assert ckpt.latest_step(tmp_path) == 3
    assert '"arch"' in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #
def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((130, 128)).astype(np.float32),   # factored
              "b": rng.standard_normal(64).astype(np.float32),           # unfactored
              "s": [rng.standard_normal((3, 5)).astype(np.float32)]}
    grads = [{k: (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32)
              if k != "s" else [(rng.standard_normal((3, 5)) * 0.3).astype(np.float32)]
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _torch_tree(tree):
    return params_from_jax(tree, get_smoke_config("qwen1.5-0.5b"), "cpu")


@pytest.mark.parametrize("name,kw", [("adamw", dict(lr=1e-2, grad_clip=5.0)),
                                     ("adafactor", dict(lr=1e-2, weight_decay=0.1))])
def test_optimizer_steps_match_jax(jx, name, kw):
    params, grads = _opt_inputs()
    jo, to = getattr(jx.opt, name)(**kw), {"adamw": adamw, "adafactor": adafactor}[name](**kw)
    jparams = jx.jax.tree.map(jx.jnp.asarray, params)
    jstate = jo.init(jparams)
    tparams = _torch_tree(params)
    tstate = opt_state_from_jax(to_np(jx, jstate))
    assert [k for k, _ in flatten(tstate)] == [k for k, _ in flatten(to_np(jx, jstate))]
    for g in grads:
        jparams, jstate, jstats = jo.step(jparams, jx.jax.tree.map(jx.jnp.asarray, g), jstate)
        tparams, tstate, tstats = to.step(tparams, _torch_tree(g), tstate)
        assert_trees_close(tparams, to_np(jx, jparams), OPT_RTOL)
        assert_trees_close(tstate, to_np(jx, jstate), OPT_RTOL)
        np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                                   rtol=OPT_RTOL)
    assert int(tstate["count"]) == 3 and tstate["count"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-tiny", "llama-3.2-vision-90b"])
def test_dataset_bit_identical_to_jax(jx, arch):
    cfg = get_smoke_config(arch)
    ours = SyntheticDataset(cfg, global_batch=3, seq_len=12, seed=9)
    theirs = jx.Dataset(jx.smoke(arch), global_batch=3, seq_len=12, seed=9)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"} | (
            {"frames"} if arch == "whisper-tiny" else
            {"vision"} if arch.startswith("llama-3.2") else set())
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_trainer(jx, jcfg, **kw):
    tc = jx.trainer.TrainerConfig(**{k: v for k, v in kw.items() if k != "steps"},
                                  steps=kw.get("steps", 1))
    return jx.trainer.Trainer(jcfg, tc, global_batch=2, seq_len=16)


def test_train_step_matches_jax(jx):
    """One step of loss, clip and AdamW from identical parameters, state and
    batch. qwen's key bias ``bk`` has a zero gradient in exact arithmetic (it
    shifts a query's scores all alike), so AdamW turns each package's
    rounding noise into a step of about ``lr`` either way: that leaf is held
    to the step's size, 2 * lr, every other to STEP_RTOL."""
    jcfg, tcfg = f32_cfgs(jx, "qwen1.5-0.5b")
    jt = _jax_trainer(jx, jcfg)
    np_params = to_np(jx, jt.params)
    batch = jt.dataset.batch_at(0)
    jparams, jstate, jm = jt.step_fn(jt.params, jt.opt_state,
                                     jx.jax.tree.map(jx.jnp.asarray, batch))
    tparams = params_from_jax(np_params, tcfg, "cpu")
    tstate = opt_state_from_jax(to_np(jx, jt.optimizer.init(jt.params)))
    step = make_train_step(tcfg, adamw())
    tbatch = SyntheticDataset(tcfg, 2, 16).device_batch_at(0, "cpu")
    tparams, tstate, tm = step(tparams, tstate, tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = to_np(jx, jparams)
    bk, want_bk = tparams["layers"].pop("bk"), want["layers"].pop("bk")
    np.testing.assert_array_less(np.abs(bk.detach().numpy() - want_bk), 2 * 3e-4)
    assert_trees_close(tparams, want, STEP_RTOL)


def test_loss_curve_matches_jax_trainer(jx):
    jcfg, tcfg = f32_cfgs(jx, "qwen1.5-0.5b")
    jt = _jax_trainer(jx, jcfg, steps=5)
    np_params = to_np(jx, jt.params)
    tt = Trainer(tcfg, TrainerConfig(steps=5), global_batch=2, seq_len=16, device="cpu")
    tt.params = params_from_jax(np_params, tcfg, "cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    want = jt.run().losses
    got = tt.run().losses
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)


def test_checkpoints_cross_between_packages(jx):
    jcfg, tcfg = f32_cfgs(jx, "qwen1.5-0.5b")
    with tempfile.TemporaryDirectory() as d:
        jt = _jax_trainer(jx, jcfg, steps=2, checkpoint_every=2, checkpoint_dir=d)
        jt.run()
        tt = Trainer(tcfg, TrainerConfig(steps=1), global_batch=2, seq_len=16, device="cpu")
        params, state, step = ckpt.restore(d, tt.params, tt.opt_state)
        assert step == 2
        assert_trees_close(params, to_np(jx, jt.params), 0, exact=True)
        converted = opt_state_from_jax(to_np(jx, jt.opt_state))
        for (path, a), (_, b) in zip(flatten(state), flatten(converted)):
            assert a.dtype == b.dtype and torch.equal(a, b), path
    with tempfile.TemporaryDirectory() as d:
        tt = Trainer(tcfg, TrainerConfig(steps=2, checkpoint_every=2, checkpoint_dir=d),
                     global_batch=2, seq_len=16, device="cpu")
        tt.run()
        jt = _jax_trainer(jx, jcfg)
        jparams, jstate, step = jx.ckpt.restore(d, jt.params, jt.opt_state)
        assert step == 2
        assert_trees_close(tt.params, to_np(jx, jparams), 0, exact=True)
        assert_trees_close(tt.opt_state, to_np(jx, jstate), 0, exact=True)


def test_hymba_checkpoint_keys_are_the_reference_keystr(jx):
    """hymba's layers are a list: its keys index it as keystr does."""
    jcfg, tcfg = f32_cfgs(jx, "hymba-1.5b")
    from repro.models import api as japi
    np_params = to_np(jx, japi.init_params(jx.jax.random.PRNGKey(0), jcfg))
    flat, _ = jx.jax.tree_util.tree_flatten_with_path({"params": np_params})
    want = [jx.jax.tree_util.keystr(p) for p, _ in flat]
    got = [k for k, _ in flatten({"params": params_from_jax(np_params, tcfg, "cpu")})]
    assert got == want and "['params']['layers'][0]['wq']" in got
