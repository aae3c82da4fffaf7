"""The sharded train step's compiled form: one CUDA graph per rank on the
card, its DTensor redistributions and NCCL collectives inside it, as the
reference jit-compiles the step with shardings and donated trees.

The ``gpu`` tests (skipped elsewhere) run on a 1 x 1 ``(data, model)`` mesh
over an NCCL group of this process alone
(``chip_smoke.world_of_one``), started once for the module and destroyed
after it. For each family with a loss at smoke size: 6 steps of the graphed
sharded trainer across its warm-up equal 6 eager sharded steps from the same
seed bit for bit, losses and every leaf, and every leaf's local tensor stays
where it was; the capture adds no launch and each replay adds one eager
step's launches; the graph refuses a batch of another shape and trees other
than its own. ``compressed_psum`` captured in a CUDA graph replays equal to
the eager call. A capture (in ``torch.cuda.graph``'s default "global" mode,
as the trainer's) survives the process group's watchdog thread querying a
collective that is still running while it is open: the warm-up steps leave
such queries behind. What the CPU can check of the same step (the trees kept in
place on gloo meshes of 2 and 4 ranks, nothing replayed there) is in
tests/test_torch_distributed.py. Here on the CPU: ``TrainStepGraph`` over a
stand-in graph replays a step that returns new trees of the leaves it was
given, as the sharded step does, and refuses other leaves and a step that
replaces a leaf. The file imports no JAX.
"""
import contextlib

import pytest
import torch

from repro_torch import kernels
from repro_torch.distributed.context import DistContext, make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.train.tree import flatten, leaves
from test_torch_train_graphs import FAMILY_ARCHS, STEPS, _card_cfg, chip_smoke


@pytest.fixture(scope="module")
def world():
    """A 1 x 1 (data, model) mesh over an NCCL group of this process alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    with chip_smoke.world_of_one(dev):
        yield DistContext(mesh=make_mesh((1, 1), ("data", "model"))), dev


class _CpuGraph:
    """``StepGraph``'s interface on the CPU: the "capture" runs the step once
    on the static inputs, a call copies the batch in, runs it again and
    returns what the capture returned, as a replay does."""

    def __init__(self, fn, inputs, stream):
        self.fn, self.inputs = fn, inputs
        self.out = fn(inputs)

    def __call__(self, inputs):
        for k, buf in self.inputs.items():
            buf.copy_(inputs[k])
        self.fn(self.inputs)
        return self.out


class _CpuStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


@pytest.fixture
def cpu_graphs(monkeypatch):
    """``TrainStepGraph`` on the CPU: no streams, ``_CpuGraph`` for the graph."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _CpuStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _CpuStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(trainer_mod, "StepGraph", _CpuGraph)


def _sharded_like(params, state, batch):
    """A step as the sharded step returns its trees: new dicts (``place``
    builds them) around the leaves it was given, updated in place."""
    params["w"].add_(batch["x"].sum())
    state["count"].add_(1)
    return dict(params), dict(state), {"loss": params["w"].sum()}


def test_a_graph_replays_new_trees_of_its_own_leaves(cpu_graphs):
    graph = trainer_mod.TrainStepGraph(_sharded_like, torch.device("cpu"))
    params, state = {"w": torch.zeros(3)}, {"count": torch.zeros((), dtype=torch.int32)}
    first = (params, state)
    batch = {"x": torch.ones(2)}
    for _ in range(trainer_mod.WARMUP + 3):
        params, state, _ = graph(params, state, batch)
    assert graph.eager_steps == trainer_mod.WARMUP and graph.replays == 3
    assert params["w"] is first[0]["w"] and state["count"] is first[1]["count"]
    assert graph(*first, batch)[0] is graph.graph.out[0]     # the first trees: the same leaves
    with pytest.raises(ValueError, match="captured on"):
        graph({"w": torch.zeros(3)}, state, batch)
    with pytest.raises(ValueError, match="captured on"):
        graph(params, {"count": state["count"], "extra": torch.zeros(1)}, batch)


def test_a_graph_refuses_a_step_that_replaces_a_leaf(cpu_graphs):
    def out_of_place(params, state, batch):
        return {"w": params["w"] + batch["x"].sum()}, state, {"loss": params["w"].sum()}

    graph = trainer_mod.TrainStepGraph(out_of_place, torch.device("cpu"))
    params, state = {"w": torch.zeros(3)}, {"count": torch.zeros((), dtype=torch.int32)}
    batch = {"x": torch.ones(2)}
    for _ in range(trainer_mod.WARMUP):
        params, state, _ = graph(params, state, batch)
    with pytest.raises(RuntimeError, match="did not return the leaves"):
        graph(params, state, batch)


def _local_tensors(trainer):
    return [t.to_local() for t in leaves({"p": trainer.params, "o": trainer.opt_state})]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_graphed_sharded_trainer_equals_the_eager_sharded_step_on_card(world, arch):
    dist, dev = world
    cfg = _card_cfg(arch)
    kw = dict(dist=dist, global_batch=2, seq_len=16, device="cuda")
    graphed = Trainer(cfg, TrainerConfig(steps=STEPS), **kw)
    before = _local_tensors(graphed)         # views: their storage is not reused
    kernels.reset_launch_counts()
    report = graphed.run()
    torch.cuda.synchronize()
    replayed = kernels.launch_counts()
    graph = graphed.graph
    assert graph is not None and graph.eager_steps == trainer_mod.WARMUP
    assert graph.replays == report.replayed_steps == STEPS - trainer_mod.WARMUP
    assert launch_train.summarize(graphed, report)["replayed_steps"] == graph.replays
    assert [t.data_ptr() for t in before] == [t.data_ptr() for t in _local_tensors(graphed)]

    eager = Trainer(cfg, TrainerConfig(steps=STEPS), **kw)
    kernels.reset_launch_counts()
    losses = []
    for step in range(STEPS):
        batch = eager.dataset.device_batch_at(step, dev)
        eager.params, eager.opt_state, metrics = eager.step_fn(
            eager.params, eager.opt_state, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    launched = kernels.launch_counts()

    assert report.losses == losses
    for (path, got), (_, want) in zip(flatten({"p": graphed.params, "o": graphed.opt_state}),
                                      flatten({"p": eager.params, "o": eager.opt_state})):
        assert got.placements == want.placements, path
        assert got.dtype == want.dtype and torch.equal(got.to_local().detach(),
                                                       want.to_local().detach()), path
    # the capture launched nothing: the run's counts are the eager run's,
    # and one replay's launches are one eager step's
    assert replayed == launched
    assert {k: n for k, n in graph.launches.items() if k != kernels.WGMMA} == \
        {k: n // STEPS for k, n in launched.items()}
    # the graph holds to its buffers' shapes and to the trees it was captured on
    batch = graphed.dataset.device_batch_at(0, dev)
    with pytest.raises(ValueError, match="captured for"):
        graph(graphed.params, graphed.opt_state, {k: v[:1] for k, v in batch.items()})
    with pytest.raises(ValueError, match="captured on"):
        graph(eager.params, eager.opt_state, batch)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 1000), (256,), (5, 77)])
def test_captured_compressed_psum_replays_the_eager_call_on_card(world, shape):
    """The smallest NCCL collective in a graph: ``compressed_psum`` over the
    world of one, captured after an eager call and replayed twice, gives the
    eager call's sum and error buffer bit for bit, which are
    ``dequantize(quantize(g + e))`` and the rest."""
    from repro_torch.distributed.compression import dequantize_int8, quantize_int8

    dist, dev = world
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn(shape, generator=gen, device=dev) * 1e-3
    e = torch.randn(shape, generator=gen, device=dev) * 1e-6
    cap = chip_smoke.captured_psum(dist.mesh.get_group("data"), g, e)
    exact = dequantize_int8(*quantize_int8(g + e))
    summed, err = cap["eager"]
    assert torch.equal(summed, exact) and torch.equal(err, g + e - exact)
    for replay in cap["replays"]:
        for got, want in zip(replay, cap["eager"]):
            assert torch.equal(got, want)


@pytest.mark.gpu
def test_a_capture_survives_the_watchdog_querying_a_running_collective(world):
    """An eager all-reduce held back behind a ~0.5-s sleep on the card is in
    the watchdog's list for the whole of a 1-s capture on another stream,
    so the watchdog queries its event while the capture is open: the
    capture ends, replays, and the collective completes."""
    import time

    import torch.distributed as tdist

    dist, dev = world
    x = torch.ones(1 << 16, device=dev)
    y = torch.zeros(16, device=dev)
    stream, graph = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 9)
    work = tdist.all_reduce(x, group=dist.mesh.get_group("data"), async_op=True)
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(100):
            y.add_(1)
            time.sleep(0.01)
        graph.capture_end()
    work.wait()
    graph.replay()
    torch.cuda.synchronize()
    assert float(y[0]) == 100.0 and float(x[0]) == 1.0
