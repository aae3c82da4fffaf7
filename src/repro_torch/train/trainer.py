"""Training loop with first-class execution-idle telemetry + fault tolerance,
as the JAX package's ``train/trainer.py``.

The trainer is where the paper's technique integrates with training:
every step reports busy/idle phases to a :class:`RuntimeSampler`; an optional
:class:`ExecutionIdleController` (Algorithm 1) watches those samples and
downscales the (simulated) device clocks during sustained input-pipeline or
checkpoint stalls — a training-side guard against PCIe/NIC-preceded
execution-idle (§4.5).

A step is the loss forward (K1, K2, K5 and K6 inside their autograd
Functions on the card), the backward, the global-norm clip and the optimizer
update. On the card ``run`` replays it from one CUDA graph
(:class:`TrainStepGraph`), as the reference jit-compiles it: two eager
steps, then a capture, then a replay a step. Under a ``dist`` with a mesh
each rank does the same with the sharded step, its DTensor redistributions
and NCCL collectives inside its graph, as the reference jit-compiles it with
shardings and donated trees. On the CPU (gloo included) every step runs
eagerly. ``float(loss)`` is the step's synchronisation point, as in the
reference, so the step time is the host's clock around all of it.

Under a ``dist`` with a mesh (one process a rank, every rank running the
same steps), parameters, optimizer state and the batch are DTensors placed
by ``sharding.param_specs``, the optimizer's ``state_specs`` and
``sharding.batch_specs``, as the reference's jit shardings place them. The
step gathers each leaf whole before the forward, as GSPMD's FSDP gathers
it a layer at a time; the expert stacks are gathered over the batch axes
only and stay sharded over ``model`` for the expert-parallel dispatch. Each
rank runs its own batch rows; outside the dispatch the ``model`` axis
computes the same thing on every rank. The gradients, averaged over the
batch axes, are placed back as the parameters are, clipped by the global
norm of the whole tree, and each rank updates its own shard, in place:
every DTensor leaf keeps its local tensor, ``count`` included, so a graph
captured on the trees reads and writes the same tensors at every replay.

Fault tolerance:
* step-atomic checkpoints every ``checkpoint_every`` steps (train.checkpoint),
* automatic resume from LATEST,
* straggler detection: a per-step deadline (k x running median); steps
  breaching it are counted (the skip is recorded only).

``TrainerConfig.grad_compression`` is kept and, as in the reference, never
read (``distributed.compression`` has the reduction).

Tracing: both step functions launch :func:`repro_torch.kernels.mark`'s
``forward``, ``backward``, ``update`` and ``done`` marks on the card, which a
capture records, so a profiled replay shows where each part of the step
begins. On the host, :class:`TrainStepGraph`'s call opens the
:func:`repro_torch.obs.span` ``trainer.step_graph`` (attribute ``mode``:
``eager``, ``capture`` or ``replay``), ``_telemetry_tick`` opens
``trainer.telemetry`` over ``trainer.controller``, and the dataset's
``device_batch_at`` opens ``data.device_batch_at``; no span is opened inside
a captured function.
"""
from __future__ import annotations

import dataclasses
import operator
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import kernels, obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ExecutionIdleController
from repro_torch.core.power_model import SimulatedDevice, get_platform
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import LOCAL, DistContext
from repro_torch.kernels.graphs import StepGraph
from repro_torch.models import api
from repro_torch.telemetry.sampler import RuntimeSampler
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.tree import leaves, map_up_to, map_with_path, unflatten


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    straggler_deadline_factor: float = 3.0
    grad_compression: str | None = None     # None | "int8"
    lr: float = 3e-4
    telemetry: bool = True
    #: utilization the power model sees during a step (roofline-informed)
    step_compute_util: float = 0.85
    step_hbm_util: float = 0.55


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: list[float]
    straggler_events: int
    resumed_from: int | None
    telemetry_rows: int
    wall_s: float
    #: each step's time on the host clock (s), the straggler rule's input
    step_s: list[float] = dataclasses.field(default_factory=list)
    #: steps replayed from the CUDA graph (the rest ran eagerly)
    replayed_steps: int = 0


def train_shardings(cfg: ModelConfig, optimizer, dist: DistContext) -> dict:
    """The step's shardings under a mesh: ``params``, ``opt_state`` and
    ``batch`` trees of ``NamedSharding``, and ``experts``, the parameter
    tree's expert stacks (True) and the rest (False)."""
    abstract = api.abstract_params(cfg, ep_size=dist.ep_size)
    p_specs = shd.param_specs(abstract, dist)
    return {
        "params": shd.named(dist, p_specs),
        "opt_state": shd.named(dist, optimizer.state_specs(p_specs, abstract)),
        "batch": shd.named(dist, shd.batch_specs(cfg, dist)),
        "experts": map_with_path(lambda path, _: shd.path_leaf_name(path) in shd.EXPERT_LEAVES,
                                 abstract),
    }


def place(tree, shardings):
    """Each leaf of ``tree`` as a DTensor placed by ``shardings``
    (``NamedSharding.place``)."""
    return map_up_to(lambda t, sh: sh.place(t), tree, shardings)


def _batch_reduce(dist: DistContext, placements) -> list:
    """``placements`` with ``Partial("avg")`` on the batch axes."""
    return [Partial("avg") if name in dist.batch_axes else pl
            for name, pl in zip(dist.mesh.mesh_dim_names, placements)]


def _gather(p: DTensor, dist: DistContext, expert: bool) -> torch.Tensor:
    """A parameter whole (an expert stack: whole over the batch axes, this
    rank's experts over ``model``), as a new leaf tensor."""
    if expert:
        keep = [Replicate() if name in dist.batch_axes else pl
                for name, pl in zip(dist.mesh.mesh_dim_names, p.placements)]
        return p.redistribute(dist.mesh, keep).to_local().detach()
    return p.full_tensor().detach()


def _reduce(g: torch.Tensor, p: DTensor, dist: DistContext, expert: bool) -> DTensor:
    """A gradient of :func:`_gather`'s leaf, averaged over the batch axes and
    placed as its parameter."""
    local = [pl if expert else Replicate() for pl in p.placements]
    return DTensor.from_local(g, dist.mesh, _batch_reduce(dist, local), run_check=False
                              ).redistribute(dist.mesh, p.placements)


def _batch_mean(x: torch.Tensor, dist: DistContext) -> torch.Tensor:
    """A per-rank scalar averaged over the batch axes."""
    replicated = [Replicate()] * dist.mesh.ndim
    return DTensor.from_local(x.detach().reshape(()), dist.mesh,
                              _batch_reduce(dist, replicated)).full_tensor()


def make_train_step(cfg: ModelConfig, optimizer, dist: DistContext = LOCAL):
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).
    Under a mesh it takes the trees and the global batch as they are or
    placed (:func:`place`); the metrics are the global batch's."""
    if dist.enabled:
        return _sharded_step(cfg, optimizer, dist)

    def step_fn(params, opt_state, batch):
        dev = batch["tokens"].device
        kernels.mark("forward", dev)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = api.loss_fn(params, batch, cfg)
        kernels.mark("backward", dev)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        kernels.mark("update", dev)
        params, opt_state, stats = optimizer.step(params, unflatten(params, grads),
                                                  opt_state)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        kernels.mark("done", dev)
        return params, opt_state, dict(metrics, **stats)

    return step_fn


def _sharded_step(cfg: ModelConfig, optimizer, dist: DistContext):
    sh = train_shardings(cfg, optimizer, dist)

    def step_fn(params, opt_state, batch):
        if batch["tokens"].shape[0] % dist.dp_size:
            raise ValueError(f"a global batch of {batch['tokens'].shape[0]} rows does not "
                             f"divide over the {dist.dp_size} ranks of the batch axes")
        dev = batch["tokens"].device
        kernels.mark("forward", dev)
        params = place(params, sh["params"])
        opt_state = place(opt_state, sh["opt_state"])
        rows = {k: sh["batch"][k].place(v).to_local() for k, v in batch.items()}
        work = map_up_to(lambda p, expert: _gather(p, dist, expert), params, sh["experts"])
        flat = leaves(work)
        for t in flat:
            t.requires_grad_(True)
        loss, metrics = api.loss_fn(work, rows, cfg, dist=dist)
        kernels.mark("backward", dev)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        grads = map_up_to(lambda g, p, expert: _reduce(g, p, dist, expert),
                          unflatten(work, grads), params, sh["experts"])
        kernels.mark("update", dev)
        params, opt_state, stats = optimizer.step(params, grads, opt_state)
        metrics = {k: _batch_mean(torch.as_tensor(v), dist) for k, v in metrics.items()}
        stats = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in stats.items()}
        kernels.mark("done", dev)
        return params, opt_state, dict(metrics, **stats)

    return step_fn


#: eager steps on the capture stream before the step is captured, as the
#: serving engine's ``WARMUP_RUNS``
WARMUP = 2


class TrainStepGraph:
    """A step function of :func:`make_train_step` on one pair of trees,
    replayed from a :class:`~repro_torch.kernels.graphs.StepGraph` after
    ``WARMUP`` eager steps.

    The first ``WARMUP`` calls are real steps, run eagerly on the capture
    stream so that what a first step sets up (cuBLAS's handle and workspace
    for that stream, the kernel library, the launch plans, the kernels'
    shared-memory attributes) exists before capture; they run on the trees
    themselves, not on a copy, which the largest models have no room for.
    The next call frees the cached blocks, captures the step with the batch
    as the graph's inputs (a capture launches nothing, so it advances no
    state) and replays it, as does every call after it. The optimizer
    updates every leaf in place, ``count`` included, so the trees the graph
    was captured on hold the current step after every replay: the caller
    keeps passing them (or the trees the step returned, which the sharded
    step builds anew around the same leaves), and a call with other leaves
    raises, as does a capture of a step that does not return the leaves it
    was given. There is no eager fallback."""

    def __init__(self, step_fn, device: torch.device):
        self.step_fn = step_fn
        self.stream = torch.cuda.Stream(device)
        self.graph: StepGraph | None = None
        self._leaves: list = []
        self.eager_steps = 0
        self.replays = 0

    @property
    def launches(self) -> dict[str, int]:
        """What one replay launches of each kernel."""
        return self.graph.launches

    def __call__(self, params, opt_state, batch: dict):
        mode = ("replay" if self.graph is not None
                else "eager" if self.eager_steps < WARMUP else "capture")
        with obs.span("trainer.step_graph", mode=mode):
            return self._step(mode, params, opt_state, batch)

    def _step(self, mode: str, params, opt_state, batch: dict):
        if mode == "eager":
            current = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = self.step_fn(params, opt_state, batch)
            current.wait_stream(self.stream)
            self.eager_steps += 1
            return out
        if mode == "capture":
            torch.cuda.synchronize(self.stream.device)
            torch.cuda.empty_cache()       # the warm-up's blocks, before the graph's pool
            inputs = {k: torch.empty_like(v) for k, v in batch.items()}
            self.graph = StepGraph(lambda b: self.step_fn(params, opt_state, b), inputs,
                                   self.stream)
            self._leaves = leaves(self.graph.out[:2])
            if not self._captured_on(params, opt_state):
                raise RuntimeError("the step did not return the leaves it was given: a "
                                   "replay would read them and write others")
        if not self._captured_on(params, opt_state):
            raise ValueError("the trees are not the ones the step was captured on")
        out = self.graph(batch)
        self.replays += 1
        return out

    def _captured_on(self, params, opt_state) -> bool:
        """Whether the trees hold the leaves the captured step returned."""
        given = leaves((params, opt_state))
        return len(given) == len(self._leaves) and all(map(operator.is_, given, self._leaves))


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 dist: DistContext = LOCAL, global_batch: int = 8,
                 seq_len: int = 128, platform: str = "h100",
                 controller: bool = False, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.tc = tc
        self.dist = dist
        self.torch_device = resolve_device(device)
        self.optimizer = opt_mod.for_arch(cfg.name, lr=tc.lr)
        self.dataset = SyntheticDataset(cfg, global_batch, seq_len, seed=seed)
        self.step_fn = make_train_step(cfg, self.optimizer, dist)
        self.device = SimulatedDevice(get_platform(platform))
        self.sampler = RuntimeSampler(self.device, job_id=1)
        self.controller = (ExecutionIdleController(self.device)
                           if controller else None)
        #: the step's CUDA graph of the last ``run`` on the card (None on the
        #: CPU, where every step runs eagerly)
        self.graph: TrainStepGraph | None = None
        gen = torch.Generator(device=self.torch_device).manual_seed(seed)
        self.params = api.init_params(gen, cfg, ep_size=dist.ep_size)
        self.opt_state = self.optimizer.init(self.params)
        if dist.enabled:
            sh = train_shardings(cfg, self.optimizer, dist)
            self.params = place(self.params, sh["params"])
            self.opt_state = place(self.opt_state, sh["opt_state"])

    # ------------------------------------------------------------------ #
    def _telemetry_tick(self, busy_s: float, idle_s: float) -> None:
        if not self.tc.telemetry:
            return
        with obs.span("trainer.telemetry"):
            s = self.sampler
            if busy_s > 0:
                s.busy(busy_s, compute_util=self.tc.step_compute_util,
                       hbm_util=self.tc.step_hbm_util)
            if idle_s > 0:
                s.idle(idle_s, pcie_gbs=0.2, cpu_util=0.4)  # input-pipeline wait
            if self.controller is not None:
                with obs.span("trainer.controller"):
                    # the newest row alone (O(1)), as the serving engine reads it
                    row = s.last_row()
                    if row is not None:
                        self.controller.step(s.now, {
                            "sm": float(row["sm"]) / 100.0,
                            "dram": float(row["dram"]) / 100.0,
                            "pcie_rx": float(row["pcie_rx"]),
                        })

    def run(self) -> TrainReport:
        tc = self.tc
        resumed_from = None
        start_step = 0
        if tc.checkpoint_dir and ckpt.latest_step(tc.checkpoint_dir) is not None:
            self.params, self.opt_state, start_step = ckpt.restore(
                tc.checkpoint_dir, self.params, self.opt_state)
            resumed_from = start_step
        # made after the restore, which rebinds the trees the graph is captured on
        self.graph = (TrainStepGraph(self.step_fn, self.torch_device)
                      if self.torch_device.type == "cuda" else None)
        step_fn = self.step_fn if self.graph is None else self.graph

        self.sampler.load_program()
        losses: list[float] = []
        step_times: list[float] = []
        stragglers = 0
        t0 = time.monotonic()

        for step in range(start_step, tc.steps):
            fetch_t0 = time.monotonic()
            batch = self.dataset.device_batch_at(step, self.torch_device)
            fetch_s = time.monotonic() - fetch_t0

            step_t0 = time.monotonic()
            self.params, self.opt_state, metrics = step_fn(self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            step_s = time.monotonic() - step_t0
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")

            # straggler mitigation: deadline = k x running median
            step_times.append(step_s)
            if len(step_times) >= 5:
                median = float(np.median(step_times[-20:]))
                if step_s > tc.straggler_deadline_factor * median:
                    stragglers += 1

            self._telemetry_tick(busy_s=step_s, idle_s=fetch_s)

            if tc.checkpoint_dir and (step + 1) % tc.checkpoint_every == 0:
                ck_t0 = time.monotonic()
                ckpt.save(tc.checkpoint_dir, step + 1, self.params, self.opt_state)
                self._telemetry_tick(busy_s=0.0,
                                     idle_s=time.monotonic() - ck_t0)

        self.sampler.unload_program()
        return TrainReport(
            steps_run=tc.steps - start_step,
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses,
            straggler_events=stragglers,
            resumed_from=resumed_from,
            telemetry_rows=len(self.sampler.frame()),
            wall_s=time.monotonic() - t0,
            step_s=step_times,
            replayed_steps=0 if self.graph is None else self.graph.replays,
        )
