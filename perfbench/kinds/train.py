"""Training from the trainer's CUDA graph: one general driver for every
training mix.

A mix (``traffic/<name>.json``, ``"kind": "train"``) gives the batch, the
sequence length, the optimizer the reference follows (which the trainer's
own, ``optimizer.for_arch``, has to match) and the number of set-up steps.
The batches are the trainer's seeded ``SyntheticDataset``'s, a step index
each, so no two steps see the same rows.

Set-up builds one ``Trainer`` from the seed, draws the run's weights into
its parameters and master weights, and drives it through its first steps
with the window's own loop body (the body of ``Trainer.run``: the batch of
the step, the step, ``float(loss)``, the straggler rule and the telemetry
tick), calling one ``TrainStepGraph``: its first
calls run eagerly, the next captures the step and replays it. After the
first step the optimizer's first moment gives the clipped gradient it got;
after the last set-up step the master weights' change from the drawn
weights is read, a block at a time. The window then loops the same body.
Once it has closed and the trainer is freed, the reference follows the
set-up steps in float32.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from perfbench.lib import compare, weights
from perfbench.lib.cell import flatten, model_config, same_layout
from perfbench.lib.trace import Tracer


def batch_at(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    """The batch of ``step``, as the trainer's dataset draws it: tokens and
    labels, one row of ``seq + 1`` draws shifted by one."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclasses.dataclass
class Steps:
    """The loop body's records, one a step."""
    start: list = dataclasses.field(default_factory=list)
    end: list = dataclasses.field(default_factory=list)
    step_s: list = dataclasses.field(default_factory=list)
    loss_at: list = dataclasses.field(default_factory=list)     # the loss on the host
    loss: list = dataclasses.field(default_factory=list)


class Loop:
    """The body of ``Trainer.run`` around one trainer and its step graph."""

    def __init__(self, trainer, tracer: Tracer, clock=time.perf_counter):
        from repro_torch.train.trainer import TrainStepGraph
        self.trainer = trainer
        dev = trainer.torch_device
        self.step_fn = (TrainStepGraph(trainer.step_fn, dev) if dev.type == "cuda"
                        else trainer.step_fn)
        trainer.graph = self.step_fn if dev.type == "cuda" else None
        self.tracer = tracer
        self.clock = clock
        self.steps = Steps()
        self.times: list[float] = []
        self.stragglers = 0

    def step(self, index: int) -> float:
        tr, span, clock = self.trainer, self.tracer.span, self.clock
        t0 = clock()
        with span("batch"):
            batch = tr.dataset.device_batch_at(index, tr.torch_device)
        fetch_s = clock() - t0
        t1 = clock()
        with span("step"):
            tr.params, tr.opt_state, metrics = self.step_fn(tr.params, tr.opt_state, batch)
            loss = float(metrics["loss"])
        step_s = clock() - t1
        with span("host"):
            self.times.append(step_s)
            if len(self.times) >= 5:
                med = float(np.median(self.times[-20:]))
                if step_s > tr.tc.straggler_deadline_factor * med:
                    self.stragglers += 1
            tr._telemetry_tick(busy_s=step_s, idle_s=fetch_s)
        t2 = clock()
        s = self.steps
        s.start.append(t0)
        s.end.append(t2)
        s.step_s.append(step_s)
        s.loss_at.append(t1 + step_s)
        s.loss.append(loss)
        return loss


def norms(leaves: dict, scale: float = 1.0) -> dict:
    """{path: the leaf's norm} of a {path: tensor} dict, times ``scale``."""
    paths = list(leaves)
    vals = torch.stack([torch.linalg.vector_norm(leaves[p].float()) for p in paths])
    return dict(zip(paths, (vals * scale).tolist()))


def change_norms(cfg: dict, ref, like: dict, master: dict, seed: int) -> dict:
    """{path: the distance of each leaf of ``master`` from the weights the
    run drew}, the drawn weights made again a block at a time on
    ``master``'s device, in the dtypes of ``like``, a tree of the drawn
    layout (a block's leaf may be a slice of a stacked parameter)."""
    path_of = {id(t): p for p, t in flatten(like).items()}
    flat = flatten(master)
    dev = next(iter(flat.values())).device
    acc = {p: torch.zeros((), device=dev) for p in flat}
    for i, block in enumerate(ref.fills(cfg, like)):
        for (leaf, _), w0 in zip(block, weights.draw_block(block, seed, i, dev)):
            base = leaf if leaf._base is None else leaf._base
            p = path_of[id(base)]
            at = leaf.storage_offset() - base.storage_offset()
            m = flat[p].view(-1)[at:at + leaf.numel()]
            acc[p] += (m - w0.reshape(-1).float()).square().sum()
    return {p: math.sqrt(float(v)) for p, v in acc.items()}


def make_trainer(cfg: dict, ref, mix: dict, seed: int, device: str):
    """The trainer, its parameters and master weights set to the run's
    weights."""
    from repro_torch.models import api
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mcfg = model_config(cfg)
    same_layout(ref.empty_params(cfg, "meta"), api.abstract_params(mcfg))
    tc = TrainerConfig(steps=mix["setup_steps"], checkpoint_dir=None,
                       lr=mix["optimizer"]["lr"])
    tr = Trainer(mcfg, tc, global_batch=mix["batch"], seq_len=mix["seq"],
                 controller=mix["controller"], seed=seed, device=device)
    with torch.no_grad():
        weights.fill(ref.fills(cfg, tr.params), seed)
        master = flatten(tr.opt_state["master"])
        for p, t in flatten(tr.params).items():
            master[p].copy_(t)
    return tr


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        clock=time.perf_counter, fault=None) -> dict:
    """One run of a training cell: set-up steps, the window, then the
    check. Returns the context the metric readers read."""
    cfg, ref, mix = cell.config, cell.reference, cell.traffic
    tr = make_trainer(cfg, ref, mix, seed, device)
    if fault is not None:
        fault(tr)
    tracer = Tracer(trace)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    loop = Loop(tr, tracer, clock)
    b1 = mix["optimizer"]["b1"]
    tr.sampler.load_program()
    for i in range(mix["setup_steps"]):
        loop.step(i)
        if i == 0:
            grad = norms(flatten(tr.opt_state["m"]), 1.0 / (1.0 - b1))
    change = change_norms(cfg, ref, tr.params, tr.opt_state["master"], seed)
    sync()

    start = clock()
    end = start + seconds
    first = len(loop.steps.loss)
    index = first
    trace_from = None
    while clock() < end:
        if trace and trace_from is None and clock() >= start + seconds / 4:
            trace_from = index
            tracer.start()
        loop.step(index)
        index += 1
        if trace_from is not None and index == trace_from + mix["trace_steps"]:
            tracer.stop(sync)
    tracer.stop(sync)
    tr.sampler.unload_program()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    setup_losses = loop.steps.loss[:first]
    window_losses = loop.steps.loss[first:]
    del tr.params, tr.opt_state, loop.step_fn
    tr.graph = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    want = reference_steps(cell, seed, device)
    moved = compare.moved_leaves(want["grad"])
    grad_worst, grad_leaf = compare.leaf_gap(grad, want["grad"])
    change_gap, change_leaf = compare.leaf_gap(change, want["change"], moved)
    checks = {
        "loss_gap": (max(compare.relative(a, b) for a, b in zip(setup_losses, want["loss"])),
                     cell.limits["loss_gap"]),
        "grad_median_gap": (compare.median_leaf_gap(grad, want["grad"]),
                            cell.limits["grad_median_gap"]),
        "change_gap": (change_gap, cell.limits["change_gap"]),
    }
    notes = [f"losses {setup_losses} reference {want['loss']}",
             f"grad: worst leaf {'/'.join(map(str, grad_leaf))} gap {grad_worst!r} "
             f"({grad[grad_leaf]!r} against {want['grad'][grad_leaf]!r})",
             f"change_gap at {'/'.join(map(str, change_leaf))}: {change[change_leaf]!r} "
             f"against {want['change'][change_leaf]!r}",
             f"leaves left out of the change: {sorted('/'.join(map(str, p)) for p in set(want['grad']) - moved)}"]
    failed = sum(1 for x in window_losses if not math.isfinite(x))
    return dict(cell=cell, window=(start, end),
                steps=loop.steps, first=first, trace=tracer.trace,
                traced_steps=mix["trace_steps"], memory_peak_bytes=peak, checks=checks,
                attempted=len(window_losses), failed=failed, notes=notes,
                tokens_per_step=mix["batch"] * mix["seq"],
                check=dict(grad=grad, change=change, want=want, moved=moved,
                           loss=setup_losses))


def reference_steps(cell, seed: int, device: str, mm=None, rows: slice = slice(None)) -> dict:
    """The reference's first steps in float32 (TF32 off) from the run's
    weights and batches: each step's loss, the first clipped gradient's
    norms and the weights' change after the last, by path. ``mm`` and
    ``rows`` (the batch rows each step takes) let the control and its faults
    run the same steps otherwise."""
    cfg, ref, mix = cell.config, cell.reference, cell.traffic
    opt = mix["optimizer"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        drawn = ref.empty_params(cfg, device)
        weights.fill(ref.fills(cfg, drawn), seed)
        params = {p: t.float().requires_grad_(True) for p, t in flatten(drawn).items()}
        del drawn
        like = ref.empty_params(cfg, "meta")
        tree = _unflatten(like, params)
        m = {p: torch.zeros_like(t) for p, t in params.items()}
        v = {p: torch.zeros_like(t) for p, t in params.items()}
        kw = {} if mm is None else {"mm": mm}
        losses, grad = [], None
        for step in range(mix["setup_steps"]):
            b = batch_at(seed, step, mix["batch"], mix["seq"], cfg["vocab_size"])
            tokens, labels = (torch.from_numpy(np.ascontiguousarray(b[k][rows])).long().to(device)
                              for k in ("tokens", "labels"))
            loss = ref.loss(tree, tokens, labels, cfg, **kw)
            gs = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                total = torch.sqrt(sum(g.square().sum() for g in gs))
                scale = torch.clamp(opt["grad_clip"] / torch.clamp(total, min=1e-9), max=1.0)
                c = step + 1
                bc1, bc2 = 1 - opt["b1"] ** c, 1 - opt["b2"] ** c
                for (p, t), g in zip(params.items(), gs):
                    g = g * scale
                    m[p].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    v[p].mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                    u = (m[p] / bc1) / ((v[p] / bc2).sqrt() + opt["eps"])
                    t.sub_(opt["lr"] * (u + opt["weight_decay"] * t))
                if step == 0:
                    grad = norms(m, 1.0 / (1.0 - opt["b1"]))
            del gs
        del m, v
        with torch.no_grad():
            change = change_norms(cfg, ref, like, tree, seed)
        return dict(loss=losses, grad=grad, change=change)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _unflatten(like, flat: dict, prefix: tuple = ()):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, flat, prefix + (i,)) for i, v in enumerate(like)]
    return flat[prefix]
