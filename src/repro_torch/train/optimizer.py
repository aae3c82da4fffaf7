"""Optimizers over parameter trees (nested dicts and lists of tensors), as
the JAX package's ``train/optimizer.py``.

* **AdamW**: f32 master weights + f32 first and second moments (12 B a
  parameter of state beside the model-dtype parameters).
* **Adafactor**: a factored second moment (row and column statistics) for
  matrices whose last two axes are at least ``min_dim_size_to_factor``, no
  first moment, f32 master weights.

API:
    opt = adamw(lr=...) | adafactor(lr=...)
    state = opt.init(params)
    new_params, new_state, stats = opt.step(params, grads, state)
    specs = opt.state_specs(param_spec_tree, abstract_params)

Gradients are clipped by their global norm in f32, a leaf at a time. The
step updates the state's tensors and the parameters in place, under
``torch.no_grad()``: the parameters become the master weights cast back to
their dtype, as the reference's step returns them, and the new trees are
the ones passed in, ``count`` (a 0-d int32 tensor) advanced in place too: a
CUDA graph captured on the trees reads and writes the same tensors at every
replay. State trees mirror the parameter tree, so the parameters' specs
apply leaf-wise (factored statistics drop one dim and inherit the
compatible prefix of the spec). Under a mesh the trees are DTensors placed
so, and the same step runs on them: DTensor reduces what a norm, a mean or
a factored statistic needs over the ranks that share a leaf.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.distributed.context import P
from repro_torch.train.tree import leaves, map_up_to


class Optimizer(NamedTuple):
    init: Callable
    step: Callable
    state_specs: Callable  # (param_specs, abstract_params) -> state spec tree


def _global_norm(tree) -> torch.Tensor:
    return torch.stack([g.float().square().sum() for g in leaves(tree)]).sum().sqrt()


def _clip_scale(grads, max_norm: float):
    """The factor that clips ``grads`` by their global norm to ``max_norm``,
    and the norm. The steps apply it a leaf at a time (``g.float() *
    scale``), so that one leaf's f32 gradient is alive at a time, not the
    whole tree's: a CUDA graph's capture cannot free cached memory to
    make room."""
    norm = _global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _master(params):
    return map_up_to(lambda p: p.detach().to(torch.float32, copy=True), params)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"master": _master(params), "m": map_up_to(zeros, params),
                "v": map_up_to(zeros, params), "count": _count(params)}

    @torch.no_grad()
    def step(params, grads, state):
        scale, gnorm = _clip_scale(grads, grad_clip)
        count = state["count"].add_(1)
        c = count.float()
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c

        def upd(p, g, master, m, v):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / bc1) / ((v / bc2).sqrt() + eps)
            master.sub_(lr * u.add_(weight_decay * master))
            p.copy_(master)

        map_up_to(upd, params, grads, state["master"], state["m"], state["v"])
        return params, state, {"grad_norm": gnorm}

    def state_specs(param_specs, abstract_params):
        return {"master": param_specs, "m": param_specs, "v": param_specs,
                "count": P()}

    return Optimizer(init=init, step=step, state_specs=state_specs)


# --------------------------------------------------------------------------- #
# Adafactor (factored second moment, beta1 = 0)
# --------------------------------------------------------------------------- #
def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              weight_decay: float = 0.0, grad_clip: float = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    def _factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def stats(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"master": _master(params), "stats": map_up_to(stats, params),
                "count": _count(params)}

    @torch.no_grad()
    def step(params, grads, state):
        scale, gnorm = _clip_scale(grads, grad_clip)
        beta2 = 1.0 - state["count"].add_(1).float() ** (-decay)

        def upd(p, g, master, st):
            g = g.float() * scale
            g2 = g.square() + eps
            if _factored(g.shape):
                vr, vc = st["vr"], st["vc"]
                vr.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
                vc.mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                v = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            else:
                v = st["v"].mul_(beta2).add_((1 - beta2) * g2)
            update = g * torch.rsqrt(v + eps)
            rms = (update.square().mean() + eps).sqrt()
            update = update / torch.clamp(rms, min=1.0)
            master.sub_(lr * (update + weight_decay * master))
            p.copy_(master)

        map_up_to(upd, params, grads, state["master"], state["stats"])
        return params, state, {"grad_norm": gnorm}

    def state_specs(param_specs, abstract_params):
        def stats_spec(leaf, spec):
            axes = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
            if _factored(leaf.shape):
                return {"vr": P(*axes[:-1]), "vc": P(*(axes[:-2] + (axes[-1],)))}
            return {"v": P(*axes)}

        return {"master": param_specs,
                "stats": map_up_to(stats_spec, abstract_params, param_specs),
                "count": P()}

    return Optimizer(init=init, step=step, state_specs=state_specs)


def for_arch(arch_name: str, lr: float = 3e-4) -> Optimizer:
    """Giant archs get Adafactor (memory); everything else AdamW."""
    if arch_name.startswith(("deepseek-v3", "llama-3.2-vision")):
        return adafactor(lr=lr)
    return adamw(lr=lr)
