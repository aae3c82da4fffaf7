"""The rank side of tests/test_torch_distributed.py: a gloo group of CPU
processes started by ``torch.multiprocessing.spawn`` from a ``FileStore``
under the test's ``tmp_path``. These processes import only torch, numpy and
the port; the test computes the JAX package's side and hands numpy arrays
in. Each rank writes what it returns to ``rank<r>.pkl`` beside the store.
"""
from __future__ import annotations

import dataclasses
import datetime
import pathlib
import pickle

import numpy as np
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

#: CPU threads a rank (the groups run 2 or 4 ranks side by side)
THREADS = 2


def run_world(fn, world: int, tmp_path, payload) -> list:
    """``fn(rank, payload)`` on each rank of a new gloo group of ``world``
    processes; returns their results in rank order."""
    tmp = pathlib.Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(world, str(tmp), fn, payload), nprocs=world, join=True)
    return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _entry(rank: int, world: int, tmp: str, fn, payload) -> None:
    torch.set_num_threads(THREADS)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=180))
    try:
        out = fn(rank, payload)
        (pathlib.Path(tmp) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def smoke_f32(arch: str, **overrides):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **overrides)


# --------------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------------- #
def compress_worker(rank: int, payload) -> dict:
    from repro_torch.distributed.compression import (compressed_psum,
                                                     make_compressed_allreduce)
    from repro_torch.distributed.context import make_mesh

    mesh = make_mesh((2,), ("pod",))
    g = torch.from_numpy(payload["g"][rank])
    e = torch.from_numpy(payload["e"][rank])
    out, err = compressed_psum({"g": g}, mesh.get_group("pod"), {"g": e})
    mean, _ = make_compressed_allreduce(mesh)({"g": g}, {"g": e})
    return {"out": out["g"].numpy(), "err": err["g"].numpy(), "mean": mean["g"].numpy()}


# --------------------------------------------------------------------------- #
# the expert-parallel dispatch
# --------------------------------------------------------------------------- #
def ep_worker(rank: int, payload) -> dict:
    from repro_torch.launch.mesh import make_local_dist
    from repro_torch.models import moe

    dist = make_local_dist(1, 2)
    cfg = smoke_f32(payload["arch"])
    e_loc = payload["p"]["router"].shape[-1] // 2
    results = {}
    for cap, s in payload["cases"]:
        p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in payload["p"].items()}
        x = torch.from_numpy(payload["x"][:, :s]).requires_grad_(True)
        out, aux = moe.moe_ffn_ep(x, p, cfg, dist, capacity_factor=cap, aux=True)
        loss = (out * torch.from_numpy(payload["w"][:, :s])).sum()
        names = ("router", "we_gate", "we_up", "we_down")
        grads = torch.autograd.grad(loss, [x] + [p[n] for n in names])
        mine = slice(rank * e_loc, (rank + 1) * e_loc)
        results[(cap, s)] = {
            "out": _np(out), "aux": float(aux), "dx": _np(grads[0]),
            "drouter": _np(grads[1]),
            **{f"d{n}": _np(g[mine]) for n, g in zip(names[1:], grads[2:])},
            # the other rank's experts get no gradient here
            "dother": float(sum(g.abs().sum() - g[mine].abs().sum() for g in grads[2:])),
        }
    # the serving path: a prefill (its sequence split over ``model``) and a
    # decode step (every rank dispatching every token)
    from repro_torch.convert import params_from_jax
    from repro_torch.models import api
    params = params_from_jax(payload["model"], cfg, "cpu")
    tokens = torch.from_numpy(payload["tokens"])
    cache, prefill_logits = api.prefill(params, tokens[:, :-1], cfg, dist=dist)
    cache = api.pad_cache(cfg, cache, tokens.shape[1])
    _, decode_logits = api.decode_step(params, cache, tokens[:, -1:], cfg, dist=dist)
    results["serve"] = {"prefill": _np(prefill_logits), "decode": _np(decode_logits)}
    return results


# --------------------------------------------------------------------------- #
# elastic restore
# --------------------------------------------------------------------------- #
def _ckpt_trees(arch: str):
    from repro_torch.models import api
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.tree import leaves

    cfg = smoke_f32(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    opt = adamw()
    state = opt.init(params)
    # a state that is not all zeros
    for t in leaves([state["m"], state["v"]]):
        t.normal_(generator=torch.Generator().manual_seed(1))
    return cfg, opt, params, state


def ckpt_worker(rank: int, payload) -> dict:
    """Restore the LOCAL checkpoint onto a 2 x 1 mesh (ranks 0-1) and a 2 x 2
    mesh (all four): every leaf whole equals the LOCAL tree byte for byte;
    then save the 2 x 2 mesh's state for the test to restore on LOCAL."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_dist
    from repro_torch.models import api
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import place
    from repro_torch.train.tree import flatten

    cfg, opt, params, state = _ckpt_trees(payload["arch"])
    want = flatten({"params": params, "opt_state": state})
    out = {}
    for shape in ((2, 1), (2, 2)):
        dist = make_local_dist(*shape)
        if dist.mesh.get_coordinate() is None:
            continue
        abstract = api.abstract_params(cfg)
        specs = shd.param_specs(abstract, dist)
        p_sh = shd.named(dist, specs)
        o_sh = shd.named(dist, opt.state_specs(specs, abstract))
        like_p, like_o = _ckpt_trees(payload["arch"])[2:]
        got_p, got_o, step = ckpt.restore(payload["local_dir"], like_p, like_o, dist=dist,
                                          param_shardings=p_sh, opt_shardings=o_sh)
        got = flatten({"params": got_p, "opt_state": got_o})
        same = [a == b and x.dtype == y.dtype and torch.equal(x.full_tensor(), y)
                for (a, x), (b, y) in zip(got, want)]
        sharded = sum(any(pl.is_shard() for pl in x.placements) for _, x in got)
        out[shape] = {"step": step, "equal": all(same), "leaves": len(same),
                      "sharded_leaves": sharded}
        if shape == (2, 2):
            ckpt.save(payload["mesh_dir"], 5, place(params, p_sh), place(state, o_sh))
    return out


# --------------------------------------------------------------------------- #
# the sharded train step
# --------------------------------------------------------------------------- #
def train_worker(rank: int, payload) -> dict:
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_local_dist
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import for_arch
    from repro_torch.train.trainer import make_train_step

    out = {}
    for case in payload["cases"]:
        dist = make_local_dist(*case["mesh"])
        if dist.mesh.get_coordinate() is None:
            continue
        cfg = smoke_f32(case["arch"])
        opt = for_arch(cfg.name, lr=payload["lr"])
        params = params_from_jax(case["params"], cfg, "cpu")
        state = opt.init(params)
        step = make_train_step(cfg, opt, dist)
        data = SyntheticDataset(cfg, payload["batch"], payload["seq"], seed=0)
        losses, norms = [], []
        for i in range(payload["steps"]):
            params, state, m = step(params, state, data.device_batch_at(i, "cpu"))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[case["id"]] = {"losses": losses, "grad_norms": norms}
    return out


def inplace_worker(rank: int, payload) -> dict:
    """Two sharded steps of ``make_train_step``'s function on a CPU
    ``Trainer``'s trees under each case's mesh, and the same two steps on
    copies of the trees: after each step, the leaves whose DTensor is not
    the one passed in or whose local tensor is not the same object at the
    same address (``count`` included; none, for a graph to be captured on
    them); the leaves that differ from the copies' after both steps; then
    one ``Trainer.run`` step on the CPU (no graph, nothing replayed)."""
    from repro_torch.launch.mesh import make_local_dist
    from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step
    from repro_torch.train.tree import flatten, leaves, unflatten

    def local_leaves(params, state):
        with torch.no_grad():       # to_local() is then the DTensor's own local tensor
            return [(path, t, t.to_local())
                    for path, t in flatten({"params": params, "opt_state": state})]

    out = {}
    for case in payload["cases"]:
        dist = make_local_dist(*case["mesh"])
        if dist.mesh.get_coordinate() is None:
            continue
        cfg = smoke_f32(case["arch"], **case["wide"])
        tr = Trainer(cfg, TrainerConfig(steps=1), dist=dist, global_batch=payload["batch"],
                     seq_len=payload["seq"], device="cpu")
        params, state = tr.params, tr.opt_state
        first = [(path, t, local, local.data_ptr())
                 for path, t, local in local_leaves(params, state)]
        copies = [unflatten(tree, [t.detach().clone() for t in leaves(tree)])
                  for tree in (params, state)]
        step = make_train_step(cfg, tr.optimizer, dist)
        moved = []
        for i in range(2):
            batch = tr.dataset.device_batch_at(i, "cpu")
            params, state, _ = step(params, state, batch)
            moved.append([path for (path, t, local, ptr), (_, now, now_local)
                          in zip(first, local_leaves(params, state))
                          if not (now is t and now_local is local and now_local.data_ptr() == ptr)])
            copies[0], copies[1], _ = step(*copies, batch)
        differ = [path for (path, a), (_, b) in zip(flatten({"p": params, "s": state}),
                                                    flatten({"p": copies[0], "s": copies[1]}))
                  if not torch.equal(a.full_tensor(), b.full_tensor())]
        count = int(state["count"].full_tensor())
        report = tr.run()
        out[case["id"]] = {
            "paths": [path for path, _, _, _ in first], "moved": moved, "differ": differ,
            "count": count, "sharded": sum(any(pl.is_shard() for pl in t.placements)
                                           for _, t, _, _ in first),
            "replayed_steps": report.replayed_steps, "graph": tr.graph is not None,
            "steps_run": report.steps_run}
    return out


# --------------------------------------------------------------------------- #
# the what-if config axis
# --------------------------------------------------------------------------- #
def family_grid():
    """Every IR-capable family, with both parking+downscale composites (as
    tests/test_torch_whatif.py's)."""
    from repro_torch.core.controller import ControllerConfig, DownscaleMode
    from repro_torch.core.imbalance import PoolConfig, PoolPolicy
    from repro_torch.whatif import (CompositePolicy, DownscalePolicy, ParkingPolicy,
                                    default_policy_grid)

    park = ParkingPolicy(pool=PoolConfig(n_devices=4, policy=PoolPolicy.CONSOLIDATED,
                                         n_active=2),
                         resume_latency_s=12.0)
    return default_policy_grid(dense=False) + [
        CompositePolicy((park, DownscalePolicy())),
        CompositePolicy((park, DownscalePolicy(config=ControllerConfig(
            threshold_x_s=3.0, cooldown_y_s=9.0, mode=DownscaleMode.SM_AND_MEM)))),
    ]


def whatif_worker(rank: int, payload) -> dict:
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import default_families, evaluate, search_frontier
    from repro_torch.whatif.backend import config_mesh

    kw = dict(backend="torch", device="cpu", min_job_duration_s=0.0)
    store = TelemetryStore(payload["store"])
    grid = family_grid()
    one, four = config_mesh(1), config_mesh(4)
    out = {}
    if rank == 0:
        out["mesh1"] = evaluate(grid, store, dist=one, **kw)
        out["local"] = evaluate(grid, store, **kw)
    out["mesh4"] = evaluate(grid, store, dist=four, **kw)
    search = dict(max_rounds=2, max_evals=60, families=default_families(composites=False))
    out["search4"] = search_frontier(store, dist=four, **search, **kw)
    if rank == 0:
        out["search_local"] = search_frontier(store, **search, **kw)
    return out


# --------------------------------------------------------------------------- #
# the optimizers on DTensors
# --------------------------------------------------------------------------- #
def optimizer_worker(rank: int, payload) -> dict:
    """Three steps of each optimizer on trees placed by its ``state_specs``
    over a 2 x 2 mesh, the gradients placed as the parameters; every leaf
    whole is returned for the test to hold against the LOCAL steps."""
    from repro_torch.distributed.context import P
    from repro_torch.launch.mesh import make_local_dist
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.trainer import place
    from repro_torch.train.tree import flatten

    dist = make_local_dist(2, 2)
    specs = {k: P(*v) for k, v in payload["specs"].items()}
    out = {}
    for name, make in (("adamw", adamw), ("adafactor", adafactor)):
        opt = make(**payload["kw"][name])
        params = {k: torch.from_numpy(v.copy()) for k, v in payload["params"].items()}
        p_sh = shd.named(dist, specs)
        o_sh = shd.named(dist, opt.state_specs(specs, params))
        state = place(opt.init(params), o_sh)
        params = place(params, p_sh)
        norms = []
        for g in payload["grads"]:
            grads = place({k: torch.from_numpy(v) for k, v in g.items()}, p_sh)
            params, state, stats = opt.step(params, grads, state)
            norms.append(float(stats["grad_norm"].full_tensor()))
        out[name] = {"tree": {k: v.full_tensor().numpy()
                              for k, v in flatten({"p": params, "s": state})},
                     "norms": norms}
    return out
