"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell's
step as the port runs it, with nothing allocated and no card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell with
XLA on 512 fake CPU devices and reads memory, cost and collective bytes from
the compiled HLO. The port has no HLO. It runs the cell's step
(``train.trainer.make_train_step``, ``api.prefill`` or ``api.decode_step``)
eagerly with parameters, optimizer state, caches and batches on the
``meta`` device, over the in-process fake process group
(``torch.testing._internal.distributed.fake_pg``) for the 16 x 16 and
2 x 16 x 16 meshes, and counts FLOPs, HBM bytes and collective bytes with
``roofline.op_count`` while it runs. The only device is ``meta``: every
tensor the cell makes is made there, so nothing is allocated.

The per-rank program is the port's, not GSPMD's: the sharded train step
gathers every parameter whole and computes the ``model`` axis redundantly
outside the expert dispatch, and the serve path holds the whole parameters
on every rank and runs the rank's batch rows. So on a 16 x 16 mesh a rank
does about 16 times the useful FLOPs that the reference's per-device
program does, and ``useful_fraction`` shows it.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --out reports/dryrun_torch
    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train:8x128 --mesh local
    python -m repro_torch.launch.dryrun --all --tune attn_grouped,q_block=512

``--shape`` takes a cell of ``LM_SHAPES`` or ``kind:BATCHxSEQ``; ``--mesh
local`` is a world of one rank (no process group). Each cell's result goes
to ``<out>/<arch>__<shape>__<mesh>.json`` with the reference's keys, and its
op log to ``.ops.json.gz`` beside it (``roofline/rederive.py``). ``memory``
holds a rank's ``argument_size_in_bytes`` and ``output_size_in_bytes``,
exact from the shapes (a DTensor's local shard). It has no
``temp_size_in_bytes``: autograd keeps the tensors it saves without a
Python reference, so a dispatch mode cannot see when their storage is
freed, and no sound peak of live intermediates exists. ``lower_s`` is the
trace's seconds; ``compile_s`` is 0, since nothing is compiled.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import math
import pathlib
import re
import time
import traceback
from typing import Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES, cell_is_applicable, get_config,
                                 get_smoke_config)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.context import DistContext
from repro_torch.launch.mesh import make_dist, make_local_dist
from repro_torch.models import api, tuning
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_count import OpCounter
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainer import make_train_step, place, train_shardings

META = torch.device("meta")
#: ranks of the production meshes (``launch/mesh.py``)
MESH_RANKS = {"single": 256, "multi": 512}
_CUSTOM_SHAPE = re.compile(r"^(train|prefill|decode):(\d+)x(\d+)$")


def shape_spec(name: str) -> ShapeSpec:
    """A cell of ``LM_SHAPES``, or ``kind:BATCHxSEQ`` (e.g. ``train:8x128``)."""
    if name in LM_SHAPES:
        return LM_SHAPES[name]
    m = _CUSTOM_SHAPE.match(name)
    if not m:
        raise ValueError(f"unknown shape {name!r}: one of {sorted(LM_SHAPES)} or "
                         "kind:BATCHxSEQ with kind train, prefill or decode")
    return ShapeSpec(name, int(m.group(3)), int(m.group(2)), m.group(1))


# --------------------------------------------------------------------------- #
# abstract inputs
# --------------------------------------------------------------------------- #
def _stubs(cfg: ModelConfig, b: int) -> dict:
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.empty((b, cfg.n_frames, cfg.d_model), device=META)
    if cfg.family == "vlm":
        out["vision"] = torch.empty((b, cfg.n_vision_tokens, cfg.d_model), device=META)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, rows: int | None = None) -> dict:
    """``meta`` stand-ins for every model input of this cell: the global
    batch for training, ``rows`` of it (all by default) for the serve path."""
    b, s = (shape.global_batch if rows is None else rows), shape.seq_len
    tokens = torch.empty((b, s), dtype=torch.long, device=META)
    if shape.kind == "train":
        return {"batch": {"tokens": tokens, "labels": torch.empty_like(tokens),
                          **_stubs(cfg, b)}}
    if shape.kind == "prefill":
        return {"tokens": tokens, **_stubs(cfg, b)}
    # decode: KV cache filled to seq_len, one new token
    return {"cache": api.init_cache(cfg, b, s, device=META),
            "tokens": torch.empty((b, 1), dtype=torch.long, device=META)}


def model_flops_global(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Useful-math floor: 6*N_active*tokens (train) / 2*N_active*tokens."""
    n_active = api.active_params_abstract(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


# --------------------------------------------------------------------------- #
# per-cell tracing
# --------------------------------------------------------------------------- #
def local_bytes(tree) -> int:
    """Bytes one rank holds of the tensors in ``tree`` (a DTensor's local
    shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def rank_rows(dist: DistContext, global_batch: int) -> int:
    """The batch rows one rank serves: the global batch split over the batch
    axes where it divides (``sharding.token_specs``), else all of it."""
    return global_batch // dist.dp_size if global_batch % dist.dp_size == 0 else global_batch


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, dist: DistContext
               ) -> tuple[OpCounter, dict]:
    """Run the cell's step once on ``meta`` under an op counter, as the port
    runs it: ``make_train_step(cfg, for_arch(...), dist)`` on the global
    batch (parameters and optimizer state placed by the step's shardings),
    or ``api.prefill`` / ``api.decode_step`` with ``dist`` on the rank's
    batch rows and the whole parameters. Returns (the counter, the per-rank
    bytes of the step's arguments and outputs)."""
    params = api.abstract_params(cfg, ep_size=dist.ep_size)
    if shape.kind == "train":
        optimizer = opt_mod.for_arch(cfg.name)
        opt_state = optimizer.init(params)
        if dist.enabled:
            sh = train_shardings(cfg, optimizer, dist)
            params, opt_state = place(params, sh["params"]), place(opt_state, sh["opt_state"])
        batch = input_specs(cfg, shape)["batch"]
        args = (params, opt_state, batch)
        step = make_train_step(cfg, optimizer, dist)
        arg_bytes = local_bytes((params, opt_state)) + \
            local_bytes(batch) * rank_rows(dist, shape.global_batch) // shape.global_batch
    else:
        specs = input_specs(cfg, shape, rank_rows(dist, shape.global_batch))
        if shape.kind == "prefill":
            stubs = {k: v for k, v in specs.items() if k != "tokens"}

            def step(p, tokens):
                return api.prefill(p, tokens, cfg, dist=dist, **stubs)
            args = (params, specs["tokens"])
        else:
            def step(p, cache, tokens):
                return api.decode_step(p, cache, tokens, cfg, dist=dist)
            args = (params, specs["cache"], specs["tokens"])
        arg_bytes = local_bytes((params, specs))
    with OpCounter() as counter:
        out = step(*args)
    return counter, {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": local_bytes(out)}


@contextlib.contextmanager
def fake_world(ranks: int) -> Iterator[None]:
    """A fake process group of ``ranks`` ranks in this process (rank 0), torn
    down on the way out; nothing for one rank. The group is global to the
    process, so a cell makes its own and none may be open already."""
    if ranks == 1:
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if torch.distributed.is_initialized():
        raise RuntimeError("a process group is open already; the dry-run makes its own")
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _cell_file(out_dir: pathlib.Path, arch: str, shape: str, mesh: str, suffix: str):
    return out_dir / f"{arch.replace('.', '_')}__{shape.replace(':', '_')}__{mesh}{suffix}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path | None = None, tune: str = "", *,
             world: tuple[int, int] | None = None, smoke: bool = False) -> dict:
    """Trace one cell and derive its roofline terms (H100 constants). The
    mesh is the production one (``multi_pod``: 2 x 16 x 16, else 16 x 16) or,
    with ``world`` = (data, model), a mesh of that many ranks (1 x 1: no
    process group, ``LOCAL``). ``smoke`` takes the reduced config."""
    tuning.set_tuning(**tuning.parse(tune))
    if world is not None:
        mesh_name = "local" if world == (1, 1) else f"{world[0]}x{world[1]}"
        ranks = math.prod(world)
    else:
        mesh_name = "multi" if multi_pod else "single"
        ranks = MESH_RANKS[mesh_name]
    if tune:
        mesh_name += "__tuned-" + tuning.ACTIVE.describe()
    t0 = time.time()
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "tune": tuning.ACTIVE.describe()}
    try:
        if not cell_is_applicable(arch, shape_name):
            result["status"] = "skipped"
            result["reason"] = ("long_500k needs sub-quadratic attention; "
                                "full-attention arch")
            result["wall_s"] = 0.0
            return result
        try:
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
            shape = shape_spec(shape_name)
            with fake_world(ranks):
                dist = (make_dist(multi_pod=multi_pod) if world is None
                        else make_local_dist(*world))
                counter, memory = trace_cell(cfg, shape, dist)
            stats = counter.stats()
            terms = roofline.derive_terms({}, stats, ranks, model_flops_global(cfg, shape))
            result.update({
                "status": "ok",
                "lower_s": round(time.time() - t0, 1),   # the trace; nothing is compiled
                "compile_s": 0.0,
                "n_chips": ranks,
                "memory": memory,
                "collectives": {"total_bytes": stats.collective_bytes,
                                "by_op": stats.collective_by_op,
                                "counts": stats.collective_counts},
                "roofline": terms.as_dict(),
            })
            if out_dir is not None:
                out_dir.mkdir(parents=True, exist_ok=True)
                with gzip.open(_cell_file(out_dir, arch, shape_name, mesh_name, ".ops.json.gz"),
                               "wt") as f:
                    json.dump(counter.entries(), f)
        except Exception as e:  # noqa: BLE001 — record, don't abort the sweep
            result["status"] = "error"
            result["error"] = f"{type(e).__name__}: {e}"
            result["traceback"] = traceback.format_exc()[-2000:]
        result["wall_s"] = round(time.time() - t0, 1)
        return result
    finally:
        tuning.reset()
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            _cell_file(out_dir, arch, shape_name, mesh_name, ".json").write_text(
                json.dumps(result, indent=1, default=str))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    help=f"one of {sorted(LM_SHAPES)} or kind:BATCHxSEQ")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "local"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="reduced same-family configs")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tune", default="",
                    help="comma list of tuning knobs, e.g. attn_probs_bf16,seq_parallel")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    archs = list(ASSIGNED_ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(LM_SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"],
              "local": ["local"]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                name = _cell_file(out_dir, arch, shape, mesh, "").name
                prev_path = _cell_file(out_dir, arch, shape, mesh, ".json")
                if args.skip_existing and prev_path.exists():
                    prev = json.loads(prev_path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip] {name} ({prev['status']})", flush=True)
                        continue
                r = run_cell(arch, shape, mesh == "multi", out_dir, tune=args.tune,
                             world=(1, 1) if mesh == "local" else None, smoke=args.smoke)
                msg = r.get("error", "")[:120]
                extra = ""
                if r["status"] == "ok":
                    rf = r["roofline"]
                    extra = (f"bottleneck={rf['bottleneck']} "
                             f"c={rf['compute_s']:.4f}s m={rf['memory_s']:.4f}s "
                             f"x={rf['collective_s']:.4f}s flops={rf['flops']:.6e} ")
                print(f"[{r['status']:7s}] {name} wall={r['wall_s']}s {extra}{msg}",
                      flush=True)


if __name__ == "__main__":
    main()
