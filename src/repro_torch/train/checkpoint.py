"""Step-atomic checkpoints, in the JAX package's layout:

    <dir>/step_00000123/
        arrays.npz          # flattened leaf -> array (on the host)
        manifest.json       # leaf paths, shapes, stored dtypes, step, extra
    <dir>/LATEST            # pointer file, written last

Leaves are flattened as ``jax.tree_util`` flattens them and keyed by their
``keystr`` paths (:mod:`repro_torch.train.tree`), so a checkpoint written by
either package restores in the other. bf16 and f16 are stored as f32 (npz
has no bf16) and cast back to the target leaf's dtype on restore. A step is
written to ``.tmp_step_*`` and renamed into place, and ``LATEST`` moves only
after a complete write, so a crash mid-write leaves the last complete step.

Elastic restore, as the reference's: DTensor state (a train step under a
mesh) is saved as whole arrays, gathered over its mesh; every rank of the
mesh calls :func:`save`, the one at the mesh's origin writes, and all leave
together. :func:`restore` places each loaded array by the target
placements (``param_shardings``/``opt_shardings`` from
``sharding.named``), or by the like leaf's own when it is a DTensor, so a
checkpoint saved on any mesh or on ``LOCAL`` restores on any other, byte
for byte.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.train.tree import flatten, unflatten


def _host_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def save(directory: str | pathlib.Path, step: int, params, opt_state,
         extra: dict | None = None) -> pathlib.Path:
    root = pathlib.Path(directory)
    step_dir = root / f"step_{step:08d}"
    flat = flatten({"params": params, "opt_state": opt_state})
    mesh = next((leaf.device_mesh for _, leaf in flat if isinstance(leaf, DTensor)), None)
    origin = mesh is None or not any(mesh.get_coordinate())
    arrays = {}
    for i, (_, leaf) in enumerate(flat):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()      # a collective: every rank of the mesh joins
        if origin:                         # only the origin copies to the host
            arrays[f"a{i}"] = _host_array(leaf)
    if not origin:
        _mesh_barrier(mesh)                # the origin writes; the others wait for it
        return step_dir

    tmp_dir = root / f".tmp_step_{step:08d}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    np.savez(tmp_dir / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "keys": [key for key, _ in flat],
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "extra": extra or {},
    }
    (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp_dir.rename(step_dir)
    (root / "LATEST").write_text(step_dir.name)       # the pointer last
    if mesh is not None:
        _mesh_barrier(mesh)
    return step_dir


def _mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` leaves only after all have entered: a barrier
    over each mesh dim's group in turn."""
    for name in mesh.mesh_dim_names:
        torch.distributed.barrier(group=mesh.get_group(name))


def latest_step(directory: str | pathlib.Path) -> int | None:
    root = pathlib.Path(directory)
    pointer = root / "LATEST"
    if not pointer.exists():
        return None
    name = pointer.read_text().strip()
    if not (root / name / "manifest.json").exists():
        return None
    return int(name.split("_")[1])


def restore(directory: str | pathlib.Path, like_params, like_opt_state,
            dist=None, param_shardings=None, opt_shardings=None,
            step: int | None = None):
    """Load a checkpoint (the latest when ``step`` is None) into trees shaped
    as ``like_*``, each leaf cast to the like leaf's dtype. With both
    ``*_shardings`` (``sharding.named`` trees) each leaf is placed on
    its mesh by them (elastic re-shard); otherwise a like leaf that is a
    DTensor gives its placements, and any other its device. ``dist`` is
    taken as the reference takes it, and not read: the shardings carry the
    mesh. Returns (params, opt_state, step)."""
    root = pathlib.Path(directory)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    step_dir = root / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())

    like = {"params": like_params, "opt_state": like_opt_state}
    flat = flatten(like)
    keys = [key for key, _ in flat]
    if keys != manifest["keys"]:
        missing = set(manifest["keys"]) ^ set(keys)
        raise ValueError(f"checkpoint/model structure mismatch: {sorted(missing)[:5]}...")

    shardings = [None] * len(flat)
    if param_shardings is not None and opt_shardings is not None:
        shardings = [sh for _, sh in flatten({"params": param_shardings,
                                              "opt_state": opt_shardings})]
    out = []
    with np.load(step_dir / "arrays.npz") as z:
        for i, ((_, leaf), sh) in enumerate(zip(flat, shardings)):
            arr = torch.from_numpy(z[f"a{i}"])
            if sh is not None:
                mesh, placements = sh.mesh, sh.placements
            elif isinstance(leaf, DTensor):
                mesh, placements = leaf.device_mesh, leaf.placements
            else:
                out.append(arr.to(device=leaf.device, dtype=leaf.dtype))
                continue
            out.append(distribute_tensor(arr.to(device=mesh.device_type, dtype=leaf.dtype),
                                         mesh, placements, src_data_rank=None))
    state = unflatten(like, out)
    return state["params"], state["opt_state"], step
