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
The reference's mesh and sharding arguments (elastic re-shard) belong to
distribution and are not ported.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import torch

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
    tmp_dir = root / f".tmp_step_{step:08d}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)

    flat = flatten({"params": params, "opt_state": opt_state})
    arrays = {f"a{i}": _host_array(leaf) for i, (_, leaf) in enumerate(flat)}
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
    return step_dir


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
            step: int | None = None):
    """Load a checkpoint (the latest when ``step`` is None) into trees shaped
    as ``like_*``, each leaf cast to the like leaf's dtype on its device.
    Returns (params, opt_state, step)."""
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

    with np.load(step_dir / "arrays.npz") as z:
        out = [torch.from_numpy(z[f"a{i}"]).to(device=leaf.device, dtype=leaf.dtype)
               for i, (_, leaf) in enumerate(flat)]
    state = unflatten(like, out)
    return state["params"], state["opt_state"], step
