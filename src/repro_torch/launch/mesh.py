"""Production mesh construction (single-pod 16x16 and multi-pod 2x16x16),
as the JAX package's ``launch/mesh.py``, over the current
``torch.distributed`` process group.

Functions, not module-level constants, so importing this module never
touches the process group. Each rank of the group calls them (the mesh's
subgroups are made collectively).
"""
from __future__ import annotations

from repro_torch.distributed.context import LOCAL, DistContext, make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_dist(*, multi_pod: bool = False) -> DistContext:
    mesh = make_production_mesh(multi_pod=multi_pod)
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    return DistContext(mesh=mesh, batch_axes=batch_axes, model_axis="model")


def make_local_dist(data: int = 1, model: int = 1) -> DistContext:
    """A small (data, model) mesh over the group's first ranks, as tests use
    it; ``LOCAL`` for 1 x 1."""
    if data * model == 1:
        return LOCAL
    mesh = make_mesh((data, model), ("data", "model"))
    return DistContext(mesh=mesh, batch_axes=("data",), model_axis="model")
