"""Distribution context threaded through model and training code, as the JAX
package's ``distributed/context.py``, on ``torch.distributed``.

``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` whose dim
names are the reference's axis names (``"data"``, ``"model"``, ``"pod"``),
or None: ``LOCAL``, one process on one device, MoE by the dense dispatch.
With a mesh, parameters and optimizer state are DTensors placed by their
:class:`P` specs (:mod:`repro_torch.distributed.sharding`), and MoE runs
expert-parallel over the ``model`` axis (``models.moe.moe_ffn_ep``).

:class:`P` is the port's PartitionSpec: one entry a tensor dim, each
``None``, an axis name, or a tuple of names that shard the dim over those
mesh dims, major to minor, as in JAX. :class:`NamedSharding` pairs a spec
with its mesh and gives the DTensor placements, one a mesh dim: ``Shard(d)``
on the mesh dims that the spec puts on tensor dim ``d``, ``Replicate()`` on
the others.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor


class P:
    """A PartitionSpec: ``P(None, "model")``, ``P(("pod", "data"), None)``.

    A one-name tuple is that name, as the reference's spec normalises it.
    Compares equal to any sequence of the same entries (a JAX spec
    included). Not a tuple, so that spec trees keep it as a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        try:
            return self._entries == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}" if len(self._entries) != 1 else f"P({self._entries[0]!r})"


def placements(mesh: DeviceMesh, spec: P) -> tuple[Placement, ...]:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim. A
    tuple entry must name its mesh dims in the mesh's order (major to
    minor), and a mesh dim may shard one tensor dim only."""
    names = mesh.mesh_dim_names
    out: list[Placement] = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"spec {spec} on mesh {names}: the axes of a dim go "
                             f"in the mesh's order, each on one dim")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple[Placement, ...]:
        return placements(self.mesh, self.spec)

    def place(self, t: torch.Tensor) -> DTensor:
        """``t`` (the whole tensor, the same on every rank of the mesh) as a
        DTensor placed so: each rank keeps its own shard, with no
        communication. A DTensor is redistributed instead, or kept when it is
        placed so already."""
        if isinstance(t, DTensor):
            if tuple(t.placements) == self.placements:
                return t
            return t.redistribute(self.mesh, self.placements)
        return distribute_tensor(t, self.mesh, self.placements, src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: DeviceMesh | None = None
    #: axes that shard the global batch (("pod","data") on the multi-pod mesh)
    batch_axes: tuple[str, ...] = ("data",)
    #: axis used for tensor/expert/sequence parallelism
    model_axis: str = "model"

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def axis_size(self, axis) -> int:
        """The size of a mesh axis, or the product over a tuple of axes."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        names = self.mesh.mesh_dim_names
        return math.prod(self.mesh.shape[names.index(a)] for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.batch_axes) if self.enabled else 1

    @property
    def ep_size(self) -> int:
        return self.axis_size(self.model_axis) if self.enabled else 1

    # ------------------------------------------------------------------ #
    def batch_spec(self, *rest) -> P:
        return P(self.batch_axes, *rest)

    def constraint(self, x, spec: P):
        """A DTensor redistributed to ``spec``'s placements (autograd-aware);
        a plain tensor, or anything under ``LOCAL``, unchanged."""
        if not self.enabled or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.mesh, spec))

    def sharding(self, spec: P) -> NamedSharding:
        assert self.mesh is not None
        return NamedSharding(self.mesh, spec)


#: default single-process context (no mesh)
LOCAL = DistContext()


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over the process group's first ``prod(shape)``
    ranks, row-major, as ``jax.make_mesh`` lays out the first devices. Every
    rank of the group makes it (its subgroups are made collectively); a rank
    outside it holds no coordinate and takes no part in its collectives."""
    if not torch.distributed.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed process group")
    n = math.prod(shape)
    world = torch.distributed.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has {world}")
    # the group's device type: "cuda" under NCCL, the CPU under gloo
    device = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(shape), mesh_dim_names=tuple(names))
