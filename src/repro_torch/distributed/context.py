"""Distribution context threaded through the training code, as the JAX
package's ``distributed/context.py``: its single-process part.

``LOCAL`` (no mesh) is the only context the port runs: one process on one
device, MoE by the dense dispatch. A context with a mesh is refused by name
(:func:`require_local`) until distribution is ported (ROADMAP, Queue 1); the
reference's batch and model axes and the sizes read from them come with it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DistContext:
    mesh: object | None = None

    @property
    def enabled(self) -> bool:
        return self.mesh is not None


#: default single-process context (no mesh)
LOCAL = DistContext()


def require_local(dist: DistContext, caller: str) -> None:
    """Raise if ``dist`` carries a mesh, naming the argument, so that it is
    never silently ignored."""
    if dist.enabled:
        raise NotImplementedError(
            f"{caller}() got dist with a mesh, which the port does not take: it "
            f"trains in one process on one device (distribution is not ported)")
