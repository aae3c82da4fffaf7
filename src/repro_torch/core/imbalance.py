"""Deliberate load-imbalance scheduling for serving pools (paper §5.1).

Instead of spreading requests across all n devices (leaving each lightly
loaded and repeatedly exposed to execution-idle), concentrate work onto k
active devices so the remaining n-k sit in *deep idle* (or downscaled
residency). Energy falls because fewer devices pay the execution-idle floor;
latency rises because the active devices queue more work — the paper's
cautionary trade-off (energy → 56%, p95 +80%/+93% for k = 4/2 of 8).

The live scheduler below routes requests; to evaluate k-of-n consolidation
*counterfactually* on recorded fleet telemetry (parked idle at deep-idle
power, a model-reload tax per wake), sweep
:class:`repro_torch.whatif.policies.ParkingPolicy`, which reuses
:meth:`PoolConfig.active_set` for the k-of-n membership.
"""
from __future__ import annotations

import dataclasses
import enum


class PoolPolicy(enum.Enum):
    BALANCED = "balanced"            # join-shortest-queue over all devices
    CONSOLIDATED = "consolidated"    # join-shortest-queue over k active devices


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_devices: int
    policy: PoolPolicy = PoolPolicy.BALANCED
    #: number of devices that receive work under CONSOLIDATED
    n_active: int | None = None
    #: park inactive devices: if True they hold no program (deep idle);
    #: if False they stay resident-but-downscaled (paper's "lightly loaded
    #: and downscaled" variant)
    park_inactive: bool = True
    #: under CONSOLIDATED with park_inactive=False, route every k-th request
    #: to the parked pool ("lightly loaded"); 0 disables
    spill_every: int = 0

    def active_set(self) -> tuple[int, ...]:
        if self.policy == PoolPolicy.BALANCED:
            return tuple(range(self.n_devices))
        k = self.n_active if self.n_active is not None else self.n_devices
        if not (1 <= k <= self.n_devices):
            raise ValueError(f"n_active={k} out of range for pool of {self.n_devices}")
        return tuple(range(k))


class ImbalanceScheduler:
    """Stateless-policy, stateful-load request router.

    ``outstanding`` tracks queued + running work per device (in arbitrary
    work units, e.g. predicted decode tokens); routing is join-shortest-
    outstanding-work within the allowed active set.
    """

    def __init__(self, config: PoolConfig):
        self.config = config
        self._active = config.active_set()
        self.outstanding = [0.0] * config.n_devices
        self.routed = [0] * config.n_devices
        self._count = 0

    def route(self, work_units: float = 1.0) -> int:
        """Pick a device for a new request and account its work."""
        self._count += 1
        pool = self._active
        inactive = self.inactive_devices()
        if (self.config.spill_every and inactive
                and not self.config.park_inactive
                and self._count % self.config.spill_every == 0):
            pool = inactive                       # light traffic to parked set
        device = min(pool, key=lambda d: self.outstanding[d])
        self.outstanding[device] += work_units
        self.routed[device] += 1
        return device

    def complete(self, device: int, work_units: float = 1.0) -> None:
        self.outstanding[device] = max(0.0, self.outstanding[device] - work_units)

    def is_active(self, device: int) -> bool:
        return device in self._active

    def inactive_devices(self) -> tuple[int, ...]:
        return tuple(d for d in range(self.config.n_devices) if d not in self._active)


def downscale_pool_configs(n_devices: int = 8) -> list[PoolConfig]:
    """The three §5.1 experiment cases on an 8-device pool."""
    return [
        PoolConfig(n_devices=n_devices, policy=PoolPolicy.BALANCED),
        PoolConfig(n_devices=n_devices, policy=PoolPolicy.CONSOLIDATED, n_active=4,
                   park_inactive=False),
        PoolConfig(n_devices=n_devices, policy=PoolPolicy.CONSOLIDATED, n_active=2,
                   park_inactive=False),
    ]
