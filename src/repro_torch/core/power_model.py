"""Platform power models and a simulated DVFS actuator.

Two roles:

1. **Replication** — per-platform power tables calibrated from the paper
   (Table 4 power limits; Fig 2/4 deep-idle vs execution-idle gaps; §5.3
   downscaled powers on L40S; §4.4 kWh anchors on B200/L40S).
2. **Runtime model** — the serving engine's simulated device. The actuator
   here is a *model* (with the 1–500 ms frequency-switch latency of Velicka
   et al. [52]); the controller (Algorithm 1) is written against the
   ``ClockActuator`` protocol so a real actuator can be substituted on
   hardware that has one.

The platform table is the JAX package's, row for row, so telemetry from
either package prices the same.

Power decomposition (per platform, program resident):

    P(util, f_sm, f_mem) = P_residency(f_sm, f_mem) + util_term(util, f_sm)

``P_residency`` is the loaded-but-inactive floor — the execution-idle power —
and is what frequency downscaling attacks. ``util_term`` scales with visible
activity and compute-clock, saturating at (tdp − residency_floor).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Protocol

import numpy as np


class ClockLevel(enum.IntEnum):
    MIN = 0
    MAX = 1


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """One accelerator platform's power/perf envelope."""

    name: str
    tdp_w: float
    deep_idle_w: float
    #: residency floor at (f_max, f_max) — the paper's execution-idle power
    exec_idle_w: float
    #: residency floor with compute clock at min, memory clock at max (§5.3)
    exec_idle_sm_min_w: float
    #: residency floor with both clocks at min (§5.3: reaches deep-idle power)
    exec_idle_all_min_w: float
    #: compute clock range, MHz (for reporting; power interpolates on level)
    sm_clk_mhz: tuple[float, float] = (210.0, 2520.0)
    mem_clk_mhz: tuple[float, float] = (405.0, 9001.0)
    #: perf multiplier at f_min for compute-bound work (throughput ratio;
    #: ~210/2520 MHz with some latency hiding)
    perf_at_min_compute: float = 0.15
    #: perf multiplier at f_min-memory for memory-bound work (~405/9001 MHz
    #: effective bandwidth ratio; LLM decode is memory-bound, so this is the
    #: §5.3 SM+mem latency cliff)
    perf_at_min_memory: float = 0.09
    #: roofline terms (the H100's, which the port's dry-run uses, and the TPU's)
    peak_bf16_tflops: float | None = None
    hbm_gbps: float | None = None
    ici_gbps_per_link: float | None = None
    hbm_capacity_gib: float | None = None

    def residency_floor_w(self, sm: ClockLevel, mem: ClockLevel) -> float:
        if sm == ClockLevel.MAX and mem == ClockLevel.MAX:
            return self.exec_idle_w
        if sm == ClockLevel.MIN and mem == ClockLevel.MAX:
            return self.exec_idle_sm_min_w
        if sm == ClockLevel.MIN and mem == ClockLevel.MIN:
            return self.exec_idle_all_min_w
        # mem-only downscale: between the sm-only and all-min floors
        return 0.5 * (self.exec_idle_w + self.exec_idle_all_min_w)

    def power_w(
        self,
        util: float,
        sm: ClockLevel = ClockLevel.MAX,
        mem: ClockLevel = ClockLevel.MAX,
        resident: bool = True,
    ) -> float:
        """Board power for a given utilization in [0, 1] and clock levels."""
        if not resident:
            return self.deep_idle_w
        floor = self.residency_floor_w(sm, mem)
        headroom = max(self.tdp_w - self.exec_idle_w, 0.0)
        # active power scales with util; at reduced compute clock both the
        # achievable util-term and its ceiling shrink (cubic-ish f–V scaling
        # approximated with the measured perf_at_min_compute ratio).
        clock_scale = 1.0 if sm == ClockLevel.MAX else self.perf_at_min_compute
        util = float(np.clip(util, 0.0, 1.0))
        # sub-linear power-vs-util (activity counters saturate before power):
        return floor + headroom * clock_scale * util ** 0.9

    def perf_scale(
        self,
        sm: ClockLevel,
        mem: ClockLevel,
        compute_bound_fraction: float = 0.7,
    ) -> float:
        """Throughput multiplier under the given clocks, for a workload that
        is ``compute_bound_fraction`` compute-bound and the rest memory-bound.
        """
        c = 1.0 if sm == ClockLevel.MAX else self.perf_at_min_compute
        m = 1.0 if mem == ClockLevel.MAX else self.perf_at_min_memory
        return 1.0 / (compute_bound_fraction / c + (1.0 - compute_bound_fraction) / m)


# --------------------------------------------------------------------------- #
# Platform registry.
#
# GPU rows: TDP from paper Table 4. L40S floors from §5.3 (105→61→35 W) and
# Fig 2 (deep idle ≈35 W). B200 execution-idle anchored by the paper's 44 s =
# 0.00267 kWh example (≈218 W). Other platforms scaled by TDP class with the
# consistent qualitative gap of Fig 4 (exec-idle ≫ deep-idle on every model).
# --------------------------------------------------------------------------- #
PLATFORMS: dict[str, PlatformSpec] = {}


def _register(spec: PlatformSpec) -> PlatformSpec:
    PLATFORMS[spec.name] = spec
    return spec


L40S = _register(PlatformSpec(
    name="l40s", tdp_w=400.0, deep_idle_w=35.0,
    exec_idle_w=105.0, exec_idle_sm_min_w=61.0, exec_idle_all_min_w=35.0,
))
A6000 = _register(PlatformSpec(
    name="a6000", tdp_w=300.0, deep_idle_w=22.0,
    exec_idle_w=78.0, exec_idle_sm_min_w=48.0, exec_idle_all_min_w=24.0,
))
RTX6000ADA = _register(PlatformSpec(
    name="rtx6000ada", tdp_w=300.0, deep_idle_w=25.0,
    exec_idle_w=82.0, exec_idle_sm_min_w=50.0, exec_idle_all_min_w=27.0,
))
L40 = _register(PlatformSpec(
    name="l40", tdp_w=300.0, deep_idle_w=30.0,
    exec_idle_w=90.0, exec_idle_sm_min_w=55.0, exec_idle_all_min_w=31.0,
))
A100 = _register(PlatformSpec(
    name="a100", tdp_w=400.0, deep_idle_w=52.0,
    exec_idle_w=120.0, exec_idle_sm_min_w=75.0, exec_idle_all_min_w=55.0,
))
#: peak terms from NVIDIA's H100 SXM data sheet (dense bf16, HBM3, NVLink 4
#: a direction), as ``roofline/analysis.py`` takes them
H100 = _register(PlatformSpec(
    name="h100", tdp_w=700.0, deep_idle_w=70.0,
    exec_idle_w=165.0, exec_idle_sm_min_w=100.0, exec_idle_all_min_w=74.0,
    peak_bf16_tflops=989.0, hbm_gbps=3350.0, ici_gbps_per_link=450.0,
    hbm_capacity_gib=80.0 * 1e9 / 2**30,
))
B200 = _register(PlatformSpec(
    name="b200", tdp_w=1000.0, deep_idle_w=130.0,
    exec_idle_w=218.0, exec_idle_sm_min_w=160.0, exec_idle_all_min_w=135.0,
))

#: TPU-v5e-class platform for the framework's own runtime and roofline math.
#: Peak 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI (assignment spec).
#: Power envelope modeled (no public per-state figures): residency floor
#: chosen to preserve the paper's qualitative exec-idle ≫ deep-idle gap.
TPU_V5E = _register(PlatformSpec(
    name="tpu_v5e", tdp_w=250.0, deep_idle_w=55.0,
    exec_idle_w=140.0, exec_idle_sm_min_w=90.0, exec_idle_all_min_w=60.0,
    sm_clk_mhz=(400.0, 1700.0), mem_clk_mhz=(600.0, 3200.0),
    peak_bf16_tflops=197.0, hbm_gbps=819.0, ici_gbps_per_link=50.0,
    hbm_capacity_gib=16.0,
))


def get_platform(name: str) -> PlatformSpec:
    try:
        return PLATFORMS[name]
    except KeyError:
        raise KeyError(f"unknown platform {name!r}; known: {sorted(PLATFORMS)}") from None


# --------------------------------------------------------------------------- #
# Actuator protocol + simulated DVFS device.
# --------------------------------------------------------------------------- #
class ClockActuator(Protocol):
    """What Algorithm 1 needs from the platform: set/restore clocks."""

    def set_clocks(self, t_s: float, sm: ClockLevel, mem: ClockLevel) -> None: ...
    def clocks(self) -> tuple[ClockLevel, ClockLevel]: ...


@dataclasses.dataclass
class SimulatedDevice:
    """A DVFS-capable device simulation with frequency-switch latency.

    Velicka et al. [52] measure 1–500 ms per switch; during the switch the
    device stalls (no useful progress), which is how downscaling converts
    into the latency penalty the paper reports.
    """

    platform: PlatformSpec
    switch_latency_s: float = 0.2
    _sm: ClockLevel = ClockLevel.MAX
    _mem: ClockLevel = ClockLevel.MAX
    _switch_done_t: float = 0.0
    switch_count: int = 0

    def set_clocks(self, t_s: float, sm: ClockLevel, mem: ClockLevel) -> None:
        if (sm, mem) == (self._sm, self._mem):
            return
        self._sm, self._mem = sm, mem
        self._switch_done_t = t_s + self.switch_latency_s
        self.switch_count += 1

    def clocks(self) -> tuple[ClockLevel, ClockLevel]:
        return self._sm, self._mem

    def switching(self, t_s: float) -> bool:
        return t_s < self._switch_done_t

    def power_w(self, t_s: float, util: float, resident: bool = True) -> float:
        return self.platform.power_w(util, self._sm, self._mem, resident)

    def perf_scale(self, t_s: float, compute_bound_fraction: float = 0.7) -> float:
        if self.switching(t_s):
            return 0.0  # stalled mid-switch
        return self.platform.perf_scale(self._sm, self._mem, compute_bound_fraction)
