"""Algorithm 1 — Execution-Idle-Aware Frequency Control (paper §5.3).

Faithful transcription of the paper's controller:

    Require: threshold X, cooldown Y, clocks f_max, f_min
    c <- 0, t_cooldown <- 0, downscaled <- false
    for each eps-second control interval at time t:
        read sm, tensor, fp16, dram, pcie, nvlink, ...
        a_comp <- max(sm, tensor, fp16, ...)
        a_mem  <- dram
        a_comm <- max(pcie, nvlink)
        if a_comp < 0.05 and a_mem < 0.05 and a_comm < 1 GB/s:
            c <- c + 1
        else:
            c <- 0
            if downscaled:
                set GPU clock to f_max; downscaled <- false
                t_cooldown <- t + Y
        if c > X and t >= t_cooldown and not downscaled:
            set GPU clock to f_min; downscaled <- true

Paper defaults: X = 3 s trigger, Y = 5 s cooldown, eps = 1 s.
Two downscale modes per §5.3: compute clock only, or compute + memory clocks.

A copy of the JAX package's controller (it holds no JAX): the serving
engine of this package drives it once per tick, and the tests hold its
decisions and statistics to the original's exactly.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping

from repro_torch.core.power_model import ClockActuator, ClockLevel
from repro_torch.core.states import COMMUNICATION_SIGNALS, COMPUTE_SIGNALS


class DownscaleMode(enum.Enum):
    SM_ONLY = "sm_only"
    SM_AND_MEM = "sm_and_mem"


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    threshold_x_s: float = 3.0       # consecutive low-activity seconds before downscale
    cooldown_y_s: float = 5.0        # hold f_max after resume to avoid oscillation
    interval_eps_s: float = 1.0      # control interval
    activity_threshold: float = 0.05  # fraction (5%)
    comm_threshold_gbs: float = 1.0
    mode: DownscaleMode = DownscaleMode.SM_ONLY


@dataclasses.dataclass
class ControllerStats:
    downscale_events: int = 0
    restore_events: int = 0
    downscaled_time_s: float = 0.0
    control_steps: int = 0


class ExecutionIdleController:
    """Stateful per-device controller driving a :class:`ClockActuator`."""

    def __init__(self, actuator: ClockActuator, config: ControllerConfig | None = None):
        self.actuator = actuator
        self.config = config or ControllerConfig()
        self._c = 0.0              # consecutive low-activity time (s)
        self._t_cooldown = 0.0
        self._downscaled = False
        self.stats = ControllerStats()

    # ------------------------------------------------------------------ #
    @property
    def downscaled(self) -> bool:
        return self._downscaled

    def _low_activity(self, sample: Mapping[str, float]) -> bool:
        cfg = self.config
        a_comp = max((float(sample.get(k, 0.0) or 0.0)
                      for k in COMPUTE_SIGNALS), default=0.0)
        a_mem = float(sample.get("dram", 0.0) or 0.0)
        a_comm = max((float(sample.get(k, 0.0) or 0.0)
                      for k in COMMUNICATION_SIGNALS), default=0.0)
        # activity signals here are fractions in [0,1] to match Algorithm 1's
        # "< 0.05"; telemetry records store percent, callers divide by 100.
        return (
            a_comp < cfg.activity_threshold
            and a_mem < cfg.activity_threshold
            and a_comm < cfg.comm_threshold_gbs
        )

    def _min_clocks(self) -> tuple[ClockLevel, ClockLevel]:
        if self.config.mode == DownscaleMode.SM_AND_MEM:
            return ClockLevel.MIN, ClockLevel.MIN
        return ClockLevel.MIN, ClockLevel.MAX

    # ------------------------------------------------------------------ #
    def step(self, t_s: float, sample: Mapping[str, float]) -> bool:
        """One eps-second control interval. Returns True iff downscaled after
        this step. ``sample`` holds activity fractions + comm GB/s."""
        cfg = self.config
        self.stats.control_steps += 1

        if self._low_activity(sample):
            self._c += cfg.interval_eps_s
        else:
            self._c = 0.0
            if self._downscaled:
                self.actuator.set_clocks(t_s, ClockLevel.MAX, ClockLevel.MAX)
                self._downscaled = False
                self.stats.restore_events += 1
                self._t_cooldown = t_s + cfg.cooldown_y_s

        if self._c > cfg.threshold_x_s and t_s >= self._t_cooldown and not self._downscaled:
            sm, mem = self._min_clocks()
            self.actuator.set_clocks(t_s, sm, mem)
            self._downscaled = True
            self.stats.downscale_events += 1

        if self._downscaled:
            self.stats.downscaled_time_s += cfg.interval_eps_s
        return self._downscaled
