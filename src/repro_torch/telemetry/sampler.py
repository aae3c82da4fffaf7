"""First-party runtime telemetry sampler.

On GPUs the paper polls NVML/DCGM passively. In this framework the runtime
*is* ours, so the trainer/server push activity deltas into a
:class:`RuntimeSampler`, which integrates them into per-second Table-1 rows.
This realizes the paper's §6 "workload-power interface": the workload reports
its own phase structure instead of the power layer inferring it.

Usage (serving loop):

    sampler = RuntimeSampler(device=SimulatedDevice(H100), job_id=7)
    ...
    with sampler.phase("decode", compute_util=0.5, hbm_util=0.9):
        logits = decode(...)
        torch.cuda.synchronize()         # the phase must cover the card's time
    sampler.idle(1.0)

The sampler emits one row per elapsed second with activity = the utilization
of whatever phase covered that second (fractional seconds are blended).
``phase`` times the host's wall clock, and CUDA launches return before the
work is done, so a caller on the card synchronizes before the phase ends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np

from repro_torch.core.power_model import SimulatedDevice
from repro_torch.telemetry.records import TelemetryFrame


@dataclasses.dataclass
class _PhaseAccum:
    """Per-second accumulators (time-weighted activity within the second)."""

    busy_s: float = 0.0
    sm: float = 0.0
    tensor: float = 0.0
    dram: float = 0.0
    ici_tx: float = 0.0
    ici_rx: float = 0.0
    pcie_rx: float = 0.0
    nic_rx: float = 0.0
    cpu: float = 0.0


class RuntimeSampler:
    """Integrates runtime-reported phases into 1 Hz telemetry rows."""

    def __init__(
        self,
        device: SimulatedDevice,
        job_id: int = 0,
        device_id: int = 0,
        hostname: int = 0,
        platform_id: int = 0,
    ):
        self.device = device
        self.job_id = job_id
        self.device_id = device_id
        self.hostname = hostname
        self.platform_id = platform_id
        self._now = 0.0
        self._sec_start = self._now
        self._accum = _PhaseAccum()
        self._rows: list[dict[str, object]] = []
        self._last: dict[str, object] | None = None
        self.resident = False

    # ------------------------------------------------------------------ #
    @property
    def now(self) -> float:
        return self._now

    def load_program(self) -> None:
        self.resident = True

    def unload_program(self) -> None:
        self.resident = False

    def _flush_second(self) -> None:
        a = self._accum
        sm_pct = 100.0 * a.sm
        row = {
            "timestamp": self._sec_start,
            "hostname": self.hostname,
            "device_id": self.device_id,
            "platform": self.platform_id,
            "job_id": self.job_id,
            "program_resident": int(self.resident),
            "sm": sm_pct,
            "tensor": 100.0 * a.tensor,
            "dram": 100.0 * a.dram,
            "fp16": np.nan, "fp32": np.nan, "fp64": np.nan,
            "ici_tx": a.ici_tx, "ici_rx": a.ici_rx,
            "pcie_tx": 0.0, "pcie_rx": a.pcie_rx,
            "nvlink_tx": np.nan, "nvlink_rx": np.nan,
            "nic_tx": 0.0, "nic_rx": a.nic_rx,
            "cpu_util": 100.0 * a.cpu,
            "host_mem_util": 0.0,
            "power": self.device.power_w(self._sec_start, a.sm, self.resident),
            "sm_clk": self.device.platform.sm_clk_mhz[int(self.device.clocks()[0])],
            "mem_clk": self.device.platform.mem_clk_mhz[int(self.device.clocks()[1])],
        }
        self._rows.append(row)
        self._last = row
        self._accum = _PhaseAccum()
        self._sec_start += 1.0

    def _advance(self, duration_s: float, **activity: float) -> None:
        """Advance simulated time, spreading `activity` over covered seconds."""
        remaining = duration_s
        while remaining > 0:
            sec_end = self._sec_start + 1.0
            chunk = min(remaining, sec_end - self._now)
            frac = chunk  # fraction of the current second
            a = self._accum
            a.busy_s += frac if activity.get("compute_util", 0.0) > 0 else 0.0
            a.sm += frac * activity.get("compute_util", 0.0)
            a.tensor += frac * activity.get("tensor_util",
                                            activity.get("compute_util", 0.0))
            a.dram += frac * activity.get("hbm_util", 0.0)
            a.ici_tx += frac * activity.get("ici_gbs", 0.0)
            a.ici_rx += frac * activity.get("ici_gbs", 0.0)
            a.pcie_rx += frac * activity.get("pcie_gbs", 0.0)
            a.nic_rx += frac * activity.get("nic_gbs", 0.0)
            a.cpu += frac * activity.get("cpu_util", 0.0)
            self._now += chunk
            remaining -= chunk
            if self._now >= sec_end - 1e-12:
                self._flush_second()

    # ------------------------------------------------------------------ #
    # Public phase API
    # ------------------------------------------------------------------ #
    def busy(self, duration_s: float, compute_util: float = 0.9,
             hbm_util: float = 0.5, ici_gbs: float = 0.0,
             pcie_gbs: float = 0.0, nic_gbs: float = 0.0,
             cpu_util: float = 0.3) -> None:
        """Record a busy phase of known duration (simulated time)."""
        self._advance(duration_s, compute_util=compute_util, hbm_util=hbm_util,
                      ici_gbs=ici_gbs, pcie_gbs=pcie_gbs, nic_gbs=nic_gbs,
                      cpu_util=cpu_util)

    def idle(self, duration_s: float, pcie_gbs: float = 0.0,
             nic_gbs: float = 0.0, cpu_util: float = 0.02) -> None:
        """Record a loaded-but-inactive phase (the execution-idle producer)."""
        self._advance(duration_s, compute_util=0.0, hbm_util=0.0,
                      pcie_gbs=pcie_gbs, nic_gbs=nic_gbs, cpu_util=cpu_util)

    @contextlib.contextmanager
    def phase(self, name: str, compute_util: float = 0.9, hbm_util: float = 0.5,
              ici_gbs: float = 0.0) -> Iterator[None]:
        """Wall-clock-measured busy phase (live runs)."""
        t0 = time.monotonic()
        yield
        self.busy(time.monotonic() - t0, compute_util=compute_util,
                  hbm_util=hbm_util, ici_gbs=ici_gbs)

    # ------------------------------------------------------------------ #
    def last_row(self) -> dict[str, object] | None:
        """Most recent emitted Table-1 row, or None before the first flush.

        O(1) — controllers polling every tick must not rebuild the whole
        frame just to read the newest sample. Survives :meth:`drain`, so a
        periodically drained engine's controller keeps seeing its last
        sample.
        """
        return dict(self._last) if self._last is not None else None

    def frame(self) -> TelemetryFrame:
        return TelemetryFrame.from_rows(self._rows)

    def drain(self) -> TelemetryFrame:
        frame = self.frame()
        self._rows = []
        return frame

    def drain_to(self, store, host: str = "host0",
                 flush_manifest: bool = True) -> int:
        """Drain buffered rows into a :class:`TelemetryStore` shard.

        Long replays call this periodically so telemetry goes straight to
        storage shards (in time order, ready for the streaming analysis and
        what-if paths) instead of accumulating the whole run in memory.
        Returns the number of rows drained; an empty buffer appends nothing.
        """
        n = len(self._rows)
        store.append(self.drain(), host=host, flush_manifest=flush_manifest)
        return n
