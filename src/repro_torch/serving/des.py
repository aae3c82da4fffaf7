"""Discrete-event serving-pool simulator (tick-based, 1 Hz telemetry out).

Runs the *same* scheduler (core.imbalance) and controller (core.controller,
Algorithm 1) code as the live engine, against a request trace and a
perf/power model — this is how the §5.1 and §5.3 experiments and the trace
replays (§2.3) execute at pool scale. It is NumPy and Python on the host; a
copy of the JAX package's simulator, float for float (its energies,
latencies and telemetry equal the original's exactly). Its spilled
telemetry is priced on the card by ``whatif.run_sweep``.

Model per device: work-conserving FIFO processor. Busy/idle structure (and
therefore energy) is exact for any work-conserving discipline (vLLM's
continuous batching included); individual latencies are FIFO-approximate.
The fine tick (default 0.1 s) resolves sub-second latencies; telemetry is
emitted at 1 Hz like the paper's pipeline.

Controller interplay: while downscaled, service progresses at
``platform.perf_scale(f_min)``; a clock switch stalls the device for the
measured 1-500 ms switch latency [52] — both produce the latency penalties
of Figs 10/12.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.controller import (ControllerConfig, DownscaleMode,
                                         ExecutionIdleController)
from repro_torch.core.imbalance import ImbalanceScheduler, PoolConfig
from repro_torch.core.power_model import ClockLevel, PlatformSpec, SimulatedDevice
from repro_torch.serving.latency import LatencyStats, Request
from repro_torch.serving.perf_model import PerfModel
from repro_torch.telemetry.records import TelemetryFrame


@dataclasses.dataclass
class DeviceSim:
    device: SimulatedDevice
    resident: bool = True
    queue: list = dataclasses.field(default_factory=list)   # FIFO of requests
    current: Request | None = None
    remaining_work_s: float = 0.0
    busy_acc: float = 0.0       # busy seconds within current telemetry second
    util_acc: float = 0.0
    #: the previous completed 1 Hz sample — the controller reads DCGM-style
    #: windowed counters, i.e. it reacts one full second late
    prev_sample: dict = dataclasses.field(
        default_factory=lambda: {"sm": 0.0, "dram": 0.0, "pcie_rx": 0.0})


@dataclasses.dataclass
class PoolResult:
    requests: list[Request]
    latency: LatencyStats
    telemetry: TelemetryFrame
    energy_j: float
    avg_power_w: float
    busy_fraction: float        # fraction of device-seconds with any work
    exec_idle_time_fraction: float   # resident & no work (replay accounting)
    exec_idle_energy_fraction: float
    avg_sm_util: float


def simulate_pool(
    trace: list[Request],
    platform: PlatformSpec,
    perf: PerfModel,
    pool: PoolConfig,
    duration_s: float,
    controller_cfg: ControllerConfig | None = None,
    tick_s: float = 0.1,
    downscale_inactive: bool = False,
    store=None,
    host: str = "host0",
    drain_every_s: float = 3600.0,
) -> PoolResult:
    """Replay ``trace`` on a device pool. Requests must be sorted by arrival.

    With ``store`` (a :class:`~repro_torch.telemetry.storage.TelemetryStore`) the
    accumulated 1 Hz rows spill into a shard every ``drain_every_s`` of
    simulated time (plus once at the end), so day-scale replays never
    materialize the full telemetry frame; ``PoolResult.telemetry`` is then
    empty — stream the store through ``analyze_store`` / ``run_sweep``
    instead. Each spill covers a contiguous time window over all devices, so
    shards arrive in the per-stream time order the streaming readers require.
    """
    n = pool.n_devices
    devices = [DeviceSim(device=SimulatedDevice(platform, switch_latency_s=0.4))
               for _ in range(n)]
    scheduler = ImbalanceScheduler(pool)
    controllers: dict[int, ExecutionIdleController] = {}
    if controller_cfg:
        for d_idx, d in enumerate(devices):
            if scheduler.is_active(d_idx):
                controllers[d_idx] = ExecutionIdleController(d.device, controller_cfg)

    # inactive devices under consolidation: parked deep-idle, or downscaled
    # with their own Algorithm-1 controller so spilled "light" traffic wakes
    # them (the paper's "lightly loaded and downscaled" pool, §5.1)
    for d_idx in scheduler.inactive_devices():
        if pool.park_inactive:
            devices[d_idx].resident = False
        else:
            devices[d_idx].device.set_clocks(0.0, ClockLevel.MIN, ClockLevel.MIN)
            parked_cfg = ControllerConfig(mode=DownscaleMode.SM_AND_MEM)
            ctl = ExecutionIdleController(devices[d_idx].device, parked_cfg)
            ctl._downscaled = True          # starts parked
            controllers[d_idx] = ctl

    # pre-compute service work (seconds at full clock)
    for r in trace:
        r.device = -1

    trace = sorted(trace, key=lambda r: r.arrival_s)
    next_arrival = 0
    t = 0.0
    ticks_per_second = max(1, round(1.0 / tick_s))
    rows: list[dict] = []
    busy_device_seconds = 0.0
    total_device_seconds = 0.0
    energy_j = 0.0
    exec_idle_s = 0.0
    exec_idle_j = 0.0
    active_j = 0.0
    active_s = 0.0
    sm_sum = 0.0

    n_ticks = int(round(duration_s / tick_s))
    for tick in range(n_ticks):
        t = tick * tick_s
        # arrivals
        while next_arrival < len(trace) and trace[next_arrival].arrival_s <= t:
            r = trace[next_arrival]
            d_idx = scheduler.route(perf.service_time_s(r.prompt_tokens,
                                                        r.output_tokens))
            r.device = d_idx
            devices[d_idx].queue.append(r)
            next_arrival += 1

        # progress work
        for d_idx, dev in enumerate(devices):
            if dev.current is None and dev.queue:
                dev.current = dev.queue.pop(0)
                dev.current.start_s = t
                dev.remaining_work_s = perf.service_time_s(
                    dev.current.prompt_tokens, dev.current.output_tokens)
            busy = 0.0
            if dev.current is not None:
                rate = dev.device.perf_scale(t, compute_bound_fraction=0.3)
                progress = rate * tick_s
                dev.remaining_work_s -= progress
                busy = tick_s
                if dev.remaining_work_s <= 0:
                    dev.current.finish_s = t + tick_s
                    scheduler.complete(d_idx, 0.0)
                    dev.current = None
            dev.busy_acc += busy
            dev.util_acc += (perf.busy_util if busy > 0 else 0.0) * tick_s

        # 1 Hz boundary: telemetry + controller
        if (tick + 1) % ticks_per_second == 0:
            sec = int(t) + 1
            for d_idx, dev in enumerate(devices):
                util = dev.util_acc  # time-weighted within the second
                sm_frac = dev.busy_acc * perf.busy_util
                power = dev.device.power_w(t, util, resident=dev.resident)
                energy_j += power
                total_device_seconds += 1.0
                if dev.busy_acc > 0:
                    busy_device_seconds += 1.0
                sm_sum += sm_frac
                is_exec_idle = dev.resident and dev.busy_acc == 0.0
                if is_exec_idle:
                    exec_idle_s += 1.0
                    exec_idle_j += power
                elif dev.resident:
                    active_s += 1.0
                    active_j += power
                rows.append({
                    "timestamp": float(sec),
                    "device_id": d_idx,
                    "job_id": 1,
                    "program_resident": int(dev.resident),
                    "sm": 100.0 * sm_frac,
                    "tensor": 100.0 * sm_frac,
                    "dram": 100.0 * min(1.0, dev.busy_acc * 0.9),
                    "power": power,
                    "pcie_rx": 0.0, "pcie_tx": 0.0,
                    "nic_rx": 0.0, "nic_tx": 0.0,
                    "cpu_util": 20.0 if dev.busy_acc > 0 else 2.0,
                    "host_mem_util": 30.0,
                    "sm_clk": dev.device.platform.sm_clk_mhz[int(dev.device.clocks()[0])],
                    "mem_clk": dev.device.platform.mem_clk_mhz[int(dev.device.clocks()[1])],
                })
                if d_idx in controllers and dev.resident:
                    controllers[d_idx].step(t, dev.prev_sample)
                dev.prev_sample = {"sm": sm_frac,
                                   "dram": min(1.0, dev.busy_acc * 0.9),
                                   "pcie_rx": 0.0}
                dev.busy_acc = 0.0
                dev.util_acc = 0.0
            if store is not None and sec % max(int(drain_every_s), 1) == 0:
                store.append(TelemetryFrame.from_rows(rows), host=host,
                             flush_manifest=False)
                rows.clear()

    if store is not None:
        store.append(TelemetryFrame.from_rows(rows), host=host,
                     flush_manifest=False)
        store.save_manifest()
        rows.clear()
    frame = TelemetryFrame.from_rows(rows)
    in_exec_s = exec_idle_s + active_s
    in_exec_j = exec_idle_j + active_j
    return PoolResult(
        requests=trace,
        latency=LatencyStats.of(trace),
        telemetry=frame,
        energy_j=energy_j,
        avg_power_w=energy_j / max(total_device_seconds, 1.0),
        busy_fraction=busy_device_seconds / max(total_device_seconds, 1.0),
        exec_idle_time_fraction=exec_idle_s / max(in_exec_s, 1.0),
        exec_idle_energy_fraction=exec_idle_j / max(in_exec_j, 1e-9),
        avg_sm_util=sm_sum / max(total_device_seconds, 1.0),
    )
