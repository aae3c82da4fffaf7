"""Academic-cluster telemetry simulator (the §2.1 deployment, regenerated).

Assembles per-device 1 Hz telemetry streams: unallocated gaps, then jobs
(class-sampled via cluster.jobgen), on a fleet whose platform mix follows the
paper's Table 4. The output TelemetryFrame feeds the SAME analysis pipeline
(telemetry.pipeline / core.*) a real deployment would use — the simulator
exists because the raw 162 GB dataset cannot ship; the pipeline is the
deliverable (DESIGN.md §7, note 4).

Vectorized phase-block assembly: each phase contributes constant blocks +
noise, so a day x 40 devices generates in seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster import jobgen
from repro_torch.core.power_model import PLATFORMS, PlatformSpec
from repro_torch.telemetry.records import FIELDS, TelemetryFrame, _DTYPES
from repro_torch.telemetry.storage import TelemetryStore

#: fleet platform mix (paper Table 4, profiled subset, normalized)
FLEET_MIX: tuple[tuple[str, float], ...] = (
    ("l40s", 0.54), ("a6000", 0.26), ("rtx6000ada", 0.07),
    ("l40", 0.0), ("a100", 0.085), ("h100", 0.032), ("b200", 0.013),
)

PLATFORM_IDS = {name: i for i, (name, _) in enumerate(FLEET_MIX)}


@dataclasses.dataclass
class ClusterSample:
    frame: TelemetryFrame
    job_classes: dict[int, str]       # job_id -> workload class
    job_platforms: dict[int, str]


def _noise(rng, n, scale):
    return rng.normal(0.0, scale, n)


def _noise_block(rng, n, scales):
    """One ``rng.normal`` draw covering several equal-length noise fields.

    ``Generator.normal`` with an array scale consumes the underlying
    bitstream element by element, exactly like the equivalent sequence of
    per-field ``normal(0, scale, n)`` calls — so collapsing a phase's
    per-field draws into one block keeps every seeded output bit-identical
    (tests/test_telemetry.py) while paying the generator dispatch once per
    phase instead of once per field.
    """
    flat = rng.normal(0.0, np.repeat(scales, n))
    return [flat[i * n:(i + 1) * n] for i in range(len(scales))]


def _phase_signals(rng, phase: jobgen.Phase, plat: PlatformSpec, n: int):
    """Column dict for one phase of n seconds."""
    cols = {f: np.zeros(n) for f in
            ("sm", "tensor", "dram", "pcie_rx", "pcie_tx", "nic_rx", "nic_tx",
             "cpu_util", "power")}
    resident = np.ones(n, np.int8)
    nvlink = np.full(n, np.nan) if plat.name not in jobgen.NVLINK_PLATFORMS \
        else np.zeros(n)
    if phase.kind == "deep":
        resident[:] = 0
        power_n, cpu_n = _noise_block(rng, n, (1.0, 2.0))
        cols["power"] = plat.deep_idle_w + power_n
        cols["cpu_util"] = np.clip(5 + cpu_n, 0, 100)
    elif phase.kind == "idle":
        cols["sm"] = np.clip(rng.uniform(0, 2.5, n), 0, 4.9)
        cols["dram"] = np.clip(rng.uniform(0, 2.0, n), 0, 4.9)
        power_n, cpu_n = _noise_block(rng, n, (3.0, 4.0))
        cols["power"] = plat.exec_idle_w + power_n
        cols["cpu_util"] = np.clip(8 + cpu_n, 0, 100)
    else:  # active
        util = phase.util
        sm_n, tensor_n, dram_n, power_n, cpu_n = _noise_block(
            rng, n, (6.0, 6.0, 8.0, 8.0, 8.0))
        cols["sm"] = np.clip(100 * util + sm_n, 6, 100)
        cols["tensor"] = np.clip(85 * util + tensor_n, 0, 100)
        cols["dram"] = np.clip(70 * util + dram_n, 5.5, 100)
        cols["power"] = np.clip(
            plat.power_w(util) + power_n, plat.exec_idle_w, plat.tdp_w)
        cols["cpu_util"] = np.clip(30 + cpu_n, 0, 100)
        # brief (1-4 s) stalls that the 5 s sustain rule excludes but the
        # permissive 1 s setting counts (Table 2's 19.2% -> 23.8% delta)
        # non-overlapping so adjacent dips can never merge into a >=5 s run
        n_dips = int(rng.poisson(max(n - 45, 0) / 28.0)) if n > 45 else 0
        n_slots = max((n - 24) // 10, 1)
        slots = rng.choice(n_slots, size=min(n_dips, n_slots), replace=False)
        for slot in slots:
            start = 8 + int(slot) * 10
            dlen = int(rng.integers(1, 4))
            sl_d = slice(start, start + dlen)
            cols["sm"][sl_d] = rng.uniform(0, 2.0, dlen)
            cols["tensor"][sl_d] = rng.uniform(0, 2.0, dlen)
            cols["dram"][sl_d] = rng.uniform(0, 1.5, dlen)
            cols["power"][sl_d] = plat.exec_idle_w + _noise(rng, dlen, 3.0)
        # cause signature on the trailing window (3-8 s) — §4.5 fingerprints
        tail = min(n, int(rng.integers(4, 10)))
        sl = slice(n - tail, n)
        if phase.cause == "pcie":
            cols["pcie_rx"][sl] = rng.uniform(3.0, 10.0, tail)
            cols["cpu_util"][sl] = np.clip(65 + _noise(rng, tail, 6), 0, 100)
        elif phase.cause == "nic":
            cols["nic_rx"][sl] = rng.uniform(2.5, 7.0, tail)
            cols["cpu_util"][sl] = np.clip(55 + _noise(rng, tail, 6), 0, 100)
        elif phase.cause == "nvlink" and plat.name in jobgen.NVLINK_PLATFORMS:
            nvlink[sl] = rng.uniform(6.0, 25.0, tail)
        # "compute" cause: high sm/dram straight into idle — already the case
    return cols, resident, nvlink


def _materialize(col_lists: dict[str, list[np.ndarray]]) -> dict[str, np.ndarray]:
    """Concatenate per-field piece lists into schema-typed columns; fields a
    platform never emits (e.g. ici_*) become all-NaN / zero columns."""
    n_total = sum(a.shape[0] for a in col_lists["timestamp"])
    columns = {}
    for f in FIELDS:
        if col_lists[f]:
            arr = np.concatenate(col_lists[f])
        else:
            fill = np.nan if _DTYPES[f].startswith("f") else 0
            arr = np.full(n_total, fill)
        columns[f] = arr.astype(_DTYPES[f])
    return columns


def generate_cluster(
    n_devices: int = 24,
    horizon_s: int = 6 * 3600,
    seed: int = 0,
    min_job_s: int = 1800,
    store: TelemetryStore | None = None,
    shard_s: int = 6 * 3600,
) -> ClusterSample:
    """Simulate the §2.1 deployment.

    With ``store=None`` (default) the whole fleet frame is materialized in
    memory, as before. Passing a :class:`TelemetryStore` switches to chunked
    emission: each device's stream is flushed to the store every ``shard_s``
    samples, so peak memory is one shard (+ one phase block) — day-scale x
    hundreds-of-devices fleets generate without building the fleet frame.
    Shards are appended in (device, time) order, i.e. already in the
    per-stream time order ``analyze_store`` requires, and the emitted rows
    are identical to the monolithic frame for the same seed.
    """
    rng = np.random.default_rng(seed)
    names = [n for n, _ in FLEET_MIX]
    probs = np.array([p for _, p in FLEET_MIX])
    probs = probs / probs.sum()

    all_cols: dict[str, list[np.ndarray]] = {f: [] for f in FIELDS}
    job_classes: dict[int, str] = {}
    job_platforms: dict[int, str] = {}
    job_id = 0

    for dev in range(n_devices):
        plat = PLATFORMS[str(rng.choice(names, p=probs))]
        t = 0
        dev_cols: dict[str, list[np.ndarray]] = {f: [] for f in FIELDS}
        buffered = 0

        def flush(force: bool = False):
            """Chunked emission: spill the device buffer into <=shard_s-row
            shards; a sub-shard remainder stays buffered unless forced."""
            nonlocal buffered
            if store is None or buffered == 0 or (buffered < shard_s and not force):
                return
            cols = _materialize(dev_cols)
            start = 0
            while buffered - start >= shard_s or (force and start < buffered):
                end = min(start + shard_s, buffered)
                store.write_shard(
                    TelemetryFrame({k: v[start:end] for k, v in cols.items()}),
                    host=f"h{dev // 4}",
                    day=int(cols["timestamp"][start]) // 86400,
                    flush_manifest=False)
                start = end
            for f in FIELDS:
                dev_cols[f][:] = [cols[f][start:]] if start < buffered else []
            buffered -= start

        def emit(cols, resident, nvlink, n, jid):
            nonlocal buffered
            buffered += n
            ts = np.arange(t, t + n, dtype=np.float64)
            dev_cols["timestamp"].append(ts)
            dev_cols["hostname"].append(np.full(n, dev // 4, np.int32))
            dev_cols["device_id"].append(np.full(n, dev, np.int32))
            dev_cols["platform"].append(
                np.full(n, PLATFORM_IDS.get(plat.name, 0), np.int32))
            dev_cols["job_id"].append(np.full(n, jid, np.int64))
            dev_cols["program_resident"].append(resident)
            for f in ("sm", "tensor", "dram", "pcie_rx", "pcie_tx",
                      "nic_rx", "nic_tx", "cpu_util", "power"):
                dev_cols[f].append(cols[f])
            dev_cols["nvlink_tx"].append(nvlink)
            dev_cols["nvlink_rx"].append(nvlink.copy())
            for f in ("fp16", "fp32", "fp64", "ici_tx", "ici_rx"):
                dev_cols[f].append(np.full(n, np.nan))
            dev_cols["host_mem_util"].append(np.full(n, 35.0))
            dev_cols["sm_clk"].append(np.full(n, plat.sm_clk_mhz[1]))
            dev_cols["mem_clk"].append(np.full(n, plat.mem_clk_mhz[1]))

        while t < horizon_s:
            # unallocated gap (deep idle, no job)
            gap = int(rng.lognormal(np.log(600), 0.8))
            gap = min(gap, horizon_s - t)
            if gap > 0:
                n = gap
                cols = {f: np.zeros(n) for f in
                        ("sm", "tensor", "dram", "pcie_rx", "pcie_tx",
                         "nic_rx", "nic_tx", "cpu_util", "power")}
                cols["power"] = plat.deep_idle_w + rng.normal(0, 1, n)
                nv = (np.full(n, np.nan)
                      if plat.name not in jobgen.NVLINK_PLATFORMS else np.zeros(n))
                emit(cols, np.zeros(n, np.int8), nv, n, -1)
                t += n
                flush()
            if t >= horizon_s:
                break

            klass = jobgen.sample_class(rng)
            phases, duration = jobgen.job_phases(rng, klass, plat)
            jid = job_id
            job_id += 1
            job_classes[jid] = klass.name
            job_platforms[jid] = plat.name
            for ph in phases:
                if t >= horizon_s:
                    break
                n = min(ph.duration_s, horizon_s - t)
                if n <= 0:
                    continue
                cols, resident, nvlink = _phase_signals(rng, ph, plat, n)
                emit(cols, resident, nvlink, n, jid)
                t += n
                flush()

        if store is not None:
            flush(force=True)
        else:
            for f in FIELDS:
                if dev_cols[f]:
                    all_cols[f].append(np.concatenate(dev_cols[f]))

    if store is not None:
        store.save_manifest()
    frame = (TelemetryFrame({f: np.empty(0, dtype=_DTYPES[f]) for f in FIELDS})
             if store is not None else TelemetryFrame(_materialize(all_cols)))
    return ClusterSample(frame=frame,
                         job_classes=job_classes,
                         job_platforms=job_platforms)
