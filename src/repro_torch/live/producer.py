"""Shard producers: what feeds the live controller.

Three feeds, one contract — each ``step()`` appends whole shards to a
:class:`~repro_torch.telemetry.storage.TelemetryStore` in per-stream time order
(the ordering every streaming reader requires) and returns how many rows
landed (0 = exhausted / nothing new):

* :class:`SimulatorProducer` — the §2.1 cluster simulator's fleet frame,
  time-sliced into windows and drip-fed shard by shard: the exact rows a
  one-shot ``generate_cluster(store=...)`` emission would write, arriving
  live.
* :class:`SyntheticProducer` — fleet scale without fleet memory:
  ``n_streams`` constant-state streams generated one window at a time
  (O(window) memory), deterministic per ``(seed, window)``, highly
  run-compressible — the feed of the 10⁴-stream staleness run
  (``chip_smoke.py``'s live phase).
* :class:`DcgmDirectoryProducer` — the real-telemetry adapter: polls a
  directory of DCGM / ``power.json``-layout dumps (the file shape of
  kserve-vllm-mini's 1 Hz DCGM collector) and feeds each *new* file
  through the hygiene gate (:func:`repro_torch.telemetry.hygiene
  .ingest_dcgm`), so repairs and quarantines apply before anything
  becomes a shard. Re-polling is idempotent (seen-set keyed by file name).
"""
from __future__ import annotations

import json
import pathlib
from typing import Mapping

import numpy as np

from repro_torch.telemetry.hygiene import (DEFAULT_CONTRACT,
                                           HygieneContract, ingest_dcgm)
from repro_torch.telemetry.records import TelemetryFrame


class SimulatorProducer:
    """Drip-feed a simulated fleet: generate the cluster sample once, then
    append one ``window_s``-wide time slice per :meth:`step`, split per
    host label exactly like ``generate_cluster``'s own chunked emission
    (``h{hostname}``). Window slicing preserves each (job, host, device)
    stream's time order, so the fed store analyzes bit-identically to the
    one-shot frame."""

    def __init__(self, store, n_devices: int = 8, horizon_s: int = 3600,
                 window_s: int = 600, seed: int = 0, min_job_s: int = 600):
        from repro_torch.cluster import generate_cluster
        if window_s <= 0:
            raise ValueError(f"window_s must be positive, got {window_s}")
        self.store = store
        self.window_s = window_s
        sample = generate_cluster(n_devices=n_devices, horizon_s=horizon_s,
                                  seed=seed, min_job_s=min_job_s)
        self._frame = sample.frame
        self._ts = sample.frame["timestamp"]
        self._t_next = float(self._ts.min()) if len(self._frame) else 0.0
        self._t_end = float(self._ts.max()) + 1.0 if len(self._frame) else 0.0

    @property
    def exhausted(self) -> bool:
        return self._t_next >= self._t_end

    def step(self) -> int:
        """Append the next window (one shard per host label present in
        it). Returns rows appended; 0 = exhausted."""
        if self.exhausted:
            return 0
        t0, t1 = self._t_next, self._t_next + self.window_s
        self._t_next = t1
        window = self._frame.select((self._ts >= t0) & (self._ts < t1))
        if len(window) == 0:
            return 0
        rows = 0
        for h in np.unique(window["hostname"]):
            part = window.select(window["hostname"] == h)
            self.store.append(part, host=f"h{int(h)}")
            rows += len(part)
        return rows


class SyntheticProducer:
    """Fleet-scale feed with O(window) memory: ``n_streams`` streams, each
    constant within a window (alternating active/idle phases keyed on
    ``(stream, window)``), one shard per window. Deterministic — no RNG,
    no wall-clock — so two producers with the same parameters feed
    byte-identical shard sequences (what crash/resume tests require)."""

    def __init__(self, store, n_streams: int = 1000, window_s: int = 60,
                 dt_s: float = 1.0, seed: int = 0, host: str = "fleet0",
                 active_w: float = 350.0, idle_w: float = 75.0):
        if n_streams <= 0 or window_s <= 0:
            raise ValueError("n_streams and window_s must be positive")
        self.store = store
        self.n_streams = n_streams
        self.window_s = window_s
        self.dt_s = dt_s
        self.seed = seed
        self.host = host
        self.active_w = active_w
        self.idle_w = idle_w
        self.window = 0

    def step(self) -> int:
        """Append the next window as one shard (stream-major rows)."""
        w = self.window
        self.window += 1
        n_samples = max(1, int(round(self.window_s / self.dt_s)))
        s = np.arange(self.n_streams)
        t0 = w * self.window_s
        # stream-major layout: each stream's window rows are contiguous
        ts = (t0 + self.dt_s * np.arange(n_samples, dtype=np.float64))
        ts = np.tile(ts, self.n_streams)
        stream = np.repeat(s, n_samples)
        # alternating phases, staggered per stream and shifted by the seed:
        # constant within a window, so the run-IR compacts each window to
        # one run per stream
        active = ((stream + w + self.seed) % 4) < 2
        frame = TelemetryFrame({
            "timestamp": ts,
            "hostname": (stream % 251).astype(np.int32),
            "device_id": stream.astype(np.int32),
            "platform": (stream % 3).astype(np.int32),
            "power": np.where(active, self.active_w, self.idle_w),
            "sm": np.where(active, 60.0, 0.0),
            "job_id": (stream + 1).astype(np.int64),
            "program_resident": np.ones(stream.shape[0], np.int8),
        })
        self.store.append(frame, host=self.host)
        return len(frame)


class DcgmDirectoryProducer:
    """Poll a directory of raw collector dumps and hygiene-ingest each new
    file. Two JSON layouts are accepted per file:

    * a DCGM column dump — ``{"DCGM_FI_DEV_POWER_USAGE": [...], ...}``
      with optional ``timestamp`` / identity keys alongside;
    * a ``power.json`` sample list — ``{"samples": [{"ts": ...,
      "power_w": ..., "sm_pct": ...}, ...]}`` (or a bare list), the
      per-sample shape kserve-vllm-mini's collector writes.

    Unparseable files are skipped once and counted through the quarantine
    counter (never retried, never fatal); parseable ones go through
    :func:`repro_torch.telemetry.hygiene.ingest_dcgm`, so the contract's repairs
    and quarantine rules apply before the rows become a shard."""

    def __init__(self, store, directory,
                 contract: HygieneContract = DEFAULT_CONTRACT,
                 host: str = "dcgm0", pattern: str = "*.json"):
        self.store = store
        self.directory = pathlib.Path(directory)
        self.contract = contract
        self.host = host
        self.pattern = pattern
        self.seen: set[str] = set()
        self.verdicts: list = []

    def step(self) -> int:
        """Ingest every file not seen yet (sorted-name order). Returns the
        number of files processed this poll."""
        import repro_torch.obs as obs
        done = 0
        for path in sorted(self.directory.glob(self.pattern)):
            if path.name in self.seen:
                continue
            self.seen.add(path.name)
            done += 1
            try:
                payload = json.loads(path.read_text())
                columns, kwargs = parse_power_json(payload)
            except (OSError, ValueError, KeyError, TypeError):
                obs.counter("repro_shards_quarantined_total",
                            reason="unparseable_dump",
                            help="telemetry shards skipped or quarantined, "
                                 "by reason")
                continue
            verdict = ingest_dcgm(self.store, columns, self.contract,
                                  host=self.host, **kwargs)
            self.verdicts.append(verdict)
        return done


def parse_power_json(payload) -> tuple[Mapping, dict]:
    """Normalize a collector dump to ``(dcgm_columns, frame_kwargs)`` for
    :func:`repro_torch.telemetry.hygiene.dcgm_to_frame`. Raises ``ValueError``
    on a shape that is neither layout."""
    if isinstance(payload, list):
        payload = {"samples": payload}
    if not isinstance(payload, dict):
        raise ValueError("collector dump must be an object or sample list")
    if any(str(k).startswith("DCGM_FI_") for k in payload):
        columns = {k: v for k, v in payload.items()
                   if str(k).startswith("DCGM_FI_")}
        kwargs = {}
        if "timestamp" in payload:
            kwargs["timestamp"] = payload["timestamp"]
        for ident in ("hostname", "device_id", "platform", "job_id"):
            if ident in payload:
                kwargs[ident] = int(payload[ident])
        return columns, kwargs
    samples = payload.get("samples")
    if not isinstance(samples, list) or not samples:
        raise ValueError("no DCGM_FI_* columns and no samples list")
    ts = [float(s["ts"]) for s in samples]
    power = [float(s.get("power_w", float("nan"))) for s in samples]
    # sm_pct is already percent; the DCGM map scales PROF ratios by 100
    sm = [float(s.get("sm_pct", float("nan"))) / 100.0 for s in samples]
    columns = {"DCGM_FI_DEV_POWER_USAGE": power,
               "DCGM_FI_PROF_SM_ACTIVE": sm}
    kwargs: dict = {"timestamp": ts}
    dev = samples[0].get("device")
    if dev is not None:
        kwargs["device_id"] = int(dev)
    return columns, kwargs
