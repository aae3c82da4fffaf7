"""Telemetry sample schema (paper Table 1).

One record = one second of behaviour on one allocated device for one job.
Columnar storage as NumPy arrays; ``nan`` marks signals unavailable on a
platform (the classifier omits them rather than treating them as violated).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Mapping

import numpy as np

#: (field, dtype, unit, source-analogue) — mirrors paper Table 1.
SCHEMA: tuple[tuple[str, str, str, str], ...] = (
    # identity
    ("timestamp", "f8", "s", "profiler"),
    ("hostname", "i4", "-", "scheduler"),      # interned id
    ("device_id", "i4", "-", "scheduler"),
    ("platform", "i4", "-", "nvml/runtime"),   # interned platform name
    # power
    ("power", "f8", "W", "nvml/model"),
    # activity (percent)
    ("sm", "f8", "%", "dcgm/runtime"),
    ("tensor", "f8", "%", "dcgm/runtime"),
    ("fp16", "f8", "%", "dcgm/runtime"),
    ("fp32", "f8", "%", "dcgm/runtime"),
    ("fp64", "f8", "%", "dcgm/runtime"),
    ("dram", "f8", "%", "dcgm/runtime"),
    # clocks
    ("sm_clk", "f8", "MHz", "nvml/model"),
    ("mem_clk", "f8", "MHz", "nvml/model"),
    # communication (GB/s)
    ("pcie_tx", "f8", "GB/s", "nvml/runtime"),
    ("pcie_rx", "f8", "GB/s", "nvml/runtime"),
    ("nvlink_tx", "f8", "GB/s", "nvml/runtime"),
    ("nvlink_rx", "f8", "GB/s", "nvml/runtime"),
    ("ici_tx", "f8", "GB/s", "runtime"),
    ("ici_rx", "f8", "GB/s", "runtime"),
    # host
    ("cpu_util", "f8", "%", "psutil/runtime"),
    ("host_mem_util", "f8", "%", "psutil/runtime"),
    ("nic_tx", "f8", "GB/s", "os-counters"),
    ("nic_rx", "f8", "GB/s", "os-counters"),
    # job metadata
    ("job_id", "i8", "-", "scheduler"),
    ("program_resident", "i1", "bool", "runtime"),
)

FIELDS: tuple[str, ...] = tuple(f for f, *_ in SCHEMA)
_DTYPES: dict[str, str] = {f: d for f, d, *_ in SCHEMA}

ACTIVITY_FIELDS = ("sm", "tensor", "fp16", "fp32", "fp64", "dram")
COMM_FIELDS = ("pcie_tx", "pcie_rx", "nvlink_tx", "nvlink_rx", "ici_tx", "ici_rx")


@dataclasses.dataclass
class TelemetryFrame:
    """Columnar batch of samples, aligned by row."""

    columns: dict[str, np.ndarray]

    def __post_init__(self) -> None:
        lengths = {k: v.shape[0] for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        for f in FIELDS:
            if f not in self.columns:
                n = len(self)
                fill = np.nan if _DTYPES[f].startswith("f") else 0
                self.columns[f] = np.full(n, fill, dtype=_DTYPES[f])

    def __len__(self) -> int:
        return 0 if not self.columns else next(iter(self.columns.values())).shape[0]

    def __getitem__(self, field: str) -> np.ndarray:
        return self.columns[field]

    def row(self, i: int) -> dict[str, object]:
        out: dict[str, object] = {k: v[i] for k, v in self.columns.items()}
        out["program_resident"] = bool(out["program_resident"])
        return out

    def select(self, mask: np.ndarray) -> "TelemetryFrame":
        return TelemetryFrame({k: v[mask] for k, v in self.columns.items()})

    def iter_chunks(self, chunk_rows: int) -> Iterator["TelemetryFrame"]:
        """Yield consecutive row-slices of at most ``chunk_rows`` rows.

        Slices are zero-copy views; useful for exercising / benchmarking the
        streaming analysis path against an in-memory frame.
        """
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        n = len(self)
        for s in range(0, n, chunk_rows):
            yield TelemetryFrame(
                {k: v[s:s + chunk_rows] for k, v in self.columns.items()})

    def group_streams(
        self,
    ) -> Iterator[tuple[tuple[int, int, int], "TelemetryFrame"]]:
        """Yield per-(job_id, hostname, device_id) streams, time-sorted.

        One lexsort + one gather per column replaces the O(groups x rows)
        per-group boolean masking: after sorting by (job, host, device,
        timestamp) every stream is a contiguous block, so each yielded frame
        is a zero-copy slice view of the sorted columns. Groups arrive in
        ascending (job_id, hostname, device_id) order; rows within a group are
        sorted by timestamp (stable, so equal timestamps keep input order).
        """
        n = len(self)
        if n == 0:
            return
        jid = self.columns["job_id"]
        host = self.columns["hostname"]
        dev = self.columns["device_id"]
        order = np.lexsort((self.columns["timestamp"], dev, host, jid))
        cols = {k: v[order] for k, v in self.columns.items()}
        sj, sh, sd = cols["job_id"], cols["hostname"], cols["device_id"]
        change = np.flatnonzero(
            (np.diff(sj) != 0) | (np.diff(sh) != 0) | (np.diff(sd) != 0)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [n]])
        for s, e in zip(starts, ends):
            key = (int(sj[s]), int(sh[s]), int(sd[s]))
            yield key, TelemetryFrame({k: v[s:e] for k, v in cols.items()})

    def activity_pct(self) -> dict[str, np.ndarray]:
        return {k: self.columns[k] for k in ACTIVITY_FIELDS}

    def comm_gbs(self) -> dict[str, np.ndarray]:
        return {k: self.columns[k] for k in COMM_FIELDS}

    @staticmethod
    def from_rows(rows: Iterable[Mapping[str, object]]) -> "TelemetryFrame":
        rows = list(rows)
        cols: dict[str, np.ndarray] = {}
        for f in FIELDS:
            dt = _DTYPES[f]
            default = np.nan if dt.startswith("f") else 0
            cols[f] = np.array([r.get(f, default) for r in rows], dtype=dt)
        return TelemetryFrame(cols)

    @staticmethod
    def concat(frames: list["TelemetryFrame"]) -> "TelemetryFrame":
        if not frames:
            return TelemetryFrame({f: np.empty(0, dtype=_DTYPES[f]) for f in FIELDS})
        return TelemetryFrame({
            f: np.concatenate([fr.columns[f] for fr in frames]) for f in FIELDS
        })
