"""Telemetry sample schema (paper Table 1).

One record = one second of behaviour on one allocated device for one job.
Columnar storage as NumPy arrays; ``nan`` marks signals unavailable on a
platform (the classifier omits them rather than treating them as violated).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

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
