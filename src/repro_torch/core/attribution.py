"""Pre-idle window extraction and cause attribution (paper §4.5).

For each execution-idle interval, extract up to ``window_s`` seconds of the
immediately preceding telemetry, truncated so the window contains only the
nearest preceding ACTIVE segment. Fingerprint each window, group fingerprints
with density clustering, and label clusters by their dominant signals:

    pcie_heavy        elevated PCIe + CPU          (host-device transfer)
    nic_heavy         elevated NIC + CPU           (network/storage I/O)
    nvlink_heavy      elevated NVLink/ICI          (device-device comm)
    compute_to_idle   elevated SM/DRAM then drop   (bursty compute phases)
    other             none of the above dominates
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.clustering import density_cluster
from repro_torch.core.intervals import Interval, extract_intervals
from repro_torch.core.states import DeviceState

#: fingerprint feature order
FEATURES: tuple[str, ...] = ("sm", "dram", "pcie", "nic", "nvlink", "cpu")

CATEGORIES: tuple[str, ...] = (
    "pcie_heavy", "compute_to_idle", "nic_heavy", "nvlink_heavy", "other",
)


@dataclasses.dataclass(frozen=True)
class PreIdleWindow:
    interval: Interval
    fingerprint: np.ndarray  # [len(FEATURES)] mean signal over the window
    window_len_s: int


def extract_pre_idle_windows(
    states: np.ndarray,
    signals: Mapping[str, np.ndarray],
    window_s: int = 10,
    min_duration_s: float = 5.0,
    dt_s: float = 1.0,
) -> list[PreIdleWindow]:
    """Windows preceding each sustained execution-idle interval.

    ``signals`` maps FEATURES names to [T] series; missing keys become 0.
    The window is truncated at the start of the nearest preceding ACTIVE run
    (and never crosses deep-idle or another execution-idle interval).
    """
    states = np.asarray(states)
    t = states.shape[0]
    series = {k: np.asarray(signals.get(k, np.zeros(t)), dtype=np.float64) for k in FEATURES}

    windows: list[PreIdleWindow] = []
    for interval in extract_intervals(states, DeviceState.EXECUTION_IDLE, min_duration_s, dt_s):
        end = interval.start
        start = max(0, end - window_s)
        # truncate to the contiguous preceding ACTIVE segment
        while start < end and states[start] != int(DeviceState.ACTIVE):
            start += 1
        for i in range(end - 1, start - 1, -1):
            if states[i] != int(DeviceState.ACTIVE):
                start = i + 1
                break
        if end - start <= 0:
            continue
        fp = np.array([series[k][start:end].mean() for k in FEATURES])
        windows.append(PreIdleWindow(interval=interval, fingerprint=fp,
                                     window_len_s=end - start))
    return windows


def _label_centroid(centroid: np.ndarray,
                    comm_gbs_threshold: float = 0.7,
                    activity_pct_threshold: float = 20.0) -> str:
    sm, dram, pcie, nic, nvlink, cpu = centroid
    comm = {"pcie_heavy": pcie, "nic_heavy": nic, "nvlink_heavy": nvlink}
    best = max(comm, key=comm.get)  # type: ignore[arg-type]
    if comm[best] >= comm_gbs_threshold:
        return best
    if max(sm, dram) >= activity_pct_threshold:
        return "compute_to_idle"
    return "other"


@dataclasses.dataclass(frozen=True)
class AttributionResult:
    category_shares: dict[str, float]   # fraction of windows per category
    labels: list[str]                   # per-window category
    n_clusters: int


def attribute_causes(
    windows: Sequence[PreIdleWindow],
    min_cluster_size: int = 10,
    min_samples: int = 5,
) -> AttributionResult:
    """Cluster fingerprints and assign category labels (Fig 9)."""
    if not windows:
        return AttributionResult({c: 0.0 for c in CATEGORIES}, [], 0)
    x = np.stack([w.fingerprint for w in windows])
    result = density_cluster(x, min_cluster_size=min_cluster_size, min_samples=min_samples)

    labels: list[str] = [""] * len(windows)
    for cluster_id in range(result.n_clusters):
        members = np.flatnonzero(result.labels == cluster_id)
        centroid = x[members].mean(axis=0)
        cat = _label_centroid(centroid)
        for m in members:
            labels[m] = cat
    # noise points: label individually by their own fingerprint
    for i in np.flatnonzero(result.labels == -1):
        labels[i] = _label_centroid(x[i])

    shares = {c: labels.count(c) / len(labels) for c in CATEGORIES}
    return AttributionResult(category_shares=shares, labels=labels,
                             n_clusters=result.n_clusters)
