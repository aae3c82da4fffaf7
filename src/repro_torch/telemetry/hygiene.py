"""Telemetry hygiene: validate, repair or quarantine shards at ingest.

Real fleet telemetry is dirty in boring, recurring ways: collectors emit
NaN timestamps during clock steps, power rails read negative or physically
impossible during PSU glitches, 1 Hz samplers drop samples and then replay
duplicates after reconnecting, and whole shards arrive truncated. This
module is the *policy* layer over the storage primitives
(:mod:`repro_torch.telemetry.storage`): an explicit :class:`HygieneContract`
every shard is validated against, a per-shard :class:`ShardVerdict`
(``ok`` / ``repaired`` / ``quarantined``, with machine-readable reasons),
and deterministic repairs — identical input bytes always produce identical
verdicts and identical repaired shards.

Repairs are *subtractive only*: rows are dropped (non-finite timestamps,
out-of-range power) or deduplicated (same stream, same timestamp —
keep-first), never interpolated or invented; a shard needing more than
``max_repair_fraction`` of its rows dropped is quarantined instead. Gaps
wider than ``max_gap_s`` are *reported* (``gap_segments:<n>``) but the rows
are kept: the downstream pipelines already treat a gapped stream as
irregularly sampled (row-path replay, no run-IR), which is the correct
semantics for a hole — fabricating fill samples is not.

Entry points: :func:`check_frame` (pure), :func:`scrub_store` (whole-store
sweep using :meth:`TelemetryStore.rewrite_shard` /
:meth:`TelemetryStore.quarantine_shard`), :func:`ingest_frame` (validate
*before* a frame ever becomes a shard) and the tolerant DCGM-layout
adapter :func:`dcgm_to_frame` / :func:`ingest_dcgm` for 1 Hz
``DCGM_FI_*`` column dumps with ragged/missing samples.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

import repro_torch.obs as obs
from repro_torch.telemetry.records import TelemetryFrame, _DTYPES
from repro_torch.telemetry.storage import ShardReadError

if TYPE_CHECKING:
    from repro_torch.telemetry.storage import TelemetryStore


@dataclasses.dataclass(frozen=True)
class HygieneContract:
    """What a telemetry shard must look like to be analyzed as-is.

    ``required_fields`` must carry real data (an all-NaN float column means
    the signal was never recorded — identity, power and residency cannot be
    defaulted the way optional activity counters can). ``max_power_w``
    bounds plausible board power (no single accelerator package draws 2 kW;
    readings above it are sensor glitches, not samples). ``max_gap_s`` is
    the widest sampling hole that is still reported as a gap rather than
    silently accepted. ``max_repair_fraction`` caps how much of a shard the
    repairs may drop before the shard is quarantined wholesale — a shard
    that is mostly garbage is evidence of a broken producer, not noise.
    """

    required_fields: tuple[str, ...] = (
        "timestamp", "hostname", "device_id", "platform", "power",
        "job_id", "program_resident")
    max_power_w: float = 2000.0
    max_gap_s: float = 300.0
    dt_s: float = 1.0
    max_repair_fraction: float = 0.5


DEFAULT_CONTRACT = HygieneContract()


@dataclasses.dataclass(frozen=True)
class ShardVerdict:
    """One shard's hygiene outcome.

    ``status`` is ``"ok"`` (analyzed as-is), ``"repaired"`` (rows dropped /
    deduplicated; ``repairs`` counts each kind) or ``"quarantined"``
    (unusable; ``reasons`` says why). ``rows_in``/``rows_out`` are the
    before/after row counts — their difference is exactly what the coverage
    accounting loses."""

    shard: str
    status: str
    reasons: tuple[str, ...] = ()
    rows_in: int = 0
    rows_out: int = 0
    repairs: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status != "quarantined"


def check_columns(columns: Mapping[str, Sequence],
                  contract: HygieneContract = DEFAULT_CONTRACT,
                  shard: str = "") -> ShardVerdict:
    """Validate a raw column mapping *before* it becomes a
    :class:`TelemetryFrame`: required columns present, lengths consistent,
    values numeric. Returns a verdict only — construction-level failures
    (ragged, non-numeric) cannot be repaired row-wise."""
    reasons = []
    lengths = set()
    for f in contract.required_fields:
        if f not in columns:
            reasons.append(f"missing_required:{f}")
    for f, col in columns.items():
        arr = np.asarray(col)
        lengths.add(arr.shape[0] if arr.ndim else 0)
        if arr.dtype.kind not in "fiub":
            reasons.append(f"bad_dtype:{f}")
    if len(lengths) > 1:
        reasons.append("ragged_columns")
    n = max(lengths) if lengths else 0
    if reasons:
        return ShardVerdict(shard, "quarantined", tuple(reasons), n, 0)
    return ShardVerdict(shard, "ok", (), n, n)


def check_frame(frame: TelemetryFrame,
                contract: HygieneContract = DEFAULT_CONTRACT,
                shard: str = "") -> tuple[TelemetryFrame | None, ShardVerdict]:
    """Validate one frame against the contract; return ``(repaired_frame,
    verdict)``.

    Deterministic, subtractive repairs in a fixed order: (1) drop rows with
    non-finite timestamps; (2) drop rows whose power is non-finite,
    negative or above ``max_power_w``; (3) deduplicate rows sharing a
    (job, hostname, device, timestamp) key — keep the first occurrence, in
    input order. Gaps wider than ``max_gap_s`` within a stream are counted
    into the reasons but their rows are kept (see the module docstring).
    A clean frame is returned **unchanged** (same object), so the zero-
    fault path is bit-identical to not running hygiene at all; a frame
    needing more than ``max_repair_fraction`` of its rows dropped comes
    back as ``(None, quarantined-verdict)``.
    """
    rows_in = len(frame)
    if rows_in == 0:
        return frame, ShardVerdict(shard, "ok", (), 0, 0)
    reasons: list[str] = []
    repairs: dict[str, int] = {}

    # a required float signal that is all-NaN was never recorded at all
    # (TelemetryFrame fills absent columns with NaN) — not repairable
    for f in contract.required_fields:
        col = frame[f]
        if col.dtype.kind == "f" and not np.isfinite(
                np.asarray(col, dtype=np.float64)).any():
            reasons.append(f"missing_required:{f}")
    if reasons:
        return None, ShardVerdict(shard, "quarantined", tuple(reasons),
                                  rows_in, 0)

    ts = np.asarray(frame["timestamp"], dtype=np.float64)
    keep = np.isfinite(ts)
    n_bad_ts = int(rows_in - keep.sum())
    if n_bad_ts:
        repairs["nonfinite_timestamp"] = n_bad_ts

    power = np.asarray(frame["power"], dtype=np.float64)
    bad_power = (~np.isfinite(power)) | (power < 0.0) \
        | (power > contract.max_power_w)
    n_bad_p = int((bad_power & keep).sum())
    if n_bad_p:
        repairs["bad_power"] = n_bad_p
    keep &= ~bad_power

    out = frame if bool(keep.all()) else frame.select(keep)

    # duplicate samples: same stream key and timestamp, keep-first. The
    # trailing arange key makes the sort stable in *input* order, so the
    # survivor is always the first-seen row.
    n = len(out)
    if n:
        j = out["job_id"]
        h = out["hostname"]
        d = out["device_id"]
        t = out["timestamp"]
        order = np.lexsort((np.arange(n), t, d, h, j))
        sj, sh, sd, st = j[order], h[order], d[order], t[order]
        dup = np.concatenate([[False],
                              (np.diff(st) == 0) & (np.diff(sd) == 0)
                              & (np.diff(sh) == 0) & (np.diff(sj) == 0)])
        if dup.any():
            repairs["duplicate_timestamp"] = int(dup.sum())
            survivors = np.sort(order[~dup])   # back to input order
            out = out.select(survivors)

    # gap accounting (report, never fill)
    gap_runs = 0
    for _, seg in out.group_streams():
        dts = np.diff(np.asarray(seg["timestamp"], dtype=np.float64))
        gap_runs += int(np.sum(dts > contract.max_gap_s))
    if gap_runs:
        reasons.append(f"gap_segments:{gap_runs}")

    rows_out = len(out)
    dropped = rows_in - rows_out
    if dropped / rows_in > contract.max_repair_fraction:
        reasons.append("excessive_repair")
        return None, ShardVerdict(shard, "quarantined", tuple(reasons),
                                  rows_in, rows_out, repairs)
    status = "repaired" if repairs else "ok"
    return out, ShardVerdict(shard, status, tuple(reasons),
                             rows_in, rows_out, repairs)


def scrub_store(store: "TelemetryStore",
                contract: HygieneContract = DEFAULT_CONTRACT,
                dry_run: bool = False,
                verify: bool = False) -> list[ShardVerdict]:
    """Sweep every shard of a store through the hygiene contract.

    Unreadable shards (:class:`ShardReadError`) and contract-quarantined
    shards are moved to the store's ``quarantine/`` area with a manifest
    record; repairable shards are rewritten in place
    (:meth:`TelemetryStore.rewrite_shard` — same name, new rows+checksum).
    ``dry_run=True`` computes the verdicts without touching anything;
    ``verify=True`` additionally checksums each read. The manifest is
    flushed once at the end, and one verdict per shard (in manifest order)
    is returned.
    """
    verdicts: list[ShardVerdict] = []
    changed = False
    for name in list(store.shard_files()):
        try:
            frame = store.read_shard(name, verify=verify)
        except ShardReadError as e:
            verdicts.append(ShardVerdict(name, "quarantined", (e.reason,)))
            if not dry_run:
                store.quarantine_shard(name, e.reason, flush_manifest=False)
                changed = True
            continue
        fixed, verdict = check_frame(frame, contract, shard=name)
        verdicts.append(verdict)
        if verdict.status == "quarantined":
            if not dry_run:
                store.quarantine_shard(name, verdict.reasons[0],
                                       flush_manifest=False)
                changed = True
        elif verdict.status == "repaired":
            for reason, count in verdict.repairs.items():
                obs.counter("repro_shards_repaired_total", reason=reason,
                            help="telemetry shards repaired by the hygiene "
                                 "layer, by reason")
            if not dry_run:
                store.rewrite_shard(name, fixed)
                changed = True
    if changed:
        store.save_manifest()
    return verdicts


def ingest_frame(store: "TelemetryStore", frame: TelemetryFrame,
                 contract: HygieneContract = DEFAULT_CONTRACT,
                 host: str = "host0") -> ShardVerdict:
    """Hygiene-gated append: validate/repair a frame *before* it ever
    becomes a shard. Quarantined frames are never written (the verdict says
    why); ok/repaired frames append through :meth:`TelemetryStore.append`
    (which derives the day label and records the checksum)."""
    fixed, verdict = check_frame(frame, contract, shard="<ingest>")
    if verdict.status == "repaired":
        for reason in verdict.repairs:
            obs.counter("repro_shards_repaired_total", reason=reason,
                        help="telemetry shards repaired by the hygiene "
                             "layer, by reason")
    if verdict.status == "quarantined":
        obs.counter("repro_shards_quarantined_total",
                    reason=verdict.reasons[0],
                    help="telemetry shards skipped or quarantined, "
                         "by reason")
        return verdict
    store.append(fixed, host=host)
    return verdict


# --------------------------------------------------------------------------- #
# Tolerant DCGM-layout adapter (1 Hz DCGM_FI_* column dumps)
# --------------------------------------------------------------------------- #
#: DCGM field id -> (schema field, scale). PROF ratios are 0–1 and scale to
#: the schema's percent convention; byte counters scale to GB/s.
DCGM_FIELD_MAP: dict[str, tuple[str, float]] = {
    "DCGM_FI_DEV_POWER_USAGE": ("power", 1.0),
    "DCGM_FI_PROF_SM_ACTIVE": ("sm", 100.0),
    "DCGM_FI_PROF_PIPE_TENSOR_ACTIVE": ("tensor", 100.0),
    "DCGM_FI_PROF_PIPE_FP16_ACTIVE": ("fp16", 100.0),
    "DCGM_FI_PROF_PIPE_FP32_ACTIVE": ("fp32", 100.0),
    "DCGM_FI_PROF_PIPE_FP64_ACTIVE": ("fp64", 100.0),
    "DCGM_FI_PROF_DRAM_ACTIVE": ("dram", 100.0),
    "DCGM_FI_DEV_SM_CLOCK": ("sm_clk", 1.0),
    "DCGM_FI_DEV_MEM_CLOCK": ("mem_clk", 1.0),
    "DCGM_FI_PROF_PCIE_TX_BYTES": ("pcie_tx", 1e-9),
    "DCGM_FI_PROF_PCIE_RX_BYTES": ("pcie_rx", 1e-9),
    "DCGM_FI_PROF_NVLINK_TX_BYTES": ("nvlink_tx", 1e-9),
    "DCGM_FI_PROF_NVLINK_RX_BYTES": ("nvlink_rx", 1e-9),
}


def dcgm_to_frame(columns: Mapping[str, Sequence],
                  timestamp: Sequence | None = None,
                  hostname: int = 0, device_id: int = 0, platform: int = 0,
                  job_id: int = 0, program_resident: int = 1,
                  dt_s: float = 1.0) -> TelemetryFrame:
    """Adapt a 1 Hz DCGM field-value dump (``{"DCGM_FI_*": samples}``) to a
    :class:`TelemetryFrame`, tolerantly:

    * unknown field ids are ignored (collectors ship whatever was enabled);
    * ragged columns — a collector that missed samples on one field — are
      padded with NaN to the longest column (the classifier already treats
      NaN as "signal unavailable", never as violated);
    * a missing ``timestamp`` is synthesized at ``dt_s`` spacing starting
      at 0 (DCGM dumps are fixed-rate by construction).

    Identity/attribution metadata (host, device, platform, job, residency)
    is not in the DCGM layout, so it arrives as scalar arguments and is
    broadcast. The result should go through :func:`ingest_frame` (or
    :func:`ingest_dcgm`, which does exactly that) so contract repairs —
    duplicate timestamps after a collector reconnect, glitched power — are
    applied before the frame becomes a shard.
    """
    mapped: dict[str, np.ndarray] = {}
    n = 0
    for fid, raw in columns.items():
        target = DCGM_FIELD_MAP.get(fid)
        if target is None:
            continue
        field, scale = target
        arr = np.asarray(raw, dtype=np.float64) * scale
        mapped[field] = arr
        n = max(n, arr.shape[0])
    if timestamp is not None:
        ts = np.asarray(timestamp, dtype=np.float64)
        n = max(n, ts.shape[0])
    else:
        ts = None
    for field, arr in mapped.items():
        if arr.shape[0] < n:            # missed samples: pad, don't invent
            mapped[field] = np.concatenate(
                [arr, np.full(n - arr.shape[0], np.nan)])
    if ts is None:
        ts = dt_s * np.arange(n, dtype=np.float64)
    elif ts.shape[0] < n:
        # extend a short timestamp column at the nominal rate: timestamps
        # are identity, not a measurement, so extrapolation is safe
        start = ts[-1] if ts.shape[0] else 0.0
        extra = start + dt_s * np.arange(1, n - ts.shape[0] + 1)
        ts = np.concatenate([ts, extra])
    mapped["timestamp"] = ts
    mapped["hostname"] = np.full(n, hostname, dtype=_DTYPES["hostname"])
    mapped["device_id"] = np.full(n, device_id, dtype=_DTYPES["device_id"])
    mapped["platform"] = np.full(n, platform, dtype=_DTYPES["platform"])
    mapped["job_id"] = np.full(n, job_id, dtype=_DTYPES["job_id"])
    mapped["program_resident"] = np.full(
        n, program_resident, dtype=_DTYPES["program_resident"])
    return TelemetryFrame(mapped)


def ingest_dcgm(store: "TelemetryStore", columns: Mapping[str, Sequence],
                contract: HygieneContract = DEFAULT_CONTRACT,
                host: str = "host0", **frame_kwargs) -> ShardVerdict:
    """:func:`dcgm_to_frame` + :func:`ingest_frame` in one call — the
    shortest path from a raw DCGM dump to a hygiene-clean shard."""
    frame = dcgm_to_frame(columns, **frame_kwargs)
    return ingest_frame(store, frame, contract, host=host)
