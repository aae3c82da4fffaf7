"""Run-level telemetry IR: compact the row axis once, replay against runs.

The paper's central observation — in-execution telemetry is dominated by
long, near-constant low-activity stretches — makes per-second fleet
telemetry extremely *run-compressible*. This module exploits that for the
what-if stack: per (job, host, device) stream, the row series is collapsed
once, under a given classifier + low-activity threshold pair, into maximal
runs of constant ``(device_state, low_activity)`` with per-run sample
counts and power sums (plus the raw power samples for the few aggregates
that are nonlinear per sample — power-cap clipping, downscale floors).
Policy grids then replay against the ``(n_configs, n_runs)`` axis instead
of ``(n_configs, n_rows)``: downscale decisions, parking counterfactuals
and cap thresholds are run-structured, so per-config cost drops from
O(rows) to O(runs) ("compact once, replay many").

Contracts mirrored from the row-exact reference path
(:class:`repro_torch.whatif.replay.BatchedPolicyReplayer`):

* **time/count metrics are bit-identical** — per-state durations are
  integer sample sums, decision sequences reduce to the same trigger
  indices, event counts and throttled-sample counts are exact integers;
* **energies/penalties agree to <= 1e-9 relative** — per-run power sums
  are exact partial sums of the same samples, but the float summation
  *order* differs from the sample-level integrator
  (tests/test_whatif_ir.py property-tests the equivalence).

The IR is cached in memory across sweep/search rounds and persisted as a
sidecar file next to the store's ``npz``/``npy_dir`` shards, keyed by the
:meth:`IRConfig.config_hash` in the manifest (``manifest["run_ir"]``), so
repeat sweeps skip stream grouping, classification and run-length encoding
entirely. Sidecars are invalidated when the classifier config changes (a
different hash misses); a store that merely *grew* is caught up
incrementally instead of rebuilt: :meth:`IRBuilder.extend` re-opens each
appended-to stream at its trailing run (the same cross-chunk carry the
from-scratch build uses, so the result is bit-identical), re-derives the
memoized per-stream aggregates only for the affected suffix, and carries
untouched streams over as the same objects, memo caches intact. The
sidecar manifest entry records a per-stream shard **watermark**
(``n_shards`` covered manifest prefix + per-host row counts), so growth
invalidates appended-to streams' tails, not the world — see
:func:`save_sidecar` and the storage-module docstring for the format.

Requirements: streams must be regularly sampled (``ts == ts[0] +
dt_s*arange(n)`` exactly, per stream) — the run table stores offsets, not
timestamps. Irregular streams raise :class:`IRUnsupportedError` and the
callers (:func:`repro_torch.whatif.sweep.evaluate`) fall back to the row path.

The IR is also the input format of the PyTorch replay backend
(:mod:`repro_torch.whatif.backend`): :func:`repro_torch.whatif.backend.pack_ir`
bridges these ragged per-stream run tables into padded power-of-two
device buckets, and the family kernels replay ``(n_configs, n_runs)``
blocks on the card under the same bit-exactness contract.

Memory: unlike the row paths (peak ~ one shard), a resident IR holds the
store's *power column* (~8 bytes/row, 1/25th of the full schema) plus the
run tables and lazy per-stream aggregates — the price of O(runs)
replays. The in-process cache is a small LRU (``_IR_CACHE_MAX``); for a
corpus whose power column alone exceeds RAM, sweep with
``compact=False`` to stay fully out-of-core.

Observability: build time, compaction ratio and every cache-ladder
outcome (memory/sidecar hit, invalidation, negative-cache hit) are
recorded under the ``repro_ir_*`` metrics when :mod:`repro_torch.obs` is
enabled — see the README "Observability" section for the full table.

Robustness (README "Robustness & dirty telemetry"): sidecar writes commit
through :func:`repro_torch.telemetry.storage.atomic_replace` (kill-mid-write
leaves the previous sidecar intact); a corrupt or unparseable sidecar is
deleted and rebuilt from the shards (``sidecar -> rebuild`` fallback),
never raised to the caller; IRs built with ``strict=False`` record the
shards they skipped (:attr:`RunIR.skipped`) and are refused by strict
cache hits, so a degraded IR can never silently serve a strict caller.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import time
import zipfile
import zlib
from typing import TYPE_CHECKING, Iterable, Mapping

import numpy as np

import repro_torch.obs as obs
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.energy import EnergyBreakdown, integrate_runs
from repro_torch.core.states import (ClassifierConfig, DEFAULT_CLASSIFIER,
                                     DeviceState, classify_series)
from repro_torch.whatif.policies import (CompositePolicy, DownscalePolicy,
                                         NoOpPolicy, ParkingPolicy, Policy,
                                         PowerCapPolicy, low_activity_series)

if TYPE_CHECKING:
    from repro_torch.telemetry.records import TelemetryFrame
    from repro_torch.telemetry.storage import TelemetryStore

#: manifest key holding {config_hash: {"file", "source_rows", "config"}}
MANIFEST_KEY = "run_ir"

_DEEP = int(DeviceState.DEEP_IDLE)
_EXEC = int(DeviceState.EXECUTION_IDLE)
_ACTIVE = int(DeviceState.ACTIVE)


class IRUnsupportedError(ValueError):
    """The store/grid cannot be compacted; callers fall back to rows."""


@dataclasses.dataclass(frozen=True)
class IRConfig:
    """Everything the run decomposition depends on.

    ``classifier`` fixes the §2.2 device states; ``activity_threshold`` /
    ``comm_threshold_gbs`` fix the Algorithm-1 low-activity predicate the
    policies share (:func:`repro_torch.whatif.policies.low_activity_series`);
    ``dt_s`` fixes the sample spacing the run lengths are denominated in.
    Policies whose knobs disagree with these are simply *unsupported* by an
    IR built from this config (:func:`ir_supported`) — they replay through
    the row path instead.
    """

    classifier: ClassifierConfig = DEFAULT_CLASSIFIER
    activity_threshold: float = 0.05
    comm_threshold_gbs: float = 1.0
    dt_s: float = 1.0

    def low_config(self) -> ControllerConfig:
        return ControllerConfig(activity_threshold=self.activity_threshold,
                                comm_threshold_gbs=self.comm_threshold_gbs)

    def to_dict(self) -> dict:
        return {
            "classifier": dataclasses.asdict(self.classifier),
            "activity_threshold": self.activity_threshold,
            "comm_threshold_gbs": self.comm_threshold_gbs,
            "dt_s": self.dt_s,
        }

    @staticmethod
    def from_dict(d: Mapping) -> "IRConfig":
        cls_d = dict(d["classifier"])
        cls_d["compute_memory_signals"] = tuple(cls_d["compute_memory_signals"])
        cls_d["communication_signals"] = tuple(cls_d["communication_signals"])
        return IRConfig(
            classifier=ClassifierConfig(**cls_d),
            activity_threshold=d["activity_threshold"],
            comm_threshold_gbs=d["comm_threshold_gbs"],
            dt_s=d["dt_s"],
        )

    def config_hash(self) -> str:
        payload = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


# --------------------------------------------------------------------------- #
# Per-stream IR + lazily derived replay aggregates
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StreamIR:
    """One stream's run table plus its power samples.

    The run arrays are the *compact* axis every policy config iterates;
    ``power`` keeps the raw samples so nonlinear per-sample aggregates
    (cap clipping, downscale floors) stay exact — computed **once** per
    stream (lazily, memoized in ``_cache``) and shared by every config and
    every sweep/search round. ``_cache`` is dropped on pickling, so
    process-pool workers rebuild their own aggregates.
    """

    key: tuple[int, int, int]        # (job_id, hostname, device_id)
    host_label: str                  # manifest host label (partition unit)
    platform_id: int
    ts_first: float
    dt_s: float
    state: np.ndarray                # [R] int8  DeviceState per run
    low: np.ndarray                  # [R] bool  Algorithm-1 low-activity flag
    length: np.ndarray               # [R] int64 samples per run
    power_sum: np.ndarray            # [R] f8    sum of board power over run
    power: np.ndarray                # [N] f8    raw per-sample board power

    def __post_init__(self) -> None:
        self._cache: dict = {}

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_cache"] = {}
        return d

    # ------------------------------------------------------------------ #
    @property
    def n_rows(self) -> int:
        return int(self.power.shape[0])

    @property
    def n_runs(self) -> int:
        return int(self.state.shape[0])

    @property
    def ts_last(self) -> float:
        return float(self.ts_first + self.dt_s * (self.n_rows - 1))

    def _memo(self, key, fn):
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = fn()
        return hit

    def run_offsets(self) -> np.ndarray:
        """[R+1] sample offset of each run (cumulative lengths)."""
        return self._memo("off", lambda: np.concatenate(
            [[0], np.cumsum(self.length)]).astype(np.int64))

    def ts(self) -> np.ndarray:
        """Reconstructed per-sample timestamps (regularity is validated at
        build time, so this equals the recorded column bit-for-bit)."""
        return self._memo("ts", lambda: self.ts_first
                          + self.dt_s * np.arange(self.n_rows))

    def resident_runs(self) -> np.ndarray:
        """[R] bool — a program is resident (state is not DEEP_IDLE)."""
        return self._memo("res", lambda: self.state != _DEEP)

    def cum_resident(self) -> np.ndarray:
        """[N+1] prefix counts of resident samples (exact throttle counts)."""
        def build():
            res = np.repeat(self.resident_runs(), self.length)
            return np.concatenate([[0], np.cumsum(res)]).astype(np.int64)
        return self._memo("cumres", build)

    def expand(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-sample ``(states, low)`` — the inverse of the run-length
        encoding (round-trip tested in tests/test_whatif_ir.py)."""
        return (np.repeat(self.state, self.length),
                np.repeat(self.low, self.length))

    # ------------------------------------------------------------------ #
    def final_state(self, min_samples: int) -> np.ndarray:
        """[R] the state each run's samples are *accounted* under: maximal
        same-state runs (merging across the low flag) shorter than the §2.2
        sustain threshold relabel EXECUTION_IDLE -> ACTIVE, exactly as the
        streaming integrator does."""
        def build():
            change = np.flatnonzero(np.diff(self.state)) + 1
            starts = np.concatenate([[0], change])
            m_state = self.state[starts].astype(np.int64)
            m_len = np.add.reduceat(self.length, starts)
            m_final = np.where((m_state == _EXEC) & (m_len < min_samples),
                               _ACTIVE, m_state)
            reps = np.diff(np.concatenate([starts, [self.n_runs]]))
            return np.repeat(m_final, reps).astype(np.int8)
        return self._memo(("final", min_samples), build)

    def sample_final_state(self, min_samples: int) -> np.ndarray:
        return self._memo(("sfinal", min_samples), lambda: np.repeat(
            self.final_state(min_samples), self.length))

    def baseline(self, min_samples: int) -> EnergyBreakdown:
        """Recorded-series breakdown from run aggregates: per-state times
        bit-identical to the sample integrator, energies within summation
        order."""
        return self._memo(("base", min_samples), lambda: integrate_runs(
            self.state, self.power_sum[None, :], self.length,
            min_samples, self.dt_s)[0])

    def controller_runs(self) -> tuple[np.ndarray, np.ndarray]:
        """Maximal runs of the low-activity flag (the Algorithm-1 axis):
        ``(offsets [K+1] sample indices, low [K])``. Adjacent IR runs with
        equal ``low`` but different state merge here — the controller sees
        only the flag."""
        def build():
            change = np.flatnonzero(np.diff(self.low)) + 1
            starts = np.concatenate([[0], change]).astype(np.int64)
            off = self.run_offsets()[np.concatenate(
                [starts, [self.n_runs]])]
            return off, self.low[starts]
        return self._memo("crs", build)

    def downscale_cums(self, delta: float, deep_idle_w: float,
                       min_samples: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-sample prefix sums of the downscale saving
        ``power - max(power - delta, deep_idle_w)`` on resident samples,
        split by the accounting state bucket: ``(cum_exec [N+1],
        cum_active [N+1])``. One O(N) pass per (platform delta, sustain
        threshold), shared by every config and round."""
        def build():
            p = self.power
            sav = p - np.maximum(p - delta, deep_idle_w)
            sav = np.where(np.repeat(self.resident_runs(), self.length),
                           sav, 0.0)
            fs = self.sample_final_state(min_samples)
            cum_exec = np.concatenate(
                [[0.0], np.cumsum(np.where(fs == _EXEC, sav, 0.0))])
            cum_act = np.concatenate(
                [[0.0], np.cumsum(np.where(fs == _ACTIVE, sav, 0.0))])
            return cum_exec, cum_act
        return self._memo(("dscum", float(delta), float(deep_idle_w),
                           min_samples), build)

    def cap_buckets(self, min_samples: int) -> dict:
        """Sorted-power aggregates for power capping, one O(N log N) build
        shared by every cap fraction:

        * per accounting state ``s``: ``(sorted_p ascending, top_sum)``
          where ``top_sum[k]`` is the sum of the k largest samples — so a
          cap's clipped energy is ``bucket_sum - (top_sum[k] - k*cap_w)``
          with ``k = #{p > cap_w}`` found by one vectorized searchsorted;
        * ``"penalty"``: the resident & not-low samples (the cube-law
          slowdown base), with ``top_cbrt[k]`` the sum of the k largest
          samples' cube roots.
        """
        def build():
            fs = self.sample_final_state(min_samples)
            out = {}
            for s in (_DEEP, _EXEC, _ACTIVE):
                sp = np.sort(self.power[fs == s])
                top = np.concatenate([[0.0], np.cumsum(sp[::-1])])
                out[s] = (sp, top)
            pen_mask = np.repeat(self.resident_runs() & ~self.low,
                                 self.length)
            sp = np.sort(self.power[pen_mask])
            top = np.concatenate([[0.0], np.cumsum(sp[::-1])])
            top_cbrt = np.concatenate([[0.0], np.cumsum(np.cbrt(sp[::-1]))])
            out["penalty"] = (sp, top, top_cbrt)
            return out
        return self._memo(("caps", min_samples), build)

    def parking_counterfactual(self, min_samples: int) -> dict:
        """The one counterfactual every parked config shares: idle samples
        (resident & low) drop to deep-idle residency. Returns per-run cf
        states / energies plus exact wake and idle-sample counts. The
        deep-idle *power value* is platform-dependent, so energies are
        returned as ``(power_sum part, idle-sample count)`` for the caller
        to price: ``energy = keep_sum + idle_len * deep_idle_w`` per run.
        """
        def build():
            idle = self.resident_runs() & self.low
            active = self.resident_runs() & ~self.low
            cf_state = np.where(idle, _DEEP, self.state).astype(np.int8)
            keep_sum = np.where(idle, 0.0, self.power_sum)
            idle_len = np.where(idle, self.length, 0).astype(np.int64)
            wakes = int(np.sum(idle[:-1] & active[1:]))
            return {"cf_state": cf_state, "keep_sum": keep_sum,
                    "idle_len": idle_len, "wakes": wakes,
                    "idle_samples": int(np.sum(idle_len))}
        return self._memo(("park", min_samples), build)


# --------------------------------------------------------------------------- #
# Fleet-level IR
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RunIR:
    """The whole store's run-level IR: one :class:`StreamIR` per
    job-attributed stream, plus the build config and the store row count it
    was built from (staleness check).

    ``source_shards`` is the covered prefix length of the store's
    append-only ``manifest["shards"]`` list — the watermark
    :meth:`IRBuilder.extend` validates before appending only the new
    shards. ``unattributed`` keeps one ``(host_label, power_sum)`` pair per
    ingested chunk for the ``job_id < 0`` samples, so the fleet-analysis
    consumer can price unattributed energy (``math.fsum`` over the pairs is
    exact, hence identical to the row path's per-shard partials)."""

    config: IRConfig
    streams: dict[tuple[int, int, int], StreamIR]
    source_rows: int
    skipped: tuple = ()      # shard skip records from a strict=False build
    source_shards: int = 0   # covered prefix of manifest["shards"]
    unattributed: tuple = () # (host_label, power sum) per ingested chunk

    @property
    def n_rows(self) -> int:
        return sum(s.n_rows for s in self.streams.values())

    @property
    def n_runs(self) -> int:
        return sum(s.n_runs for s in self.streams.values())

    @property
    def compaction_ratio(self) -> float:
        runs = self.n_runs
        return self.n_rows / runs if runs else float("nan")

    def select(self, hosts: Iterable[str] | None = None) -> list[StreamIR]:
        """Streams in sorted-key order, optionally host-label filtered."""
        host_set = set(hosts) if hosts is not None else None
        return [self.streams[k] for k in sorted(self.streams)
                if host_set is None
                or self.streams[k].host_label in host_set]


# --------------------------------------------------------------------------- #
# Builder (streaming, mergeable — same partition contract as the replayers)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _StreamAccum:
    host_label: str
    platform_id: int
    ts_first: float
    n_seen: int = 0
    run_state: list = dataclasses.field(default_factory=list)
    run_low: list = dataclasses.field(default_factory=list)
    run_len: list = dataclasses.field(default_factory=list)
    run_sum: list = dataclasses.field(default_factory=list)
    power_pieces: list = dataclasses.field(default_factory=list)
    # trailing, possibly-unfinished run
    t_state: int = -1
    t_low: bool = False
    t_len: int = 0
    t_sum: float = 0.0
    # closed run arrays inherited from an extended IR (state/low/len/sum) —
    # prepended verbatim at finalize, never re-encoded
    prefix: tuple | None = None


def _seed_accum(s: StreamIR) -> _StreamAccum:
    """Re-open a finalized stream for appending: the closed-run prefix is
    carried verbatim and the trailing run becomes the accumulator's open
    run — exactly the state a from-scratch build would hold after ingesting
    this stream's shards, so continuing the build is bit-identical."""
    if s.n_runs == 0:
        return _StreamAccum(host_label=s.host_label,
                            platform_id=s.platform_id, ts_first=s.ts_first)
    t = s.n_runs - 1
    return _StreamAccum(
        host_label=s.host_label,
        platform_id=s.platform_id,
        ts_first=s.ts_first,
        n_seen=s.n_rows,
        power_pieces=[s.power],
        t_state=int(s.state[t]),
        t_low=bool(s.low[t]),
        t_len=int(s.length[t]),
        t_sum=float(s.power_sum[t]),
        prefix=(s.state[:t], s.low[:t], s.length[:t], s.power_sum[:t]),
    )


class IRBuilder:
    """Build a :class:`RunIR` from time-ordered telemetry chunks.

    Same streaming contract as the replayers (chunks may mix streams; per
    stream they arrive in time order), one classification + low-activity
    pass + run-length encoding per chunk — this is the *only* O(rows) work
    the compact path ever does, paid once per (store, IRConfig).
    ``merge`` absorbs a builder that saw a disjoint stream set (the
    process-pool reduction).
    """

    def __init__(self, config: IRConfig):
        self.config = config
        self._low_cfg = config.low_config()
        self._acc: dict[tuple[int, int, int], _StreamAccum] = {}
        self._unattr: list[tuple[str, float]] = []
        self._seed: dict[tuple[int, int, int], StreamIR] = {}

    def update(self, chunk: "TelemetryFrame", host_label: str = "") -> None:
        if len(chunk) == 0:
            return
        obs.counter("repro_ir_build_rows_total", float(len(chunk)),
                    help="telemetry rows run-length encoded by IRBuilder")
        neg = chunk["job_id"] < 0
        if np.any(neg):
            # same per-chunk partial the row path records; math.fsum over
            # the pieces is exact, so consumers match it bit-for-bit
            self._unattr.append(
                (host_label, float(np.sum(chunk["power"][neg]))))
        for key, seg in chunk.group_streams():
            if key[0] < 0:
                continue
            self._update_segment(key, seg, host_label)

    def _update_segment(self, key, seg, host_label: str) -> None:
        n = len(seg)
        ts = np.asarray(seg["timestamp"], dtype=np.float64)
        acc = self._acc.get(key)
        if acc is None:
            seed = self._seed.pop(key, None)
            if seed is not None:
                acc = self._acc[key] = _seed_accum(seed)
            else:
                acc = self._acc[key] = _StreamAccum(
                    host_label=host_label,
                    platform_id=int(seg["platform"][0]),
                    ts_first=float(ts[0]))
        expected = acc.ts_first + self.config.dt_s * np.arange(
            acc.n_seen, acc.n_seen + n)
        if not np.array_equal(ts, expected):
            raise IRUnsupportedError(
                f"stream {key} is not regularly sampled at dt={self.config.dt_s}"
                f" (run-level IR stores offsets, not timestamps); replay this "
                f"store with compact=False")
        states = classify_series(
            seg["program_resident"].astype(bool),
            seg.activity_pct(),
            seg.comm_gbs(),
            self.config.classifier,
        )
        low = low_activity_series(seg, self._low_cfg)
        power = np.asarray(seg["power"], dtype=np.float64)
        acc.power_pieces.append(power)
        acc.n_seen += n

        code = states.astype(np.int16) * 2 + low
        change = np.flatnonzero(np.diff(code)) + 1
        starts = np.concatenate([[0], change]).astype(np.int64)
        ends = np.concatenate([change, [n]]).astype(np.int64)
        sums = np.add.reduceat(power, starts)
        first = 0
        if acc.t_len and acc.t_state == int(states[0]) \
                and acc.t_low == bool(low[0]):
            acc.t_len += int(ends[0] - starts[0])
            acc.t_sum += float(sums[0])
            first = 1
        for i in range(first, starts.shape[0]):
            if acc.t_len:
                acc.run_state.append(acc.t_state)
                acc.run_low.append(acc.t_low)
                acc.run_len.append(acc.t_len)
                acc.run_sum.append(acc.t_sum)
            acc.t_state = int(states[starts[i]])
            acc.t_low = bool(low[starts[i]])
            acc.t_len = int(ends[i] - starts[i])
            acc.t_sum = float(sums[i])

    def merge(self, other: "IRBuilder") -> "IRBuilder":
        overlap = self._acc.keys() & other._acc.keys()
        if overlap:
            raise ValueError(f"cannot merge IR builders with overlapping "
                             f"streams: {sorted(overlap)[:3]}...")
        if other.config != self.config:
            raise ValueError("cannot merge IR builders with different configs")
        self._acc.update(other._acc)
        self._unattr.extend(other._unattr)
        return self

    def finalize(self, source_rows: int = 0, source_shards: int = 0) -> RunIR:
        streams: dict[tuple[int, int, int], StreamIR] = {}
        for key in sorted(self._acc):
            acc = self._acc[key]
            if acc.t_len:
                acc.run_state.append(acc.t_state)
                acc.run_low.append(acc.t_low)
                acc.run_len.append(acc.t_len)
                acc.run_sum.append(acc.t_sum)
                acc.t_len = 0
            state = np.array(acc.run_state, dtype=np.int8)
            low = np.array(acc.run_low, dtype=bool)
            length = np.array(acc.run_len, dtype=np.int64)
            power_sum = np.array(acc.run_sum, dtype=np.float64)
            if acc.prefix is not None:
                p_state, p_low, p_len, p_sum = acc.prefix
                state = np.concatenate([p_state, state])
                low = np.concatenate([p_low, low])
                length = np.concatenate([p_len, length])
                power_sum = np.concatenate([p_sum, power_sum])
            streams[key] = StreamIR(
                key=key,
                host_label=acc.host_label,
                platform_id=acc.platform_id,
                ts_first=acc.ts_first,
                dt_s=self.config.dt_s,
                state=state,
                low=low,
                length=length,
                power_sum=power_sum,
                power=(np.concatenate(acc.power_pieces)
                       if acc.power_pieces else np.empty(0)),
            )
        self._acc.clear()
        unattr = tuple(self._unattr)
        self._unattr = []
        return RunIR(config=self.config, streams=streams,
                     source_rows=source_rows, source_shards=source_shards,
                     unattributed=unattr)

    def extend(self, ir: RunIR, chunks: Iterable[tuple],
               source_rows: int | None = None,
               source_shards: int | None = None) -> RunIR:
        """Append ``chunks`` to an existing IR, rebuilding only the tails.

        ``chunks`` is an iterable of ``(frame, host_label)`` pairs — one per
        appended shard, in append (manifest) order. Each appended-to stream
        is re-opened at its trailing run via :func:`_seed_accum` (the same
        cross-chunk carry the from-scratch build uses), so the result is
        **bit-identical** to ``build_ir`` over the full shard sequence —
        run tables, power columns and every seeded memo agree bit-for-bit
        (property-tested in tests/test_ir_append.py). Cost is O(new rows +
        affected suffixes), not O(store).

        Untouched streams are carried over as the *same*
        :class:`StreamIR` objects, lazy memo caches intact; touched streams
        get their expensive memos (prefix sums, cap buckets,
        accounting-state labels) seeded from the old stream's cache via
        :func:`_extend_stream_memos`, recomputing only from the start of
        the last maximal state run (the only region the §2.2 sustain rule
        can relabel). ``ir`` itself is never mutated.

        ``source_rows``/``source_shards`` default to ``ir``'s values plus
        what ``chunks`` contributed; :func:`_try_extend` passes the
        manifest-derived totals instead so skipped shards still count
        toward staleness, mirroring ``build_ir``'s semantics.
        """
        if self._acc:
            raise ValueError("extend requires a fresh IRBuilder")
        if ir.config != self.config:
            raise ValueError(
                "cannot extend an IR built with a different config")
        t0 = time.perf_counter()
        self._seed = dict(ir.streams)
        self._unattr = list(ir.unattributed)
        n_chunks = 0
        new_rows = 0
        try:
            for frame, host_label in chunks:
                n_chunks += 1
                new_rows += len(frame)
                self.update(frame, host_label=host_label)
        finally:
            self._seed = {}
        out = self.finalize(
            source_rows=(ir.source_rows + new_rows if source_rows is None
                         else source_rows),
            source_shards=(ir.source_shards + n_chunks
                           if source_shards is None else source_shards))
        recomputed = 0
        streams = dict(out.streams)
        for key, new_s in out.streams.items():
            old_s = ir.streams.get(key)
            if old_s is not None:
                recomputed += _extend_stream_memos(old_s, new_s)
            else:
                recomputed += new_s.n_rows
        for key, old_s in ir.streams.items():
            streams.setdefault(key, old_s)
        out.streams = {k: streams[k] for k in sorted(streams)}
        out.skipped = tuple(ir.skipped)
        total = out.n_rows
        obs.counter("repro_ir_appends_total",
                    help="incremental IR catches-up via IRBuilder.extend")
        obs.counter("repro_ir_append_rows_total", float(new_rows),
                    help="telemetry rows appended through IRBuilder.extend")
        obs.gauge("repro_ir_suffix_rebuild_fraction",
                  recomputed / total if total else 0.0,
                  help="rows whose derived aggregates the last extend "
                       "recomputed, as a fraction of the IR's rows")
        if obs.enabled():
            obs.observe("repro_ir_extend_seconds", time.perf_counter() - t0,
                        help="wall time of IRBuilder.extend")
        return out


def _final_state_suffix(state: np.ndarray, length: np.ndarray,
                        min_samples: int) -> np.ndarray:
    """:meth:`StreamIR.final_state` restricted to a run-slice that starts
    on a maximal-state-run boundary — the relabel seen by those runs in a
    full build (reduceat grouping is identical on either side of a state
    change)."""
    change = np.flatnonzero(np.diff(state)) + 1
    starts = np.concatenate([[0], change])
    m_state = state[starts].astype(np.int64)
    m_len = np.add.reduceat(length, starts)
    m_final = np.where((m_state == _EXEC) & (m_len < min_samples),
                       _ACTIVE, m_state)
    reps = np.diff(np.concatenate([starts, [state.shape[0]]]))
    return np.repeat(m_final, reps).astype(np.int8)


def _multiset_delete(sp: np.ndarray, rem: np.ndarray) -> np.ndarray:
    """Remove the sorted multiset ``rem`` from the sorted array ``sp``
    (every ``rem`` value must be present): the k-th duplicate of a value in
    ``rem`` deletes the k-th duplicate in ``sp`` — occurrence-rank indexing,
    so ties never collapse onto one index."""
    if rem.size == 0:
        return sp
    idx = (np.searchsorted(sp, rem, side="left")
           + (np.arange(rem.size) - np.searchsorted(rem, rem, side="left")))
    return np.delete(sp, idx)


def _sorted_insert(sp: np.ndarray, add: np.ndarray) -> np.ndarray:
    """Merge the sorted array ``add`` into the sorted array ``sp``. The
    result is element-wise identical to re-sorting the union: equal floats
    share a bit pattern, so duplicate placement cannot be observed."""
    if add.size == 0:
        return sp
    return np.insert(sp, np.searchsorted(sp, add), add)


def _extend_stream_memos(old: StreamIR, new: StreamIR) -> int:
    """Seed ``new``'s lazy memo cache from ``old``'s after an append.

    Only labels and prefix aggregates of samples at or after ``B`` — the
    sample offset of the old stream's **last maximal constant-state run**
    — can change when rows append (§2.2 sustain relabels apply per maximal
    run, and only the last one can keep growing), so every seeded memo
    keeps its ``[:B]`` prefix and recomputes the suffix:

    * ``cumres`` — integer prefix counts: left-fold extended (exact);
    * ``("final"/"sfinal", m)`` — relabel recomputed from the maximal-run
      boundary ``q`` only;
    * ``("dscum", delta, deep_w, m)`` — float prefix sums extended by
      continuing the sequential cumsum *fold* from the old value at ``B``
      (``np.cumsum`` accumulates left-to-right, so this is bit-identical
      to a fresh full-series cumsum — never add the base to a sub-cumsum,
      association differs);
    * ``("caps", m)`` — sorted buckets patched by multiset delete/insert
      of the suffix samples (the O(N log N) sort is avoided; the cheap
      top-k cumsums are recomputed over the merged bucket).

    Cheap O(runs) memos (offsets, controller runs, baselines, parking)
    recompute lazily on demand. Returns the number of rows whose derived
    aggregates were recomputed (``new.n_rows - B``), the numerator of
    ``repro_ir_suffix_rebuild_fraction``.
    """
    old_off = old.run_offsets()
    t = old.n_runs - 1
    if t < 0:
        return new.n_rows
    change = np.flatnonzero(np.diff(old.state))
    q = int(change[-1] + 1) if change.size else 0
    B = int(old_off[q])
    off_t = int(old_off[t])
    old_n = old.n_rows
    cache = old._cache
    newc = new._cache

    if "cumres" in cache:
        old_cum = cache["cumres"]
        suf = np.repeat(new.resident_runs()[t:], new.length[t:])
        newc["cumres"] = np.concatenate(
            [old_cum[:off_t + 1],
             old_cum[off_t] + np.cumsum(suf)]).astype(np.int64)

    ms = {k[1] for k in cache if isinstance(k, tuple)
          and k[0] in ("final", "sfinal", "caps")}
    ms |= {k[3] for k in cache if isinstance(k, tuple) and k[0] == "dscum"}
    for m in sorted(ms):
        old_final = cache.get(("final", m))
        if old_final is None:
            continue                     # parameterized family never built
        suffix_final = _final_state_suffix(new.state[q:], new.length[q:], m)
        new_final = np.concatenate([old_final[:q], suffix_final])
        newc[("final", m)] = new_final
        old_sf = cache.get(("sfinal", m))
        if old_sf is None:
            continue
        new_sf = np.concatenate(
            [old_sf[:B], np.repeat(suffix_final, new.length[q:])])
        newc[("sfinal", m)] = new_sf

        if ("caps", m) in cache:
            old_caps = cache[("caps", m)]
            out: dict = {}
            ofs_b = old_sf[B:]
            nfs_b = new_sf[B:]
            for s in (_DEEP, _EXEC, _ACTIVE):
                kept = _multiset_delete(old_caps[s][0],
                                        np.sort(old.power[B:][ofs_b == s]))
                sp = _sorted_insert(kept,
                                    np.sort(new.power[B:][nfs_b == s]))
                top = np.concatenate([[0.0], np.cumsum(sp[::-1])])
                out[s] = (sp, top)
            # the penalty bucket has no min_samples dependence — old
            # samples never change membership, so it is insert-only
            pen_suf = np.repeat(new.resident_runs()[t:] & ~new.low[t:],
                                new.length[t:])
            sp = _sorted_insert(
                old_caps["penalty"][0],
                np.sort(new.power[old_n:][pen_suf[old_n - off_t:]]))
            top = np.concatenate([[0.0], np.cumsum(sp[::-1])])
            top_cbrt = np.concatenate([[0.0], np.cumsum(np.cbrt(sp[::-1]))])
            out["penalty"] = (sp, top, top_cbrt)
            newc[("caps", m)] = out

    for k in [k for k in cache if isinstance(k, tuple) and k[0] == "dscum"]:
        _, delta, deep_w, m = k
        new_sf = newc.get(("sfinal", m))
        if new_sf is None:
            continue
        old_ce, old_ca = cache[k]
        p = new.power[B:]
        sav = p - np.maximum(p - delta, deep_w)
        sav = np.where(np.repeat(new.resident_runs()[q:], new.length[q:]),
                       sav, 0.0)
        fs = new_sf[B:]
        newc[k] = tuple(
            np.concatenate([old_cum[:B + 1], np.cumsum(np.concatenate(
                [old_cum[B:B + 1], np.where(fs == want, sav, 0.0)]))[1:]])
            for old_cum, want in ((old_ce, _EXEC), (old_ca, _ACTIVE)))
    return new.n_rows - B


def _build_partition(root: str, shard_files: list[str], config: IRConfig,
                     mmap: bool, strict: bool = True,
                     verify: bool = False) -> tuple[IRBuilder, list[dict]]:
    """Process-pool worker body (module-level picklable)."""
    from repro_torch.telemetry.storage import TelemetryStore
    store = TelemetryStore(root)
    host_of = {s["file"]: s["host"] for s in store.manifest["shards"]}
    builder = IRBuilder(config)
    skips: list[dict] = []
    for name in shard_files:
        frame = store.read_shard_or_skip(name, skips, mmap=mmap,
                                         strict=strict, verify=verify)
        if frame is not None:
            builder.update(frame, host_label=host_of.get(name, ""))
    return builder, skips


def build_ir(store: "TelemetryStore", config: IRConfig | None = None,
             workers: int = 1, mmap: bool = False, strict: bool = True,
             verify: bool = False, fault=None) -> RunIR:
    """One O(rows) pass over the store: group, classify, low-flag, RLE.

    ``workers > 1`` partitions by host label exactly like the sweep; the
    result is identical for any worker count (per-stream decomposition is
    independent, streams are reassembled in sorted order).

    ``strict=False`` skips unreadable shards (recorded in
    :attr:`RunIR.skipped`) instead of raising — note a skipped mid-stream
    shard usually makes its streams irregular, so the build then raises
    :class:`IRUnsupportedError` and callers replay through the row path,
    exactly as they would on the clean shard subset.
    """
    from repro_torch.telemetry.pipeline import map_shard_partitions
    config = config or IRConfig()
    t0 = time.perf_counter()
    with obs.span("ir.build", workers=workers):
        builder, skips = map_shard_partitions(
            store, None, workers, _build_partition,
            (config, mmap, strict, verify),
            merge=lambda a, b: a.merge(b), stage="ir_build", fault=fault)
        ir = builder.finalize(source_rows=store.total_rows,
                              source_shards=len(store.manifest["shards"]))
        ir.skipped = tuple(skips)
    if obs.enabled():
        obs.counter("repro_ir_builds_total", help="fresh IR builds")
        obs.observe("repro_ir_build_seconds", time.perf_counter() - t0,
                    help="wall time of build_ir")
        obs.gauge("repro_ir_runs", float(ir.n_runs),
                  help="runs in the last-built IR")
        obs.gauge("repro_ir_rows", float(ir.n_rows),
                  help="source rows of the last-built IR")
        if ir.n_runs:
            obs.gauge("repro_ir_compaction_ratio", ir.compaction_ratio,
                      help="rows per run in the last-built IR")
    return ir


# --------------------------------------------------------------------------- #
# Policy support
# --------------------------------------------------------------------------- #
def _low_pair(policy: Policy) -> tuple[float, float] | None:
    if isinstance(policy, (DownscalePolicy, ParkingPolicy, PowerCapPolicy)):
        return (policy.config.activity_threshold,
                policy.config.comm_threshold_gbs)
    if isinstance(policy, CompositePolicy):
        pairs = {_low_pair(p) for p in policy.parts}
        pairs.discard(None)
        if len(pairs) == 1:
            return next(iter(pairs))
    return None


def ir_supported(policy: Policy, config: IRConfig) -> bool:
    """Can ``policy`` replay against an IR built with ``config``?

    Leaf families must share the IR's low-activity thresholds (the run
    decomposition bakes the flag in); composites must be the known
    parking-then-downscale shape (each part's effect stays run-structured
    because they touch disjoint residency); anything else — custom policies,
    other composite orders — replays through the row path.
    """
    pair = (config.activity_threshold, config.comm_threshold_gbs)
    if isinstance(policy, NoOpPolicy):
        return True
    if isinstance(policy, (DownscalePolicy, ParkingPolicy, PowerCapPolicy)):
        return _low_pair(policy) == pair
    if isinstance(policy, CompositePolicy):
        return (len(policy.parts) == 2
                and isinstance(policy.parts[0], ParkingPolicy)
                and isinstance(policy.parts[1], DownscalePolicy)
                and _low_pair(policy) == pair)
    return False


def ir_config_for(policies: Iterable[Policy],
                  classifier: ClassifierConfig = DEFAULT_CLASSIFIER,
                  dt_s: float = 1.0) -> IRConfig:
    """The :class:`IRConfig` covering the most grid configs: the modal
    low-threshold pair among the policies (ties broken deterministically
    by pair value); configs on other pairs fall back to the row path."""
    counts: dict[tuple[float, float], int] = {}
    for p in policies:
        pair = _low_pair(p)
        if pair is not None:
            counts[pair] = counts.get(pair, 0) + 1
    if not counts:
        pair = (ControllerConfig.activity_threshold,
                ControllerConfig.comm_threshold_gbs)
    else:
        pair = max(sorted(counts), key=lambda k: counts[k])
    return IRConfig(classifier=classifier, activity_threshold=pair[0],
                    comm_threshold_gbs=pair[1], dt_s=dt_s)


# --------------------------------------------------------------------------- #
# Sidecar persistence (next to the store's shards, keyed in the manifest)
# --------------------------------------------------------------------------- #
def sidecar_name(config: IRConfig) -> str:
    return f"run_ir_{config.config_hash()}.npz"


def save_sidecar(ir: RunIR, store: "TelemetryStore") -> pathlib.Path:
    """Persist the IR next to the shards and key it in the manifest.

    Format: one compressed ``.npz`` holding the stream table (keys, host
    labels, platforms, first timestamps, run/sample counts), the
    concatenated run arrays (state/low/length/power_sum) and the
    concatenated power samples; ``meta`` embeds the :class:`IRConfig`, the
    source row count and the **shard watermark** (``source_shards``: the
    covered prefix of the append-only manifest shard list, plus the
    per-chunk unattributed-power pairs). ``manifest["run_ir"][hash]``
    points at the file and mirrors the watermark (``n_shards`` +
    per-host covered row counts) — a changed classifier config hashes to a
    different sidecar; an appended store no longer invalidates wholesale
    but is caught up by :meth:`IRBuilder.extend` over the uncovered shard
    suffix (:func:`get_ir`'s ``memory_extend``/``sidecar_extend`` rungs),
    provided the covered prefix still sums to ``source_rows`` (a rewritten
    or quarantined prefix shard forces a full rebuild).
    """
    streams = [ir.streams[k] for k in sorted(ir.streams)]
    meta = json.dumps({"config": ir.config.to_dict(),
                       "source_rows": ir.source_rows,
                       "source_shards": ir.source_shards,
                       "unattributed": [[h, v] for h, v in ir.unattributed],
                       "skipped": list(ir.skipped)})
    arrays = {
        "meta": np.array(meta),
        "job": np.array([s.key[0] for s in streams], dtype=np.int64),
        "host": np.array([s.key[1] for s in streams], dtype=np.int64),
        "dev": np.array([s.key[2] for s in streams], dtype=np.int64),
        "host_label": np.array([s.host_label for s in streams]),
        "platform": np.array([s.platform_id for s in streams], dtype=np.int64),
        "ts_first": np.array([s.ts_first for s in streams]),
        "n_runs": np.array([s.n_runs for s in streams], dtype=np.int64),
        "n_rows": np.array([s.n_rows for s in streams], dtype=np.int64),
        "state": (np.concatenate([s.state for s in streams])
                  if streams else np.empty(0, np.int8)),
        "low": (np.concatenate([s.low for s in streams])
                if streams else np.empty(0, bool)),
        "length": (np.concatenate([s.length for s in streams])
                   if streams else np.empty(0, np.int64)),
        "power_sum": (np.concatenate([s.power_sum for s in streams])
                      if streams else np.empty(0)),
        "power": (np.concatenate([s.power for s in streams])
                  if streams else np.empty(0)),
    }
    name = sidecar_name(ir.config)
    path = store.root / name
    # commit through storage.atomic_replace: a process killed mid-write
    # leaves the previous sidecar (or none) fully intact, never a torn file
    from repro_torch.telemetry import storage as storage_mod
    storage_mod._write_atomic_npz(path, arrays)
    marks: dict[str, int] = {}
    for s in store.manifest["shards"][:ir.source_shards]:
        marks[s["host"]] = marks.get(s["host"], 0) + int(s["rows"])
    entry = {"file": name, "source_rows": ir.source_rows,
             "n_shards": ir.source_shards, "watermarks": marks,
             "config": ir.config.to_dict()}
    # atomic single-key merge: a concurrent appender's shard entries must
    # survive this derived-data write (see TelemetryStore.merge_manifest_key)
    store.merge_manifest_key(MANIFEST_KEY, ir.config.config_hash(), entry)
    return path


#: everything a torn/bit-flipped sidecar or poisoned manifest subtree can
#: raise through np.load/json/entry access — all mapped to "rebuild"
_SIDECAR_ERRORS = (zipfile.BadZipFile, zlib.error, ValueError, KeyError,
                   TypeError, OSError, EOFError)


def load_sidecar(store: "TelemetryStore", config: IRConfig,
                 allow_stale: bool = False) -> RunIR | None:
    """Load a sidecar if a *fresh* one exists: the manifest must key this
    config's hash and the persisted ``source_rows`` must still equal the
    store's row count (an appended store silently invalidates).
    ``allow_stale=True`` skips the freshness check — :func:`get_ir` uses it
    to load a stale-but-watermarked sidecar as the base of an incremental
    :meth:`IRBuilder.extend` instead of rebuilding from scratch.

    Tolerant by construction: a poisoned manifest subtree, a missing file,
    or a corrupt/truncated archive (``BadZipFile``, CRC errors, bad JSON
    meta) is counted as a ``sidecar -> rebuild`` fallback, the bad file is
    deleted, and ``None`` is returned so the caller rebuilds from shards —
    derived data is never allowed to take down the pipeline."""
    raw = store.manifest.get(MANIFEST_KEY)
    entry = raw.get(config.config_hash()) if isinstance(raw, dict) else None
    if not isinstance(entry, dict):
        return None
    try:
        if not allow_stale and int(entry["source_rows"]) != store.total_rows:
            obs.counter("repro_ir_cache_invalidations_total", level="sidecar",
                        help="cached IRs rejected as stale")
            return None
        path = store.root / str(entry["file"])
    except _SIDECAR_ERRORS:
        obs.fallback("sidecar", "rebuild", "bad_manifest_entry")
        return None
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            src_rows = int(meta["source_rows"])
            src_shards = int(meta.get("source_shards", 0))
            unattr = tuple((str(h), float(v))
                           for h, v in meta.get("unattributed", ()))
            skipped = tuple(meta.get("skipped", ()))
            loaded_cfg = IRConfig.from_dict(meta["config"])
            if loaded_cfg != config:
                obs.counter("repro_ir_cache_invalidations_total",
                            level="sidecar",
                            help="cached IRs rejected as stale")
                return None
            run_off = np.concatenate(
                [[0], np.cumsum(z["n_runs"])]).astype(np.int64)
            row_off = np.concatenate(
                [[0], np.cumsum(z["n_rows"])]).astype(np.int64)
            streams: dict[tuple[int, int, int], StreamIR] = {}
            for i in range(z["job"].shape[0]):
                r0, r1 = run_off[i], run_off[i + 1]
                p0, p1 = row_off[i], row_off[i + 1]
                key = (int(z["job"][i]), int(z["host"][i]), int(z["dev"][i]))
                streams[key] = StreamIR(
                    key=key,
                    host_label=str(z["host_label"][i]),
                    platform_id=int(z["platform"][i]),
                    ts_first=float(z["ts_first"][i]),
                    dt_s=config.dt_s,
                    state=z["state"][r0:r1].astype(np.int8),
                    low=z["low"][r0:r1].astype(bool),
                    length=z["length"][r0:r1].astype(np.int64),
                    power_sum=np.array(z["power_sum"][r0:r1]),
                    power=np.array(z["power"][p0:p1]),
                )
    except _SIDECAR_ERRORS as e:
        obs.fallback("sidecar", "rebuild", type(e).__name__)
        try:
            path.unlink(missing_ok=True)
        except OSError:
            pass
        return None
    return RunIR(config=config, streams=streams,
                 source_rows=src_rows, skipped=skipped,
                 source_shards=src_shards, unattributed=unattr)


def _try_extend(store: "TelemetryStore", ir: RunIR, mmap: bool,
                strict: bool, verify: bool) -> RunIR | None:
    """Catch a stale IR up to the store by appending only the new shards.

    Valid only while the covered manifest prefix is untouched: the first
    ``ir.source_shards`` entries must still sum to ``ir.source_rows`` (a
    rewritten, quarantined or reordered prefix shard breaks the watermark).
    Returns ``None`` when extension is impossible — irregular appended
    streams included — so the caller falls through to a full rebuild,
    which then *defines* the semantics. Suffix-shard read errors propagate
    under ``strict=True`` exactly as a rebuild's would; under
    ``strict=False`` they become skip records on the returned IR.
    """
    shards = store.manifest["shards"]
    k = ir.source_shards
    if not 0 < k <= len(shards):
        return None
    if sum(int(s["rows"]) for s in shards[:k]) != ir.source_rows:
        return None
    skips: list[dict] = []
    chunks = []
    with obs.span("ir.extend", shards=len(shards) - k):
        for s in shards[k:]:
            frame = store.read_shard_or_skip(s["file"], skips, mmap=mmap,
                                             strict=strict, verify=verify)
            if frame is not None:
                chunks.append((frame, s.get("host", "")))
        try:
            out = IRBuilder(ir.config).extend(
                ir, chunks, source_rows=store.total_rows,
                source_shards=len(shards))
        except IRUnsupportedError:
            return None
    out.skipped = tuple(ir.skipped) + tuple(skips)
    return out


#: in-process cache: (resolved store root, config hash) -> RunIR. An IR
#: pins the store's power column (~8 bytes/row) plus the run tables in
#: memory, so the cache is a small LRU rather than unbounded.
_IR_CACHE: dict[tuple[str, str], RunIR] = {}
_IR_CACHE_MAX = 4
#: negative cache: builds that raised IRUnsupportedError, keyed with the
#: row count they failed at — a search over an irregular store fails the
#: build once, not once per refinement round
_IR_UNSUPPORTED: dict[tuple[str, str], tuple[int, str]] = {}


def get_ir(store: "TelemetryStore", config: IRConfig | None = None,
           workers: int = 1, mmap: bool = False,
           persist: bool = True, strict: bool = True,
           verify: bool = False, fault=None) -> RunIR:
    """The IR acquisition ladder: in-memory cache, then incremental
    *extension* of a stale cached IR (:func:`_try_extend`: only the
    appended shards are read, only the appended-to streams' tails rebuilt
    — untouched streams keep their object identity and memo caches), then
    a fresh sidecar, then extension of a stale-but-watermarked sidecar,
    then a fresh build. Extended and built IRs are persisted back as
    sidecars unless ``persist=False`` or the store root is not writable.
    A store whose build failed (:class:`IRUnsupportedError`, e.g.
    irregular sampling) re-raises from a negative cache until the store
    changes, so callers that fall back to the row path don't pay a doomed
    O(rows) build per call.

    Cache hits additionally require that a cached IR built with skipped
    shards (``strict=False`` on a dirty store) is never served to a
    ``strict=True`` caller — degraded derived data must not silently
    masquerade as complete."""
    config = config or IRConfig()
    cache_key = (str(pathlib.Path(store.root).resolve()),
                 config.config_hash())
    failed = _IR_UNSUPPORTED.get(cache_key)
    if failed is not None and failed[0] == store.total_rows:
        obs.counter("repro_ir_negative_cache_hits_total",
                    help="IR builds skipped via the unsupported-store cache")
        raise IRUnsupportedError(failed[1])

    def _finish(ir: RunIR, save: bool) -> RunIR:
        if save and persist:
            try:
                save_sidecar(ir, store)
            except OSError:
                pass                    # read-only store: memory cache only
        _IR_CACHE.pop(cache_key, None)
        _IR_CACHE[cache_key] = ir       # (re-)insert at LRU head
        while len(_IR_CACHE) > _IR_CACHE_MAX:  # dicts keep insert order
            _IR_CACHE.pop(next(iter(_IR_CACHE)))
        return ir

    ir = _IR_CACHE.get(cache_key)
    if ir is not None and not (ir.skipped and strict):
        if ir.source_rows == store.total_rows:
            obs.counter("repro_ir_cache_hits_total", level="memory",
                        help="IR acquisitions served from a cache level")
            return _finish(ir, save=False)
        ext = _try_extend(store, ir, mmap, strict, verify)
        if ext is not None and not (ext.skipped and strict):
            obs.counter("repro_ir_cache_hits_total", level="memory_extend",
                        help="IR acquisitions served from a cache level")
            return _finish(ext, save=True)
    if ir is not None:
        obs.counter("repro_ir_cache_invalidations_total", level="memory",
                    help="cached IRs rejected as stale")
    ir = load_sidecar(store, config)
    if ir is not None and ir.skipped and strict:
        obs.counter("repro_ir_cache_invalidations_total", level="sidecar",
                    help="cached IRs rejected as stale")
        ir = None
    if ir is not None:
        obs.counter("repro_ir_cache_hits_total", level="sidecar",
                    help="IR acquisitions served from a cache level")
        return _finish(ir, save=False)
    stale = load_sidecar(store, config, allow_stale=True)
    if stale is not None and stale.source_rows != store.total_rows \
            and not (stale.skipped and strict):
        ext = _try_extend(store, stale, mmap, strict, verify)
        if ext is not None and not (ext.skipped and strict):
            obs.counter("repro_ir_cache_hits_total", level="sidecar_extend",
                        help="IR acquisitions served from a cache level")
            return _finish(ext, save=True)
    obs.counter("repro_ir_cache_misses_total",
                help="IR acquisitions that required a fresh build")
    try:
        ir = build_ir(store, config, workers=workers, mmap=mmap,
                      strict=strict, verify=verify, fault=fault)
    except IRUnsupportedError as e:
        _IR_UNSUPPORTED[cache_key] = (store.total_rows, str(e))
        raise
    return _finish(ir, save=True)
