"""The always-on ingest → extend → search tick loop.

One :meth:`LiveController.tick` is the paper's recommendation loop made
live: poll the :class:`~repro_torch.telemetry.storage.TelemetryStore` for
shards past the controller's watermark (O(1) —
:meth:`TelemetryStore.refresh` is one ``stat`` when nothing landed), fold
the pending suffix into the run-level IR via the
:func:`repro_torch.whatif.ir.get_ir` extend ladder (which happens *inside*
``search_frontier``'s single IR acquisition — per-tick cost O(new rows),
not O(store)), re-run the Pareto search warm-started from the previous
frontier (``init_frontier=``) — on the torch backend that is the what-if
replay on the card, the cap-bucket scan and the Algorithm-1 cooldown chain
among its kernels — checkpoint, and publish the refreshed knee.

Backpressure, not queueing: a tick that falls behind finds *all* pending
shards past the watermark and coalesces them into one extend + one search
(``repro_live_coalesced_shards_total`` counts the backlog beyond the
first). There is no queue to bound — the watermark is the queue.

Crash safety (see :mod:`repro_torch.live.checkpoint` for the full ordering
argument): the tick commits its checkpoint *after* the search and *before*
the publish, and the controller warm-starts every search from the
JSON-round-tripped frontier — the exact bytes a restart would load — so a
resumed run and an uninterrupted run over the same shard sequence produce
**bit-identical** frontiers, on the card too, since the torch backend's
replay is deterministic run to run and process to process.

Failure ladder (:mod:`repro_torch.live.supervisor`): torch → numpy, warm →
cold, then serve the stale knee flagged (``result="stale"``) with the
watermark held — poisoned data (e.g. a clock-skewed shard,
:func:`repro_torch.testing.faults.skew_shard`) degrades freshness, never
liveness. A broken device path is not data: the torch rung descends only
on errors of the host's IR acquisition, and any error past it (a kernel
or CUDA error, a wrapper's guard, out of memory) or a deadline miss on the
card propagates out of :meth:`LiveController.tick`. Unreadable
shards don't even get that far: the live loop runs ``strict=False`` by
default, so they are skipped with coverage accounting
(``TickResult.coverage < 1``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import repro_torch.obs as obs
from repro_torch.device import resolve_device
from repro_torch.live.checkpoint import (Checkpoint, fault_hook,
                                         load_checkpoint, save_checkpoint)
from repro_torch.live.supervisor import (DEFAULT_TICK_FAULT, Rung,
                                         TickSupervisor)
from repro_torch.telemetry import storage
from repro_torch.telemetry.pipeline import FaultTolerance
from repro_torch.whatif.report import frontier_from_dict, frontier_to_dict
from repro_torch.whatif.search import (PenaltyBudget, find_knee,
                                       search_frontier)
from repro_torch.whatif.sweep import Frontier, PolicyOutcome

#: fault-plan stage fired after the poll found pending shards, before any
#: of them is folded in (post-ingest / pre-extend)
PRE_EXTEND_STAGE = "live_pre_extend"
#: fault-plan stage fired after extend+search, before the checkpoint commit
PRE_CHECKPOINT_STAGE = "live_pre_checkpoint"


@dataclasses.dataclass
class LiveConfig:
    """Controller knobs. ``backend`` is the warm rung's replay backend,
    ``"torch"`` (the card) or ``"numpy"`` (the host oracle); ``device`` is
    where the controller runs, ``"cuda"`` (raises without CUDA) or
    ``"cpu"`` (the kernels' plain versions). ``search_kwargs`` passes
    straight through to :func:`repro_torch.whatif.search.search_frontier`
    (e.g. ``max_rounds``, ``min_job_duration_s``, ``families``); ``fault``
    supervises both the tick ladder and — threaded through the search — the
    pool partitions inside it. ``workers`` and ``mmap`` pass to the search
    too: the host work (IR builds, the row path) spreads over a process
    pool whose workers never touch the card."""

    backend: str = "torch"
    device: str = "cuda"
    max_evals: int = 64
    budget: Optional[PenaltyBudget] = None
    workers: int = 1
    mmap: bool = False
    strict: bool = False        # live loops skip bad shards, account coverage
    verify: bool = False
    fault: FaultTolerance = dataclasses.field(
        default_factory=lambda: DEFAULT_TICK_FAULT)
    search_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TickResult:
    """What one tick did. ``result`` is ``"refreshed"`` (new knee
    published), ``"idle"`` (no shards past the watermark) or ``"stale"``
    (ladder exhausted: the previous knee is served, flagged, and the
    watermark did not advance)."""

    tick: int
    result: str
    n_new_shards: int = 0
    coalesced: int = 0
    rung: Optional[str] = None
    staleness_s: float = 0.0
    frontier: Optional[Frontier] = None
    knee: Optional[PolicyOutcome] = None
    coverage: float = 1.0
    error: Optional[str] = None

    @property
    def stale(self) -> bool:
        return self.result == "stale"


class LiveController:
    """The tick loop. Construct over a store (+ checkpoint path) and call
    :meth:`tick` forever — from :mod:`repro_torch.launch.live`'s daemon, a
    scheduler, or a test driving it shard by shard. Restores itself from
    the checkpoint on construction (tolerantly: a corrupt checkpoint
    cold-starts with a ``repro_fallbacks_total{reason="checkpoint_corrupt"}``
    instead of crashing).

    On a CUDA device with the torch backend, construction loads (building
    first if needed) the kernel library, outside the tick ladder: a missing
    ``nvcc`` or a failed build raises here, never as a stale tick."""

    def __init__(self, store, checkpoint_path, config: LiveConfig | None = None,
                 publish_path=None):
        self.store = store
        self.checkpoint_path = checkpoint_path
        self.config = config or LiveConfig()
        self.publish_path = publish_path
        if self.config.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {self.config.backend!r}; "
                             f"use 'torch' or 'numpy'")
        self.device = resolve_device(self.config.device)
        if self.config.backend == "torch" and self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.library()
        self.supervisor = TickSupervisor(self.config.fault,
                                         self.config.backend)
        self.tick_no = 0
        self.n_shards = 0          # shard watermark: covered prefix length
        self.source_rows = 0       # rows in that prefix (validity check)
        self._frontier: Frontier | None = None
        ckpt = load_checkpoint(checkpoint_path, store) \
            if checkpoint_path is not None else None
        if ckpt is not None:
            self.tick_no = ckpt.tick
            self.n_shards = ckpt.n_shards
            self.source_rows = ckpt.source_rows
            if ckpt.frontier is not None:
                self._frontier = frontier_from_dict(ckpt.frontier)
            # publish is idempotent — a crash between checkpoint and
            # publish re-emits the same knee here
            self._publish(stale=False)

    # ------------------------------------------------------------- state
    @property
    def frontier(self) -> Frontier | None:
        return self._frontier

    @property
    def knee(self) -> PolicyOutcome | None:
        if self._frontier is None or not self._frontier.outcomes:
            return None
        return find_knee(self._frontier.outcomes)

    # -------------------------------------------------------------- tick
    def tick(self) -> TickResult:
        """One poll → extend → search → checkpoint → publish cycle."""
        with obs.span("live.tick", tick=self.tick_no):
            return self._tick()

    def _tick(self) -> TickResult:
        cfg = self.config
        self.store.refresh()
        landed_at = self._manifest_mtime()
        pending = self.store.shards_since(self.n_shards)
        if not pending:
            obs.counter("repro_live_ticks_total", result="idle",
                        help="live controller ticks, labelled {result}")
            return TickResult(tick=self.tick_no, result="idle",
                              frontier=self._frontier, knee=self.knee)
        fault_hook(PRE_EXTEND_STAGE)
        coalesced = len(pending) - 1
        if coalesced:
            obs.counter("repro_live_coalesced_shards_total",
                        float(coalesced),
                        help="pending shards beyond the first folded into "
                             "one extend (backpressure)")
        # watermark target captured at poll time: exactly the shards this
        # tick folds in (the manifest snapshot is what the search reads)
        target_shards = len(self.store.manifest["shards"])
        target_rows = self.store.total_rows

        def attempt(rung: Rung):
            init = self._frontier if rung.warm else None
            return search_frontier(
                self.store, budget=cfg.budget, max_evals=cfg.max_evals,
                workers=cfg.workers, mmap=cfg.mmap, backend=rung.backend,
                device=cfg.device, init_frontier=init, strict=cfg.strict,
                verify=cfg.verify, fault=cfg.fault, **cfg.search_kwargs)

        res, rung, err = self.supervisor.run(attempt)
        fault_hook(PRE_CHECKPOINT_STAGE)
        if res is None:
            # ladder exhausted: serve the stale knee, flagged; the
            # watermark holds so the data stays pending — freshness
            # degrades, liveness doesn't
            reason = type(err).__name__ if err is not None else "deadline"
            obs.fallback("live_tick", "stale_knee", reason)
            obs.counter("repro_live_ticks_total", result="stale",
                        help="live controller ticks, labelled {result}")
            self._publish(stale=True)
            return TickResult(
                tick=self.tick_no, result="stale",
                n_new_shards=len(pending), coalesced=coalesced,
                frontier=self._frontier, knee=self.knee,
                error=reason if err is None else f"{reason}: {err}")

        # normalize through the checkpoint codec so the in-memory
        # continuation and a restart warm-start from byte-identical state
        # (the crux of the bit-identical-resume contract)
        payload = frontier_to_dict(res.frontier)
        self._frontier = frontier_from_dict(payload)
        self.tick_no += 1
        self.n_shards = target_shards
        self.source_rows = target_rows
        if self.checkpoint_path is not None:
            with obs.span("live.checkpoint"):
                save_checkpoint(
                    Checkpoint(tick=self.tick_no, n_shards=self.n_shards,
                               source_rows=self.source_rows,
                               generation=self.store.generation,
                               frontier=payload),
                    self.checkpoint_path)
        self._publish(stale=False)
        staleness = max(0.0, time.time() - landed_at)
        obs.observe("repro_live_staleness_seconds", staleness,
                    help="seconds from shard landing to the refreshed knee "
                         "being published")
        obs.counter("repro_live_ticks_total", result="refreshed",
                    help="live controller ticks, labelled {result}")
        return TickResult(
            tick=self.tick_no, result="refreshed",
            n_new_shards=len(pending), coalesced=coalesced,
            rung=rung.name if rung is not None else None,
            staleness_s=staleness, frontier=self._frontier, knee=self.knee,
            coverage=res.frontier.coverage)

    def run(self, max_ticks: int, interval_s: float = 0.0,
            stop_when_idle: bool = False) -> list[TickResult]:
        """Drive up to ``max_ticks`` ticks (the daemon loop's inner body);
        ``stop_when_idle`` exits on the first idle tick — the drain-then-
        stop shape batch tests and the bench use."""
        results = []
        for _ in range(max_ticks):
            r = self.tick()
            results.append(r)
            if stop_when_idle and r.result == "idle":
                break
            if interval_s > 0:
                time.sleep(interval_s)
        return results

    # ----------------------------------------------------------- helpers
    def _manifest_mtime(self) -> float:
        """Landing time of the newest append: the manifest's mtime (every
        append commits through the manifest rename) — the staleness clock's
        start."""
        try:
            return os.stat(self.store.root / storage.MANIFEST_NAME).st_mtime
        except OSError:
            return time.time()

    def _publish(self, stale: bool) -> None:
        """Atomically publish the current knee (idempotent: a pure function
        of the checkpointed frontier, so re-publishing after a restart
        re-emits the same artifact)."""
        if self.publish_path is None:
            return
        knee = self.knee
        if knee is None:
            return
        import json
        import pathlib
        path = pathlib.Path(self.publish_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"tick": self.tick_no, "stale": bool(stale),
                   "params": knee.params,
                   "energy_saved_j": knee.energy_saved_j,
                   "saved_fraction": knee.saved_fraction,
                   "penalty_s": knee.penalty_s}
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(payload, sort_keys=True, default=str) + "\n")
        storage.atomic_replace(tmp, path)
