"""Atomic live-controller checkpoints: watermark + frontier + tick counter.

The checkpoint is the *only* durable controller state. Everything else the
tick loop touches is either the telemetry store itself (append-only,
producer-owned) or derived data that is safe at any staleness (run-IR
sidecars re-validate their own shard watermark; the published knee is a
pure function of the checkpointed frontier). That makes the crash-point
analysis short — after ``kill -9`` at *any* instant, restart state is one
of exactly two things:

* **the previous checkpoint** (crash anywhere before the rename commits,
  including mid-checkpoint-write: the temp file is orphaned, the
  destination untouched) — the controller re-polls, sees the same shards
  past its watermark, and re-runs the tick. Ingest is at-least-once, but
  the watermark makes it idempotent: the re-run tick folds the same shard
  suffix into the same IR (``IRBuilder.extend`` == rebuild, bit-identical)
  and re-runs the same deterministic search warm-started from the same
  serialized frontier, producing the same frontier it would have produced
  uninterrupted;
* **the new checkpoint** (crash after the rename, e.g. before the knee
  republish) — the controller resumes past the tick and republishes the
  knee from the checkpointed frontier, which is the same artifact.

Bit-identity across the restart additionally requires that warm-starting
from a *deserialized* frontier equals warm-starting from the in-memory
one; the controller guarantees that by construction — it round-trips every
frontier through this codec before using it as ``init_frontier``, so the
uninterrupted run and the resumed run seed round 0 from byte-identical
state (see :class:`repro_torch.live.controller.LiveController`).

Writes commit through :func:`repro_torch.telemetry.storage.atomic_replace` — the
same single commit point as every manifest/shard/sidecar write — so the
fault harness (:func:`repro_torch.testing.faults.dying_renames`) and the
fire-once ``kill -9`` plan (stage :data:`MID_CHECKPOINT_STAGE`,
fired between the temp write and the rename) exercise the torn-write case
deterministically. Loads are tolerant: a corrupt or unparsable checkpoint
counts ``repro_fallbacks_total{reason="checkpoint_corrupt"}`` and returns
``None`` (cold start); a checkpoint whose shard watermark no longer
matches the store's covered prefix (a rewritten or quarantined shard
inside it) counts ``reason="watermark_broken"`` and also cold-starts.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib

import repro_torch.obs as obs
from repro_torch.telemetry import storage

SCHEMA_VERSION = 1
#: fault-plan stage name for the kill point between the checkpoint temp
#: write and its atomic rename (see repro_torch.testing.faults.check)
MID_CHECKPOINT_STAGE = "live_mid_checkpoint"


def fault_hook(stage: str) -> None:
    """Tick-phase fault-injection point: delegates to
    :func:`repro_torch.testing.faults.check` only when a plan is active
    (``REPRO_FAULT_PLAN``), so the production path never imports the
    harness. Module-level — like ``storage.atomic_replace`` — so
    in-process tests patch one name to simulate a crash at any tick-phase
    boundary; fire-once plans make it a real ``os._exit`` in a child
    process."""
    plan = os.environ.get("REPRO_FAULT_PLAN")
    if plan:
        from repro_torch.testing import faults
        faults.check(stage, plan)


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """One committed controller state.

    ``n_shards``/``source_rows`` are the shard watermark: the covered
    prefix length of the append-only ``manifest["shards"]`` list plus the
    row total of that prefix (the validity check — rewriting or
    quarantining a covered shard changes the sum and voids the
    checkpoint). ``frontier`` is the :func:`repro_torch.whatif.report
    .frontier_to_dict` payload of the last published frontier (``None``
    until the first successful tick)."""

    tick: int
    n_shards: int
    source_rows: int
    generation: int
    frontier: dict | None


def save_checkpoint(ckpt: Checkpoint,
                    path: str | pathlib.Path) -> pathlib.Path:
    """Commit a checkpoint atomically: temp write, the
    ``live_mid_checkpoint`` fault hook (fires after the temp file is fully
    written but before the rename — the torn-write instant), then the
    rename through ``storage.atomic_replace``."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"schema_version": SCHEMA_VERSION,
               "tick": ckpt.tick, "n_shards": ckpt.n_shards,
               "source_rows": ckpt.source_rows,
               "generation": ckpt.generation,
               "frontier": ckpt.frontier}
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(payload, separators=(",", ":")) + "\n")
    fault_hook(MID_CHECKPOINT_STAGE)
    storage.atomic_replace(tmp, path)
    obs.counter("repro_live_checkpoint_writes_total",
                help="live controller checkpoints committed (atomic rename)")
    return path


def load_checkpoint(path: str | pathlib.Path,
                    store=None) -> Checkpoint | None:
    """Tolerant restore. ``None`` means cold start: no checkpoint on disk,
    a corrupt one (``repro_fallbacks_total{reason="checkpoint_corrupt"}``),
    or — when a ``store`` is given — a watermark that no longer matches the
    store's covered shard prefix (``reason="watermark_broken"``)."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        payload = json.loads(path.read_text())
        if not isinstance(payload, dict):
            raise ValueError("checkpoint is not an object")
        ckpt = Checkpoint(
            tick=int(payload["tick"]), n_shards=int(payload["n_shards"]),
            source_rows=int(payload["source_rows"]),
            generation=int(payload.get("generation", 0)),
            frontier=payload.get("frontier"))
        if ckpt.frontier is not None and not isinstance(ckpt.frontier, dict):
            raise ValueError("checkpoint frontier is not an object")
        if ckpt.n_shards < 0 or ckpt.source_rows < 0:
            raise ValueError("negative watermark")
    except (OSError, ValueError, KeyError, TypeError) as e:
        obs.fallback("checkpoint", "cold_start", "checkpoint_corrupt")
        obs.counter("repro_live_checkpoint_corrupt_total",
                    reason=type(e).__name__,
                    help="checkpoint loads rejected as corrupt")
        return None
    if store is not None and not watermark_valid(ckpt, store):
        obs.fallback("checkpoint", "cold_start", "watermark_broken")
        return None
    obs.counter("repro_live_checkpoint_restores_total",
                help="live controller restarts resumed from a valid "
                     "checkpoint")
    return ckpt


def watermark_valid(ckpt: Checkpoint, store) -> bool:
    """True iff the checkpoint's covered shard prefix still exists
    unchanged: at least ``n_shards`` manifest entries, and their rows sum
    to ``source_rows`` (same invariant the run-IR sidecar watermark uses,
    :func:`repro_torch.whatif.ir._try_extend`)."""
    shards = store.manifest["shards"]
    if ckpt.n_shards > len(shards):
        return False
    covered = sum(int(s["rows"]) for s in shards[:ckpt.n_shards])
    return covered == ckpt.source_rows


def remove_checkpoint(path: str | pathlib.Path) -> None:
    """Delete a checkpoint (and any orphaned temp file) — test helper and
    operator reset."""
    path = pathlib.Path(path)
    for p in (path, path.with_name(path.name + ".tmp")):
        try:
            os.unlink(p)
        except OSError:
            pass
