"""Deterministic fault injection for the robustness layer.

Three families of faults, all reproducible (no randomness, no wall-clock):

* **File corruptors** — :func:`truncate_file`, :func:`bitflip_file`,
  :func:`poison_json`, :func:`corrupt_npy_dir`, :func:`corrupt_checkpoint`
  and :func:`skew_shard` damage shard/manifest/checkpoint bytes in place,
  the way a full disk, a torn copy, silent media corruption or a stepped
  clock would.
* **Process faults** — a *fault plan* written to disk and advertised via the
  ``REPRO_FAULT_PLAN`` environment variable. :func:`check` is the hook at
  the top of every pool worker submission
  (:func:`repro_torch.telemetry.pipeline._partition_body`, which receives
  the path as a task argument captured in the parent: forkserver children
  keep the fork server's original environment, so the env var alone would
  go stale) and at the live controller's tick-phase boundaries
  (:func:`repro_torch.live.checkpoint.fault_hook`). A stage listed in the
  plan's ``crash`` list makes the *first* process to claim the marker file
  die with ``os._exit`` (an un-catchable hard crash, exactly what an
  OOM-kill or ``kill -9`` looks like), ``hang`` sleeps instead. Markers are
  claimed with ``O_CREAT | O_EXCL``, so each fault fires exactly once per
  plan — retried pool attempts and relaunched processes run clean, which is
  what lets tests assert the retry and resume paths deterministically. The
  installer's own process never faults (``installer_pid`` guard), so
  degraded in-process execution is safe.
* **Kill-mid-write** — :func:`dying_renames` patches
  :func:`repro_torch.telemetry.storage.atomic_replace` (the single commit
  point of every manifest/shard/sidecar/checkpoint write) to raise,
  simulating a process killed after the temp file is written but before
  the rename commits.

Everything here is stdlib-only and import-free on the hot path: the
pipelines and the live controller only import this module when a plan is
set.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time

#: environment variable holding the fault-plan path; also read by
#: repro_torch.telemetry.pipeline._fault_plan and
#: repro_torch.live.checkpoint.fault_hook, so neither imports this module
#: unless a plan is active
ENV_PLAN = "REPRO_FAULT_PLAN"
#: exit status of an injected crash (distinguishable from a real segfault)
CRASH_EXIT_CODE = 13


# --------------------------------------------------------------------------- #
# File corruptors
# --------------------------------------------------------------------------- #
def truncate_file(path: str | pathlib.Path, keep_fraction: float = 0.5) -> None:
    """Cut a file to ``keep_fraction`` of its bytes (min 1) — a torn write
    or full-disk copy. Deterministic for a given input."""
    path = pathlib.Path(path)
    data = path.read_bytes()
    path.write_bytes(data[:max(1, int(len(data) * keep_fraction))])


def bitflip_file(path: str | pathlib.Path, offset: int | None = None,
                 bit: int = 0) -> None:
    """Flip one bit in place (default: the middle byte) — silent media
    corruption. Against an ``npz`` the zip CRC catches it at read; against
    a raw ``npy`` only a recorded sha256 can (``read_shard(verify=True)``)."""
    path = pathlib.Path(path)
    data = bytearray(path.read_bytes())
    if not data:
        return
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 1 << bit
    path.write_bytes(bytes(data))


def poison_json(path: str | pathlib.Path) -> None:
    """Overwrite a JSON file with a truncated, unparseable payload."""
    pathlib.Path(path).write_text('{"shards": [{"file": "tele')


def corrupt_npy_dir(path: str | pathlib.Path,
                    column: str = "power.npy") -> None:
    """Truncate one column file of an ``npy_dir`` shard."""
    truncate_file(pathlib.Path(path) / column)


def corrupt_checkpoint(path: str | pathlib.Path,
                       mode: str = "truncate") -> None:
    """Damage a live-controller checkpoint file in place. ``truncate`` cuts
    it mid-JSON (a torn copy), ``poison`` overwrites it with an unparseable
    payload that still *looks* like a checkpoint, ``bitflip`` flips one
    byte. The controller must respond with a
    ``repro_fallbacks_total{reason="checkpoint_corrupt"}`` and a cold
    start, never a crash."""
    if mode == "truncate":
        truncate_file(path, keep_fraction=0.4)
    elif mode == "poison":
        pathlib.Path(path).write_text('{"schema_version": 1, "tick": 3, "fr')
    elif mode == "bitflip":
        bitflip_file(path)
    else:
        raise ValueError(f"unknown corrupt_checkpoint mode {mode!r}")


def skew_shard(store, name: str, skew_s: float = -3600.0) -> None:
    """Backwards-timestamp / clock-skew corruptor: rewrite one shard with
    every timestamp shifted by ``skew_s`` (negative = the producer's clock
    stepped backwards), checksum recomputed — a byte-valid shard whose
    *semantics* are poisoned. Downstream, per-stream time-ordering checks
    (FleetAccumulator, the replayers, the IR builder) reject the stream;
    the live controller must degrade to serving its stale knee, flagged,
    instead of crashing."""
    from repro_torch.telemetry.records import TelemetryFrame

    frame = store.read_shard(name)
    cols = dict(frame.columns)
    cols["timestamp"] = cols["timestamp"] + float(skew_s)
    store.rewrite_shard(name, TelemetryFrame(cols))
    store.save_manifest()


# --------------------------------------------------------------------------- #
# Process fault plan (crash / hang at a named stage)
# --------------------------------------------------------------------------- #
def install_plan(plan_dir: str | pathlib.Path, crash: tuple | list = (),
                 hang: tuple | list = (), hang_s: float = 60.0) -> pathlib.Path:
    """Write a fault plan and export ``REPRO_FAULT_PLAN`` so child processes
    (which inherit the environment) pick it up. ``crash``/``hang`` list the
    stage names whose first occurrence in a child should die/stall: the
    pipeline stages (``"analyze"``, ``"sweep"``, ``"ir_build"``,
    ``"replay_ir"``) and the live controller's (``"live_pre_extend"``,
    ``"live_pre_checkpoint"``, ``"live_mid_checkpoint"``)."""
    plan_dir = pathlib.Path(plan_dir)
    plan_dir.mkdir(parents=True, exist_ok=True)
    plan = {"installer_pid": os.getpid(), "dir": str(plan_dir),
            "crash": list(crash), "hang": list(hang),
            "hang_s": float(hang_s)}
    path = plan_dir / "fault_plan.json"
    path.write_text(json.dumps(plan))
    os.environ[ENV_PLAN] = str(path)
    return path


def clear_plan() -> None:
    os.environ.pop(ENV_PLAN, None)


@contextlib.contextmanager
def plan(plan_dir: str | pathlib.Path, **kwargs):
    """``with faults.plan(tmpdir, crash=["live_pre_extend"]): ...`` — install a
    fault plan for the duration of the block."""
    install_plan(plan_dir, **kwargs)
    try:
        yield
    finally:
        clear_plan()


def _claim(marker: pathlib.Path) -> bool:
    """Atomically claim a fire-once marker (O_CREAT|O_EXCL): exactly one
    process ever wins, so each planned fault fires once."""
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    os.close(fd)
    return True


def check(stage: str, plan_path: str | None = None) -> None:
    """Fault hook, called at each named stage. No-op unless a plan is
    installed, the caller is *not* the installing process (so the process
    that set the plan up never kills itself), and the stage's fire-once
    marker is still unclaimed. ``plan_path`` defaults to the
    ``REPRO_FAULT_PLAN`` environment variable; pool workers get it passed
    explicitly (see ``pipeline._fault_plan``)."""
    plan_path = plan_path or os.environ.get(ENV_PLAN)
    if not plan_path:
        return
    try:
        spec = json.loads(pathlib.Path(plan_path).read_text())
    except (OSError, ValueError):
        return
    if os.getpid() == spec.get("installer_pid"):
        return
    plan_dir = pathlib.Path(spec.get("dir", "."))
    if stage in spec.get("crash", ()) and _claim(
            plan_dir / f"crash_{stage}.fired"):
        os._exit(CRASH_EXIT_CODE)
    if stage in spec.get("hang", ()) and _claim(
            plan_dir / f"hang_{stage}.fired"):
        time.sleep(float(spec.get("hang_s", 60.0)))


# --------------------------------------------------------------------------- #
# Kill-mid-write
# --------------------------------------------------------------------------- #
class SimulatedKill(RuntimeError):
    """Raised in place of the atomic rename — the write never commits."""


@contextlib.contextmanager
def dying_renames():
    """Make every :func:`repro_torch.telemetry.storage.atomic_replace` raise
    :class:`SimulatedKill`: the temp file is fully written, the rename never
    happens — the observable state of a process killed at the commit
    boundary. Atomicity tests assert the destination is untouched."""
    from repro_torch.telemetry import storage

    original = storage.atomic_replace

    def die(tmp, dst):
        raise SimulatedKill(f"killed before rename of {dst}")

    storage.atomic_replace = die
    try:
        yield
    finally:
        storage.atomic_replace = original
