"""Compressed telemetry log storage (paper §2.1: 20–100 MB/server/day).

Two shard formats behind one manifest:

* ``npz`` (default) — columnar zip-deflate ``.npz``, smallest on disk;
* ``npy_dir`` — one raw ``.npy`` per column in a shard directory, readable
  with ``np.load(mmap_mode="r")`` so ``iter_shards(mmap=True)`` is
  zero-copy: columns a pass never touches (e.g. host counters during a
  what-if sweep) are never faulted into memory.

Append-oriented: writers append shards labelled (host, day) — possibly
several per label, e.g. one per device or per flush — and a reader
concatenates (or streams) shards in manifest order.

Run-IR sidecars
---------------
Next to the shards, the what-if engine may persist **run-level IR
sidecars** (``run_ir_<hash>.npz``, written by
:func:`repro_torch.whatif.ir.save_sidecar`): the store's rows collapsed, per
(job, host, device) stream, into maximal runs of constant
``(device_state, low_activity)`` — run table (state/low/length/power_sum),
per-stream metadata (host label, platform, first timestamp, row/run
counts) and the raw power samples — so repeat sweeps skip stream grouping,
classification and run-length encoding entirely. Sidecars are keyed in the
manifest under ``manifest["run_ir"][<classifier-config hash>]``; the entry
records the ``source_rows`` the sidecar was built from plus a **shard
watermark**: ``n_shards`` (the covered prefix length of the append-only
``manifest["shards"]`` list) and per-host ``watermarks`` (covered row
counts per host label). A different classifier config hashes to a
different sidecar. Appending shards makes the sidecar *stale*, not dead:
:func:`repro_torch.whatif.ir.get_ir` reloads it (``allow_stale=True``), checks
that the covered prefix still sums to ``source_rows``, and folds only the
uncovered suffix shards in via :meth:`repro_torch.whatif.ir.IRBuilder.extend` —
store growth invalidates the appended-to streams' tails, not the world. A
rewritten, quarantined or reordered shard *inside* the covered prefix
breaks the watermark and forces a full rebuild. Sidecars are derived
data — deleting the files and the manifest key is always safe.

Robustness
----------
Real telemetry shards get truncated, bit-flipped and orphaned. Every write
that could tear (manifest, ``npz`` shard, sidecar) goes through temp-file +
:func:`atomic_replace`; every read raises a single typed
:class:`ShardReadError` carrying a machine-readable ``reason``
(``missing_file`` / ``corrupt`` / ``checksum_mismatch``) instead of leaking
``FileNotFoundError`` / ``zipfile.BadZipFile``. ``write_shard`` records a
sha256 per shard (``verify=True`` reads recompute it), ``iter_shards`` /
``read_shard_or_skip`` take ``strict=False`` to skip bad shards with
coverage accounting, :meth:`TelemetryStore.quarantine_shard` moves a bad
shard into ``quarantine/`` with a manifest record, and a corrupt manifest
JSON is recovered by rescanning the shard files on disk. The repair /
quarantine *policies* live in :mod:`repro_torch.telemetry.hygiene`.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import shutil
import zipfile
import zlib
from typing import Iterable, Iterator

import numpy as np

import repro_torch.obs as obs
from repro_torch.telemetry.records import FIELDS, TelemetryFrame

MANIFEST_NAME = "manifest.json"
SHARD_FORMATS = ("npz", "npy_dir")
QUARANTINE_DIR = "quarantine"
_SHARD_STEM_RE = re.compile(r"^telemetry_(?P<host>.+)_d(?P<day>\d{3})_\d{5}$")


class ShardReadError(RuntimeError):
    """One shard could not be read. ``reason`` is machine-readable —
    ``missing_file`` (manifest/disk drift), ``corrupt`` (truncated or
    bit-flipped archive, ragged columns), ``checksum_mismatch`` (recorded
    sha256 disagrees with the bytes on disk)."""

    def __init__(self, shard: str, reason: str, detail: str = ""):
        self.shard = shard
        self.reason = reason
        msg = f"shard {shard!r}: {reason}"
        super().__init__(msg + (f" ({detail})" if detail else ""))


def atomic_replace(tmp: pathlib.Path, dst: pathlib.Path) -> None:
    """The single commit point of every storage write (manifest, ``npz``
    shard, run-IR sidecar): rename a fully-written temp file over the
    destination. Kept module-level — and always called as
    ``storage.atomic_replace`` / a module global, never ``from``-imported —
    so the fault-injection harness can simulate a kill at the rename
    boundary by patching one name (:func:`repro_torch.testing.faults.dying_renames`)."""
    os.replace(str(tmp), str(dst))


def _write_atomic_text(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    atomic_replace(tmp, path)


def _write_atomic_npz(path: pathlib.Path, arrays: dict) -> None:
    # savez_compressed on an open handle: a string temp path without the
    # .npz suffix would get one silently appended
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    atomic_replace(tmp, path)


#: reader-side exceptions that mean "this archive is damaged", mapped to
#: ShardReadError(reason="corrupt"): truncated zip central directory
#: (BadZipFile), truncated .npy payload / ragged columns (ValueError),
#: deflate stream damage (zlib.error), short reads (EOFError/OSError)
_CORRUPT_ERRORS = (zipfile.BadZipFile, ValueError, zlib.error, EOFError,
                   OSError, KeyError)


def checksum_shard(path: pathlib.Path) -> str:
    """sha256 of a shard's bytes; ``npy_dir`` shards hash the sorted
    ``(column file name, column sha256)`` pairs so the digest is stable
    against directory-listing order."""
    if path.is_dir():
        outer = hashlib.sha256()
        for col in sorted(p.name for p in path.glob("*.npy")):
            outer.update(f"{col}:{_file_sha256(path / col)}\n".encode())
        return outer.hexdigest()
    return _file_sha256(path)


def _file_sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class TelemetryStore:
    def __init__(self, root: str | pathlib.Path,
                 shard_format: str | None = None):
        """``shard_format=None`` adopts an existing store's persisted format
        (so reopening an ``npy_dir`` store for append keeps appending
        ``npy_dir`` shards), defaulting to ``npz`` for new stores; passing a
        format that contradicts the persisted one raises."""
        if shard_format is not None and shard_format not in SHARD_FORMATS:
            raise ValueError(
                f"unknown shard_format {shard_format!r}; known: {SHARD_FORMATS}")
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._manifest_path = self.root / MANIFEST_NAME
        self._manifest_stat: tuple[int, int] | None = None
        if self._manifest_path.exists():
            self._manifest_stat = self._stat_manifest()
            try:
                manifest = json.loads(self._manifest_path.read_text())
                if not isinstance(manifest, dict) \
                        or not isinstance(manifest.get("shards"), list):
                    raise ValueError("manifest is not a shard mapping")
                self.manifest = manifest
            except (ValueError, OSError) as e:
                # poisoned/truncated manifest JSON: rebuild it from the
                # shard files on disk rather than failing the whole store
                obs.fallback("manifest", "rescan", type(e).__name__)
                self.manifest = self._recover_manifest()
        else:
            self.manifest = {"shards": []}
        persisted = self.manifest.get("shard_format")
        if shard_format is None:
            self.shard_format = persisted or "npz"
        else:
            if persisted is not None and persisted != shard_format:
                raise ValueError(
                    f"store at {self.root} persists shard_format "
                    f"{persisted!r}; cannot reopen as {shard_format!r}")
            self.shard_format = shard_format
        self.manifest["shard_format"] = self.shard_format

    def _recover_manifest(self) -> dict:
        """Rebuild a manifest by rescanning ``telemetry_*`` shard files on
        disk: readable shards are re-listed (rows and sha256 recomputed),
        unreadable ones are moved to the quarantine area. The recovered
        manifest is flushed immediately, marked ``{"recovered": true}``."""
        shards: list[dict] = []
        quarantine: list[dict] = []
        fmt = None
        for path in sorted(self.root.iterdir()):
            stem = path.name[:-4] if path.name.endswith(".npz") else path.name
            m = _SHARD_STEM_RE.match(stem)
            if m is None or path.name.endswith(".tmp"):
                continue
            entry = {"file": path.name, "host": m.group("host"),
                     "day": int(m.group("day")),
                     "format": "npy_dir" if path.is_dir() else "npz"}
            try:
                rows = len(self._read_shard_file(path))
            except ShardReadError as e:
                entry["reason"] = e.reason
                quarantine.append(entry)
                self._move_to_quarantine(path)
                continue
            entry["rows"] = rows
            entry["sha256"] = checksum_shard(path)
            fmt = fmt or entry["format"]
            shards.append(entry)
        manifest: dict = {"shards": shards, "recovered": True,
                          "generation": len(shards) + len(quarantine)}
        if quarantine:
            manifest["quarantine"] = quarantine
        if fmt is not None:
            manifest["shard_format"] = fmt
        _write_atomic_text(self._manifest_path,
                           json.dumps(manifest, indent=1))
        self._manifest_stat = self._stat_manifest()
        return manifest

    def _move_to_quarantine(self, path: pathlib.Path) -> None:
        qdir = self.root / QUARANTINE_DIR
        qdir.mkdir(exist_ok=True)
        try:
            shutil.move(str(path), str(qdir / path.name))
        except OSError:
            pass                        # drift: file vanished under us

    def _stat_manifest(self) -> tuple[int, int] | None:
        try:
            st = os.stat(self._manifest_path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    @property
    def generation(self) -> int:
        """Monotonic shard-list mutation counter, persisted in the
        manifest: bumped on every append/rewrite/quarantine, *not* on
        derived-data merges (:meth:`merge_manifest_key`). Pollers (the live
        controller) compare generations instead of diffing shard lists —
        paired with :meth:`refresh`, new-shard detection is one ``stat``
        per tick on an unchanged store."""
        return int(self.manifest.get("generation", 0))

    def _bump_generation(self) -> None:
        self.manifest["generation"] = self.generation + 1

    def refresh(self) -> bool:
        """Cheap cross-process poll: re-read the manifest only when its
        file stat changed since this handle last loaded or saved it —
        O(1) (one ``stat``) on the no-change path. Returns True when the
        shard set actually changed (generation or shard count moved). A
        torn or unparsable on-disk manifest keeps the current snapshot and
        reports no change — the writer commits through
        :func:`atomic_replace`, so the next poll sees a whole file."""
        stat_now = self._stat_manifest()
        if stat_now is None or stat_now == self._manifest_stat:
            return False
        try:
            manifest = json.loads(self._manifest_path.read_text())
        except (OSError, ValueError):
            return False
        if not isinstance(manifest, dict) \
                or not isinstance(manifest.get("shards"), list):
            return False
        changed = (int(manifest.get("generation", 0)) != self.generation
                   or len(manifest["shards"]) != len(self.manifest["shards"]))
        self.manifest = manifest
        self.manifest.setdefault("shard_format", self.shard_format)
        self._manifest_stat = stat_now
        return changed

    def shards_since(self, watermark: int) -> list[dict]:
        """Manifest entries past a covered prefix of ``watermark`` shards —
        the live controller's pending set. ``manifest["shards"]`` is
        append-only (quarantine removes, but that breaks watermarks by
        design), so this is a slice, not a diff."""
        if watermark < 0:
            raise ValueError(f"watermark must be >= 0, got {watermark}")
        return self.manifest["shards"][watermark:]

    def save_manifest(self) -> None:
        """Persist the manifest atomically (temp file + rename): a process
        killed mid-save leaves the previous manifest intact, never a torn
        JSON."""
        _write_atomic_text(self._manifest_path,
                           json.dumps(self.manifest, indent=1))
        self._manifest_stat = self._stat_manifest()

    def merge_manifest_key(self, key: str, subkey: str, value) -> None:
        """Atomically merge ``manifest[key][subkey] = value`` into the
        **on-disk** manifest: re-read it fresh, update the one entry, and
        temp-file + rename. For derived-data writers (run-IR sidecars) on a
        store another process may be appending to — a plain
        :meth:`save_manifest` would re-serialize this handle's possibly
        stale snapshot and silently drop shards appended since it opened.
        """
        try:
            current = json.loads(self._manifest_path.read_text())
        except (OSError, ValueError):
            current = self.manifest
        if not isinstance(current, dict) \
                or not isinstance(current.get("shards"), list):
            current = self.manifest      # poisoned on-disk copy: ours wins
        if not isinstance(current.get(key), dict):
            current[key] = {}            # tolerate a poisoned subtree
        current[key][subkey] = value
        _write_atomic_text(self._manifest_path, json.dumps(current, indent=1))
        if not isinstance(self.manifest.get(key), dict):
            self.manifest[key] = {}
        self.manifest[key][subkey] = value

    def write_shard(self, frame: TelemetryFrame, host: str = "host0",
                    day: int = 0, flush_manifest: bool = True) -> pathlib.Path:
        """Append one shard (format = the store's ``shard_format``). Bulk
        writers (e.g. the cluster simulator's chunked emission) pass
        ``flush_manifest=False`` and call :meth:`save_manifest` once at the
        end — rewriting the growing JSON manifest per shard is O(shards^2)."""
        stem = f"telemetry_{host}_d{day:03d}_{len(self.manifest['shards']):05d}"
        path = self._write_shard_file(stem, frame)
        self.manifest["shards"].append(
            {"file": path.name, "host": host, "day": day, "rows": len(frame),
             "format": self.shard_format, "sha256": checksum_shard(path)})
        self._bump_generation()
        if flush_manifest:
            self.save_manifest()
        return path

    def _write_shard_file(self, stem: str,
                          frame: TelemetryFrame) -> pathlib.Path:
        if self.shard_format == "npy_dir":
            path = self.root / stem
            # overwrite semantics matching the npz branch: a leftover shard
            # dir (e.g. from a crashed bulk write that never flushed its
            # manifest) is replaced, stale columns included. Directory
            # shards cannot be renamed into place atomically; a crash here
            # leaves a dir the manifest never references, which the orphan
            # scan (verify_manifest) surfaces.
            path.mkdir(exist_ok=True)
            for stale in path.glob("*.npy"):
                stale.unlink()
            for f, col in frame.columns.items():
                np.save(path / f"{f}.npy", col)
            return path
        path = self.root / f"{stem}.npz"
        _write_atomic_npz(path, frame.columns)
        return path

    def rewrite_shard(self, name: str, frame: TelemetryFrame) -> pathlib.Path:
        """Replace an existing shard's contents in place (the hygiene
        layer's repair writer): same file name, manifest entry updated with
        the new row count and checksum."""
        entry = self._shard_entry(name)
        if entry is None:
            raise KeyError(f"shard {name!r} is not in the manifest")
        stem = name[:-4] if name.endswith(".npz") else name
        path = self._write_shard_file(stem, frame)
        entry["rows"] = len(frame)
        entry["sha256"] = checksum_shard(path)
        self._bump_generation()
        return path

    def _shard_entry(self, name: str) -> dict | None:
        for s in self.manifest["shards"]:
            if s["file"] == name:
                return s
        return None

    def append(self, frame: TelemetryFrame, host: str = "host0",
               flush_manifest: bool = True) -> pathlib.Path | None:
        """Append a frame as one shard, deriving the day label from its first
        timestamp — the drain target for live producers
        (:meth:`repro_torch.telemetry.sampler.RuntimeSampler.drain_to`, the DES's
        periodic spill): each drain appends in time order, which is exactly
        the per-stream ordering the streaming readers require. Empty frames
        are dropped (a no-op drain must not create empty shards)."""
        if len(frame) == 0:
            return None
        day = int(frame["timestamp"][0]) // 86400
        return self.write_shard(frame, host=host, day=day,
                                flush_manifest=flush_manifest)

    def read_shard(self, name: str, mmap: bool = False,
                   verify: bool = False) -> TelemetryFrame:
        """Read one shard by manifest name.

        ``mmap=True`` memory-maps ``npy_dir`` columns (zero-copy until a
        column is actually gathered); ``npz`` shards are deflate-compressed,
        which cannot be mapped, so they fall back to a normal load.

        A missing or unreadable shard raises :class:`ShardReadError` with a
        machine-readable ``reason`` (never a raw ``FileNotFoundError`` /
        ``BadZipFile``). ``verify=True`` additionally recomputes the shard's
        sha256 against the one recorded at write time (shards written before
        checksums existed just skip the check) — the only way a bit-flip in
        an *uncompressed* ``npy_dir`` column is detectable, since raw
        ``np.load`` has no payload CRC.
        """
        path = self.root / name
        try:
            if path.is_dir():
                if verify:
                    self._verify_checksum(name, path)
                mode = "r" if mmap else None
                return TelemetryFrame({
                    f: np.load(path / f"{f}.npy", mmap_mode=mode)
                    for f in FIELDS if (path / f"{f}.npy").exists()})
            if not path.exists():
                raise ShardReadError(name, "missing_file",
                                     "manifest entry with no file on disk")
            if verify:
                self._verify_checksum(name, path)
            with np.load(path) as z:
                return TelemetryFrame({f: z[f] for f in FIELDS if f in z})
        except ShardReadError:
            raise
        except _CORRUPT_ERRORS as e:
            raise ShardReadError(
                name, "corrupt", f"{type(e).__name__}: {e}") from e

    def _verify_checksum(self, name: str, path: pathlib.Path) -> None:
        entry = self._shard_entry(name)
        recorded = entry.get("sha256") if entry else None
        if recorded and checksum_shard(path) != recorded:
            raise ShardReadError(name, "checksum_mismatch",
                                 "bytes on disk differ from write-time sha256")

    def read_shard_or_skip(self, name: str, skips: list,
                           mmap: bool = False, strict: bool = True,
                           verify: bool = False) -> TelemetryFrame | None:
        """:meth:`read_shard`, but with ``strict=False`` a bad shard returns
        ``None`` and appends a skip record ``{"file", "host", "rows",
        "reason"}`` to ``skips`` (rows from the manifest — the coverage
        denominator the pipelines account against). The shared read step of
        every fault-tolerant worker body."""
        try:
            return self.read_shard(name, mmap=mmap, verify=verify)
        except ShardReadError as e:
            if strict:
                raise
            entry = self._shard_entry(name) or {}
            skips.append({"file": name, "host": entry.get("host", ""),
                          "rows": int(entry.get("rows", 0)),
                          "reason": e.reason})
            obs.counter("repro_shards_quarantined_total", reason=e.reason,
                        help="telemetry shards skipped or quarantined, "
                             "by reason")
            return None

    def iter_shards(self, hosts: Iterable[str] | None = None,
                    mmap: bool = False, strict: bool = True,
                    verify: bool = False,
                    skips: list | None = None) -> Iterator[TelemetryFrame]:
        """Yield shard frames one at a time, in manifest (append) order.

        The streaming analysis path (``telemetry.pipeline.analyze_store``)
        and the what-if sweep consume this so that at most one shard is
        materialized; writers append each stream's shards in time order,
        which is exactly the per-stream ordering :class:`FleetAccumulator`
        requires. With ``mmap=True``, ``npy_dir`` shards arrive as
        ``np.memmap``-backed columns — cold columns are never read off disk
        (note ``TelemetryFrame.group_streams`` gathers every column it
        sorts, so the win is for passes that slice or subset columns).

        ``strict=False`` skips missing/corrupt shards instead of raising,
        appending one record per skip to ``skips`` (when given) so callers
        can account coverage; ``verify=True`` checks recorded sha256s.
        """
        hosts = set(hosts) if hosts is not None else None
        sink = skips if skips is not None else []
        for s in self.manifest["shards"]:
            if hosts is None or s["host"] in hosts:
                frame = self.read_shard_or_skip(
                    s["file"], sink, mmap=mmap, strict=strict, verify=verify)
                if frame is not None:
                    yield frame

    def quarantine_shard(self, name: str, reason: str,
                         flush_manifest: bool = True) -> None:
        """Move a shard out of the readable set: file relocated to
        ``quarantine/``, manifest entry moved from ``shards`` to the
        ``quarantine`` list (with the reason), so analysis never sees it
        again but a human can inspect or restore it."""
        entry = self._shard_entry(name)
        if entry is not None:
            self.manifest["shards"].remove(entry)
        record = dict(entry or {"file": name})
        record["reason"] = reason
        self.manifest.setdefault("quarantine", []).append(record)
        self._bump_generation()
        self._move_to_quarantine(self.root / name)
        obs.counter("repro_shards_quarantined_total", reason=reason,
                    help="telemetry shards skipped or quarantined, by reason")
        if flush_manifest:
            self.save_manifest()

    def verify_manifest(self) -> list[dict]:
        """Detect manifest<->disk drift without reading shard payloads:
        returns one record per problem — ``{"file", "reason":
        "missing_file"}`` for a manifest entry whose file vanished,
        ``{"file", "reason": "orphan_file"}`` for a ``telemetry_*`` file
        with no manifest entry (e.g. a crashed bulk write). Clean store ==
        empty list."""
        drift: list[dict] = []
        known = {s["file"] for s in self.manifest["shards"]}
        for s in self.manifest["shards"]:
            path = self.root / s["file"]
            if not (path.exists() or path.is_dir()):
                drift.append({"file": s["file"], "host": s.get("host", ""),
                              "rows": int(s.get("rows", 0)),
                              "reason": "missing_file"})
        for path in sorted(self.root.iterdir()):
            stem = path.name[:-4] if path.name.endswith(".npz") else path.name
            if (_SHARD_STEM_RE.match(stem) and not path.name.endswith(".tmp")
                    and path.name not in known):
                drift.append({"file": path.name, "reason": "orphan_file"})
        return drift

    def _read_shard_file(self, path: pathlib.Path) -> TelemetryFrame:
        """Read a shard by path only (no manifest entry required) — the
        manifest-recovery scan's reader."""
        return self.read_shard(path.name)

    def read_all(self, hosts: Iterable[str] | None = None) -> TelemetryFrame:
        return TelemetryFrame.concat(list(self.iter_shards(hosts)))

    @property
    def total_rows(self) -> int:
        return sum(s["rows"] for s in self.manifest["shards"])

    def rows_on_disk(self, hosts: Iterable[str] | None = None) -> int:
        """Manifest row total, optionally host-filtered — the denominator of
        every coverage fraction (rows analyzed / rows on disk)."""
        host_filter = set(hosts) if hosts is not None else None
        return sum(s["rows"] for s in self.manifest["shards"]
                   if host_filter is None or s["host"] in host_filter)

    def partition_hosts(self, workers: int,
                        hosts: Iterable[str] | None = None) -> list[list[str]]:
        """Split host labels into at most ``workers`` row-balanced partitions
        (greedy, heaviest host first — deterministic).

        Host labels are the parallelism unit for process-pool analysis:
        every (job, host, device) stream lives entirely under one host
        label, so partitions hold disjoint streams and per-stream carry
        state never crosses workers.
        """
        host_filter = set(hosts) if hosts is not None else None
        rows_per_host: dict[str, int] = {}
        for s in self.manifest["shards"]:
            if host_filter is None or s["host"] in host_filter:
                rows_per_host[s["host"]] = (
                    rows_per_host.get(s["host"], 0) + s["rows"])
        ordered = sorted(rows_per_host, key=lambda h: (-rows_per_host[h], h))
        n_parts = max(1, min(workers, len(ordered)))
        parts: list[list[str]] = [[] for _ in range(n_parts)]
        loads = [0] * n_parts
        for h in ordered:
            i = loads.index(min(loads))
            parts[i].append(h)
            loads[i] += rows_per_host[h]
        return parts

    def shard_files(self, hosts: Iterable[str] | None = None) -> list[str]:
        """Manifest-ordered shard file names, optionally host-filtered."""
        host_filter = set(hosts) if hosts is not None else None
        return [s["file"] for s in self.manifest["shards"]
                if host_filter is None or s["host"] in host_filter]
