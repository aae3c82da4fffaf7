"""The live fleet controller as a daemon: ingest → extend → search, forever.

A producer appends telemetry shards continuously — the §2.1 cluster
simulator drip-fed window by window, or a directory of real DCGM /
``power.json`` collector dumps — and a
:class:`repro_torch.live.LiveController` ticks against the store: poll
past the watermark, coalesce the backlog into one incremental-IR extend,
re-run the Pareto search warm-started from the previous frontier (on the
card with the default torch backend), checkpoint atomically, publish the
refreshed knee.

Kill it (``kill -9``, Ctrl-C, power cut) and relaunch with the same
``--checkpoint``/``--store``: it resumes from the checkpoint and converges
to the frontier the uninterrupted run would have produced, bit-identical.
Corrupt the checkpoint and it cold-starts instead of crashing; poison a
shard and it serves the stale knee, flagged, with the watermark held.

    PYTHONPATH=src python -m repro_torch.launch.live \
        [--devices 8] [--hours 2] [--window 600] [--ticks 20]
        [--store DIR] [--checkpoint PATH] [--dcgm DIR]
        [--backend torch|numpy] [--device cuda|cpu] [--max-evals 64]
        [--interval 0] [--out knee.json] [--metrics-out metrics.prom]

Runs on the card by default; ``--device cpu`` runs the torch backend's
plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

import repro_torch.obs as obs
from repro_torch.live import (DcgmDirectoryProducer, LiveConfig,
                              LiveController, SimulatorProducer)
from repro_torch.telemetry import TelemetryStore


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="simulated fleet size (ignored with --dcgm)")
    ap.add_argument("--hours", type=float, default=2.0,
                    help="simulated horizon (ignored with --dcgm)")
    ap.add_argument("--window", type=int, default=600,
                    help="simulator window per shard, seconds")
    ap.add_argument("--ticks", type=int, default=20,
                    help="controller ticks to run (a real daemon loops "
                         "forever; this one stops when the feed drains)")
    ap.add_argument("--interval", type=float, default=0.0,
                    help="sleep between ticks, seconds")
    ap.add_argument("--store", default=None,
                    help="telemetry store dir (default: a temp dir; pass a "
                         "real path to survive restarts)")
    ap.add_argument("--checkpoint", default=None,
                    help="controller checkpoint path (default: "
                         "<store>/live_ckpt.json)")
    ap.add_argument("--dcgm", default=None, metavar="DIR",
                    help="poll DIR for DCGM / power.json collector dumps "
                         "instead of simulating")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                    help="replay backend for the warm rung (the ladder "
                         "degrades torch -> numpy -> cold on poisoned data)")
    ap.add_argument("--device", default="cuda",
                    help="where the torch backend runs: cuda or cpu")
    ap.add_argument("--max-evals", type=int, default=64)
    ap.add_argument("--out", default=None,
                    help="published-knee JSON path (atomic rewrite per tick)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the Prometheus exposition here on exit")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    obs.enable()
    obs.init_live_metrics()
    obs.init_degradation_metrics()

    tmp = None
    if args.store is None:
        tmp = tempfile.TemporaryDirectory()
        args.store = tmp.name
    try:
        store_dir = pathlib.Path(args.store)
        ckpt = pathlib.Path(args.checkpoint) if args.checkpoint \
            else store_dir / "live_ckpt.json"
        store = TelemetryStore(store_dir / "telemetry")
        ctrl = LiveController(store, ckpt, LiveConfig(
            backend=args.backend, device=args.device,
            max_evals=args.max_evals), publish_path=args.out)
        if args.dcgm:
            producer = DcgmDirectoryProducer(store, args.dcgm)
        else:
            producer = SimulatorProducer(
                store, n_devices=args.devices,
                horizon_s=int(args.hours * 3600), window_s=args.window)
            # resume-aware drip: skip the windows already in the store
            for _ in range(len(store.manifest["shards"])):
                if producer.exhausted:
                    break
                producer._t_next += producer.window_s
        if ctrl.tick_no:
            print(f"resumed from {ckpt}: tick {ctrl.tick_no}, "
                  f"{ctrl.n_shards} shards covered, knee "
                  f"{'present' if ctrl.knee else 'absent'}")

        for _ in range(args.ticks):
            fed = producer.step()
            r = ctrl.tick()
            knee = r.knee
            knee_txt = ("knee none" if knee is None else
                        f"knee {knee.params} saves "
                        f"{knee.saved_fraction * 100:.1f}%")
            print(f"tick {r.tick:3d}  {r.result:9s}  +{fed} rows "
                  f"{r.n_new_shards} shard(s) coalesced={r.coalesced}  "
                  f"rung={r.rung or '-'}  staleness={r.staleness_s * 1e3:.0f}ms  "
                  f"coverage={r.coverage:.3f}  {knee_txt}"
                  + (f"  [{r.error}]" if r.error else ""))
            if r.result == "idle" and fed == 0 and not args.dcgm:
                print("feed drained — stopping (a real daemon keeps polling)")
                break
            if args.interval > 0:
                time.sleep(args.interval)

        if args.metrics_out:
            obs.write_textfile(args.metrics_out)
            print(f"metrics exposition -> {args.metrics_out}", file=sys.stderr)
    finally:
        if tmp is not None:
            tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
