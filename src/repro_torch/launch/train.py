"""Training launcher, as the JAX package's ``launch/train.py``.

The execution-idle telemetry + Algorithm-1 controller are first-class
flags. Runs on the card by default, where the trainer replays its step
from a CUDA graph after two eager steps; ``--device cpu --smoke`` trains a
smoke-size model on the CPU, eagerly.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 20 --batch 8 --seq 128 --controller --checkpoint-dir /tmp/ck

Weights are random, drawn on the device from ``--seed``; the batches are the
JAX package's, drawn by numpy from the same seed. Prints a JSON summary.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.states import DeviceState
from repro_torch.telemetry import analyze_job
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainReport


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--controller", action="store_true",
                    help="enable the Algorithm-1 execution-idle controller")
    ap.add_argument("--platform", default="h100")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainerConfig(steps=args.steps, checkpoint_every=args.checkpoint_every,
                       checkpoint_dir=args.checkpoint_dir, lr=args.lr)
    trainer = Trainer(cfg, tc, global_batch=args.batch, seq_len=args.seq,
                      platform=args.platform, controller=args.controller,
                      seed=args.seed, device=args.device)
    summary = summarize(trainer, trainer.run())
    print(json.dumps(summary, indent=1))
    return summary


def summarize(trainer: Trainer, report: TrainReport) -> dict:
    """The run's JSON summary: losses, resume, stragglers, the steps
    replayed from the CUDA graph (every step after the first two on the
    card, none on the CPU), wall time, the telemetry's execution-idle
    shares (``analyze_job`` on the sampler's rows) and the controller's
    downscales."""
    frame = trainer.sampler.frame()
    telemetry = {}
    if len(frame):
        ja = analyze_job(frame, job_id=1, min_duration_s=1.0)
        telemetry = {
            "exec_idle_time_fraction": round(ja.exec_idle_time_fraction, 4),
            "exec_idle_energy_fraction": round(ja.exec_idle_energy_fraction, 4),
            "active_s": ja.breakdown.time_s[DeviceState.ACTIVE],
            "exec_idle_s": ja.breakdown.time_s[DeviceState.EXECUTION_IDLE],
            "energy_j": round(ja.breakdown.total_energy_j, 1),
        }
    return {
        "arch": trainer.cfg.name,
        "steps": report.steps_run,
        "final_loss": round(report.final_loss, 4),
        "loss_first": round(report.losses[0], 4) if report.losses else None,
        "resumed_from": report.resumed_from,
        "stragglers": report.straggler_events,
        "replayed_steps": report.replayed_steps,
        "wall_s": round(report.wall_s, 1),
        "telemetry": telemetry,
        "controller_downscales": (trainer.controller.stats.downscale_events
                                  if trainer.controller else None),
    }


if __name__ == "__main__":
    main()
