"""Serving launcher: replay a (synthetic) industry trace on the live engine,
with execution-idle telemetry and the Algorithm-1 controller.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-13b \
        --trace azure_code --duration 60 --controller

``--arch`` is llama-13b, hymba-1.5b, rwkv6-3b, granite-moe-3b-a800m,
whisper-tiny, llama-3.2-vision-90b, deepseek-v3-671b or another ported
architecture (``repro_torch.configs.ARCHS``). The whole model is made on the
device: the last two do not fit one 80-GB card at full depth.

Runs on the card by default; ``--device cpu --smoke`` runs a smoke-size model
on the CPU. Weights are random, drawn on the device from ``--seed``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.telemetry import analyze_job
from repro_torch.traces import TRACES, generate_trace, get_trace


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-13b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="azure_code", choices=sorted(TRACES))
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--controller", action="store_true")
    ap.add_argument("--platform", default="h100")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init_params(gen, cfg)
    engine = ServingEngine(cfg, params, EngineConfig(
        n_slots=args.slots, max_seq_len=args.max_seq,
        prefill_bucket=min(32, args.max_seq // 2),
        max_new_tokens=args.max_new_tokens,
        controller=args.controller, platform=args.platform,
        device=str(device)))

    spec = get_trace(args.trace)
    trace = generate_trace(spec, args.duration, n_devices=1, seed=args.seed)
    # engine-scale the requests (the engine decodes a few tokens per request)
    rng = np.random.default_rng(args.seed)
    prompts = {}
    for r in trace:
        r.prompt_tokens = min(r.prompt_tokens, args.max_seq // 2)
        r.output_tokens = min(r.output_tokens, args.max_new_tokens)
        prompts[r.req_id] = rng.integers(
            2, cfg.vocab_size, r.prompt_tokens).astype(np.int64)

    stats = engine.run(trace, prompts)
    frame = engine.sampler.frame()
    telemetry = {}
    if len(frame):
        ja = analyze_job(frame, job_id=1, min_duration_s=1.0)
        telemetry = {
            "exec_idle_time_fraction": round(ja.exec_idle_time_fraction, 4),
            "exec_idle_energy_fraction": round(ja.exec_idle_energy_fraction, 4),
            "avg_power_w": round(float(frame["power"].mean()), 1),
        }
    result = {
        "arch": cfg.name,
        "trace": args.trace,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "completed": stats.n,
        "p50_s": round(stats.p50_s, 3),
        "p95_s": round(stats.p95_s, 3),
        "telemetry": telemetry,
        "controller_downscales": (engine.controller.stats.downscale_events
                                  if engine.controller else None),
        "mean_phase_ms": {k: (float(np.mean(v)) if v else None)
                          for k, v in engine.phase_ms.items()},
        "cache_len": int(engine.cache["len"]),
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
