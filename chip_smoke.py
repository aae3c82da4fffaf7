#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the serving path's CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the serving path's shapes, times
each beside its bound, its plain version and a PyTorch yardstick call,
compares full-width llama-13b logits between the kernel path and the plain
path, then serves llama-13b at full width (random weights from a seed, bf16)
through ``ServingEngine`` with the Algorithm-1 controller on, and checks that
every kernel was launched the expected number of times.

Output: one line per phase; before the last, a ``{"kernels": [...]}`` JSON
line and the card's name and power limit from nvidia-smi; last, the
``{"ok": true, "device": ...}`` line. Any failure exits non-zero before the
last line. Exits 2 without a CUDA device or without the repository's
``src/repro_torch``. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
BF16_TOL = 2e-2                    # kernel vs plain, bf16 (tests/test_kernels.py)
F32_TOL = 2e-5                     # kernel vs plain, f32
LOGITS_BF16_TOL = 5e-2             # normwise, 40 layers of bf16 rounding
LOGITS_F32_TOL = 1e-4              # normwise, two f32 layers

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:16",
    "flash_attention": "src/repro/kernels/flash_attention.py:26",
    "decode_attention": "src/repro/kernels/decode_attention.py:22",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` by CUDA events over ``iters`` eager calls:
    includes the host's launch cost wherever that exceeds the card's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Card time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times and timed by CUDA events, so no host
    launch cost is in the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def timed(fn, iters: int = 100) -> dict[str, float]:
    return {"ms": graph_ms(fn, iters), "call_ms": cuda_ms(fn, iters)}


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


LIMIT_USED: dict[str, float] = {}   # check name -> worst share of the limit


def check_close(name: str, got, want, tol: float) -> float:
    """Raise unless ``got`` is finite, of ``want``'s shape, and every
    element satisfies |got - want| <= tol * (1 + |want|) (an allclose with
    rtol = atol = tol, as torch.testing.assert_close applies it). Records
    the worst element's share of its limit in LIMIT_USED; returns the max
    abs error."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite output")
    diff = (g - w).abs()
    used = float((diff / (tol * (1.0 + w.abs()))).max())
    LIMIT_USED[name] = used
    if used > 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds {tol} * (1 + |plain|) "
                             f"at some element ({used:.3f} of the limit; max abs "
                             f"err {float(diff.max())})")
    return float(diff.max())


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def check_kernels(dev) -> dict[str, float]:
    """Each kernel against its plain version on the same inputs, in bf16 at
    the serving path's shapes and the cases around them. Returns the max
    abs error at the main-path shape of each kernel."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    errs = {}
    # K1 RMSNorm: decode (4 slots) and prefill (32 tokens) rows at D = 5120
    for rows, main in ((4, True), (32, False), (37, False)):
        x, w = rnd(rows, 1, 5120), rnd(5120)
        e = check_close(f"rmsnorm rows={rows}", ops.rmsnorm(x, w, 1e-6),
                        ops.rmsnorm(x, w, 1e-6, plain=True), BF16_TOL)
        if main:
            errs["rmsnorm"] = e
    xf, wf = rnd(5, 5120, dtype=torch.float32), rnd(5120, dtype=torch.float32)
    check_close("rmsnorm f32", ops.rmsnorm(xf, wf), ops.rmsnorm(xf, wf, plain=True),
                F32_TOL)
    # K2 prefill attention, model layout (B, S, H, d)
    cases = [  # (b, s, h, kv, d, window, main)
        (1, 32, 40, 40, 128, 0, True),     # llama-13b prefill bucket
        (1, 64, 8, 1, 256, 0, False),      # MQA at d = 256 (gemma-2b)
        (2, 96, 8, 2, 64, 40, False),      # GQA with a sliding window
        (1, 37, 40, 40, 128, 0, False),    # ragged length
    ]
    for b, s, h, kv, d, window, main in cases:
        q, k, v = rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d)
        e = check_close(f"flash b={b} s={s} h={h} kv={kv} d={d} w={window}",
                        ops.flash_attention(q, k, v, window=window),
                        ops.flash_attention(q, k, v, window=window, plain=True),
                        BF16_TOL)
        if main:
            errs["flash_attention"] = e
    # K3 decode attention, read in place from an (L, B, S, KV, d) cache
    for b, s, h, kv, d in ((4, 256, 40, 40, 128), (2, 100, 8, 1, 256)):
        kc, vc = rnd(3, b, s, kv, d), rnd(3, b, s, kv, d)
        q = rnd(b, 1, h, d)
        for cl in (1, s // 2 + 1, s, s + 9):
            n = torch.full((), cl, dtype=torch.int32, device=dev)
            e = check_close(f"decode b={b} s={s} h={h} kv={kv} d={d} len={cl}",
                            ops.decode_attention(q, kc[1], vc[1], n),
                            ops.decode_attention(q, kc[1], vc[1], n, plain=True),
                            BF16_TOL)
            if (b, s, cl) == (4, 256, 256):
                errs["decode_attention"] = e
    torch.cuda.synchronize()
    return errs


def time_kernels(dev) -> dict[str, dict]:
    """Kernel, plain version and PyTorch yardstick at the main path's shapes
    (llama-13b, bf16): RMSNorm over the 4 decode rows, prefill attention over
    the 32-token bucket, decode attention over 4 slots x 256 cache slots with
    the cache rotated over 8 layers (168 MB, past the 50 MB L2, as a decode
    step finds it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    out = {}
    x, w = rnd(4, 1, 5120), rnd(5120)
    out["rmsnorm"] = dict(
        shape="x (4, 1, 5120) bf16",
        kernel=timed(lambda: ops.rmsnorm(x, w, 1e-6)),
        plain=timed(lambda: ops.rmsnorm(x, w, 1e-6, plain=True)),
        library=timed(lambda: F.rms_norm(x, (5120,), w, 1e-6)),
        bound=bound_ms(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel()))

    b, s, h, d = 1, 32, 40, 128
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    pairs = s * (s + 1) // 2
    out["flash_attention"] = dict(
        shape="q, k, v (1, 32, 40, 128) bf16, causal",
        kernel=timed(lambda: ops.flash_attention(q, k, v)),
        plain=timed(lambda: ops.flash_attention(q, k, v, plain=True)),
        library=timed(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True)),
        bound=bound_ms(4 * q.numel() * 2, 4 * d * b * h * pairs))

    layers, b, s, h, d = 8, 4, 256, 40, 128
    kc, vc = rnd(layers, b, s, h, d), rnd(layers, b, s, h, d)
    q = rnd(b, 1, h, d)
    n = torch.full((), s, dtype=torch.int32, device=dev)
    it = iter(range(1 << 62))

    def rotate(fn):
        return lambda: fn(next(it) % layers)

    out["decode_attention"] = dict(
        shape="q (4, 1, 40, 128), caches (4, 256, 40, 128) bf16, len 256",
        kernel=timed(rotate(lambda i: ops.decode_attention(q, kc[i], vc[i], n))),
        plain=timed(rotate(lambda i: ops.decode_attention(
            q, kc[i], vc[i], n, plain=True)), 40),
        library=timed(rotate(lambda i: F.scaled_dot_product_attention(
            q.transpose(1, 2), kc[i].transpose(1, 2), vc[i].transpose(1, 2)))),
        bound=bound_ms(2 * q.numel() * 2 + 2 * b * s * h * d * 2, 4 * d * b * h * s))
    return out


def profile_decode(cfg, params, cache, dev, step_ms: float) -> dict:
    """Three decode steps under torch.profiler: the card's busy time per step
    against the unprofiled step time from the serve run, and the kernels
    that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api

    tokens = torch.full((cache["k"].shape[1], 1), 7, dtype=torch.long, device=dev)
    cache, _ = api.decode_step(params, cache, tokens, cfg)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cache, _ = api.decode_step(params, cache, tokens, cfg)
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / steps
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    result = {
        "card_busy_ms_per_step": busy_ms,
        "step_ms_unprofiled": step_ms,
        "card_idle_share": (1.0 - busy_ms / step_ms) if busy_ms else None,
        "kernel_launches_per_step": sum(e.count for e in on_card) / steps,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
    }
    log("profile decode step " + json.dumps(result))
    return result


def pad_cache(cfg, cache, max_len, dev):
    from repro_torch.models import api
    out = api.init_cache(cfg, cache["k"].shape[1], max_len, dev)
    for name in ("k", "v"):
        out[name][:, :, :cache[name].shape[2]] = cache[name]
    out["len"] = cache["len"].clone()
    return out


def compare_logits(cfg, params, dev, tol: float, label: str) -> float:
    """One 32-token prefill and two decode steps, kernel path against plain
    path on the same tokens; the worst normwise relative logit error."""
    import torch
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(2, cfg.vocab_size, (1, 32), generator=g, device=dev)
    steps = torch.randint(2, cfg.vocab_size, (2, 1, 1), generator=g, device=dev)
    runs = {}
    for plain in (False, True):
        cache, logits = api.prefill(params, tokens, cfg, plain=plain)
        cache = pad_cache(cfg, cache, 64, dev)
        seq = [logits.float()]
        for t in steps:
            cache, logits = api.decode_step(params, cache, t, cfg, plain=plain)
            seq.append(logits.float())
        runs[plain] = seq
    worst = 0.0
    for i, (a, b) in enumerate(zip(runs[False], runs[True])):
        if a.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: bad logits at step {i}: {a.shape}")
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
    if worst > tol:
        raise AssertionError(f"{label}: normwise logit error {worst} > {tol}")
    log(f"logits {label}: prefill + 2 decode steps, kernel vs plain "
        f"normwise rel err {worst:.3e} (tol {tol})")
    return worst


def serve(cfg, params, dev) -> dict:
    """The main path: ServingEngine on azure_code requests, controller on."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.telemetry import analyze_job
    from repro_torch.traces import generate_trace, get_trace

    ec = EngineConfig(n_slots=4, max_seq_len=256, prefill_bucket=32,
                      max_new_tokens=16, controller=True, platform="h100",
                      device=str(dev))
    engine = ServingEngine(cfg, params, ec)
    trace = generate_trace(get_trace("azure_code"), 90.0, n_devices=1, seed=0)
    rng = np.random.default_rng(0)
    prompts = {}
    for r in trace:
        r.prompt_tokens = min(r.prompt_tokens, ec.max_seq_len // 2)
        r.output_tokens = min(r.output_tokens, ec.max_new_tokens)
        prompts[r.req_id] = rng.integers(2, cfg.vocab_size, r.prompt_tokens)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = engine.run(trace, prompts)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()

    n_prefill = len(engine.phase_ms["prefill"])
    n_decode = len(engine.phase_ms["decode"])
    expect = {"rmsnorm": (2 * cfg.n_layers + 1) * (n_prefill + n_decode),
              "flash_attention": cfg.n_layers * n_prefill,
              "decode_attention": cfg.n_layers * n_decode}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if stats.n < 4:
        raise AssertionError(f"only {stats.n} requests completed (< 4)")
    if not all(0 <= r.req_id for r in engine.completed):
        raise AssertionError("bad completed requests")
    frame = engine.sampler.frame()
    ja = analyze_job(frame, job_id=1, min_duration_s=1.0)
    decode_ms = float(np.mean(engine.phase_ms["decode"]))
    result = {
        "requests": len(trace), "completed": stats.n,
        "p50_s": stats.p50_s, "p95_s": stats.p95_s,
        "exec_idle_time_fraction": ja.exec_idle_time_fraction,
        "exec_idle_energy_fraction": ja.exec_idle_energy_fraction,
        "telemetry_rows": len(frame),
        "controller_downscales": engine.controller.stats.downscale_events,
        "controller_restores": engine.controller.stats.restore_events,
        "prefills": n_prefill, "decode_steps": n_decode,
        "mean_prefill_ms": float(np.mean(engine.phase_ms["prefill"])),
        "mean_decode_step_ms": decode_ms,
        "decode_tokens_per_s_4_slots": ec.n_slots * 1e3 / decode_ms,
        "final_shared_len": int(engine.cache["len"]),
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "wall_s": wall_s,
        "launches": launches,
    }
    log("serve " + json.dumps(result))
    return result, engine.cache


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs on the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {len(_build.sources())} sources in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.strip().removeprefix("ptxas info    : "))

    errs = check_kernels(dev)
    log(f"kernels vs plain (bf16 per element, |err| <= {BF16_TOL} * (1 + |plain|)): "
        f"max abs err at the main shapes {errs}")
    for name, used in LIMIT_USED.items():
        log(f"  {name}: {used:.4f} of the limit at the worst element")
    times = time_kernels(dev)
    for name, t in times.items():
        log(f"time {name} [{t['shape']}] card ms (per call with host ms): kernel "
            f"{t['kernel']['ms']:.5f} ({t['kernel']['call_ms']:.5f}), plain "
            f"{t['plain']['ms']:.5f} ({t['plain']['call_ms']:.5f}), torch "
            f"{t['library']['ms']:.5f} ({t['library']['call_ms']:.5f}), bound "
            f"{t['bound'][0]:.5f} ({t['bound'][1]})")

    # full width: llama-13b, bf16, random weights drawn on the card
    cfg = get_config("llama-13b")
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + \
        params["embed"].numel() + params["out_head"].numel() + cfg.d_model
    log(f"llama-13b: {n_params / 1e9:.3f} B parameters in bf16, made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    compare_logits(cfg, params, dev, LOGITS_BF16_TOL, "llama-13b bf16 (40 layers)")
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = api.init_params(torch.Generator(device=dev).manual_seed(4), cfg32)
    compare_logits(cfg32, params32, dev, LOGITS_F32_TOL,
                   "llama-13b widths f32 (2 layers)")
    del params32
    torch.cuda.empty_cache()

    result, cache = serve(cfg, params, dev)
    profile_decode(cfg, params, cache, dev, result["mean_decode_step_ms"])
    rows = []
    for name, t in times.items():
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": result["launches"][name],
            "max_abs_err": errs[name],
            "ms": t["kernel"]["ms"], "plain_ms": t["plain"]["ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library"]["ms"],
            "call_ms": t["kernel"]["call_ms"], "plain_call_ms": t["plain"]["call_ms"],
            "library_call_ms": t["library"]["call_ms"],
            "shape": t["shape"],
        })
    assert set(kernels.KERNEL_MODULES) == {r["name"] for r in rows}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
