#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives its
paths:

* serving: holds K1-K3 against their plain PyTorch versions at the serving
  path's shapes and around the attention kernels' tiles and splits (K2 in
  bf16 on the tensor cores and in f32 on the CUDA cores, also without the
  causal mask and at Sq != Sk, K3 at cache lengths around its chunks, each
  called twice for the same bits), times
  each beside its bound, its plain version and a PyTorch yardstick call
  (K1, K2 and K3 also at hymba-1.5b's shapes, K1 at both prefills; K1's
  launch floor, an empty kernel, and the time K1 adds after a GEMM),
  compares full-width llama-13b logits between the kernel path and the
  plain path, then serves llama-13b at full width (random weights from a
  seed, bf16) through ``ServingEngine`` with the Algorithm-1 controller
  on, its decode step and prefill replayed from the CUDA graphs the engine
  captures, and checks every kernel's launch count (replays x launches per
  graph) and that every bf16 K2 launch took the tensor cores; times the
  replayed decode step and the eager one on the same engine, each beside
  the card's busy time from torch.profiler; and holds the replays to the
  eager step functions bit for bit over 8 lockstep decode steps across the
  cache's end and one prefill;
* the recurrent families: holds K5 (Mamba selective scan) and K6 (RWKV-6
  WKV) against their plain versions (main shapes, every branch of their
  launch plans, a ragged length, S = 1 from a carried state, a state
  carried across two calls, large dt, extreme decays, each called twice for
  the same bits) and times them at the decode step's shape and the
  32-token prefill (K5 also at the 2,048-token one) under each plan, beside
  an in-place read and write of the same state; then, for
  hymba-1.5b and rwkv6-3b at full width, compares kernel-path and
  plain-path logits (each beside its chaos floor: the plain path against
  itself with attention, or the WKV recurrence, in float64) and serves each
  through ``ServingEngine`` as above, with exact launch counts, the step
  times and the lockstep check (hymba's steps also cross its 1,024-slot
  ring);
* what-if: simulates the reference benchmark's fleet (64 devices x 3 h,
  seed 3) into a ``TelemetryStore``, replays the 200-config dense grid and
  the 10^4-config grid on the card through ``run_sweep`` (K4 cap-bucket
  scan, K7 cooldown chain), holds the outcomes against the NumPy oracle
  (time and count fields exact, energies and penalties within 1e-9
  relative), checks K4 and K7 against their plain versions at the largest
  padding bucket and times them; K4 also at every padding bucket (against
  its plain version under every launch plan and ``torch.searchsorted``;
  timed back to back under each plan and after an L2-sized read, beside
  ``torch.searchsorted`` and its bounds as stored and for the real samples;
  their sum beside K4's time in a profiled ``evaluate``) and on edge cases
  (NaN and infinite caps, rows all padding, a tail of 1 or off the 16-byte
  grid, rows past the shared-memory branch, C = 1, strided caps); K7 also
  at every padding bucket (at 8 and
  32 lanes a pair, each beside the bytes its fires need; their sum beside
  K7's time in a profiled ``evaluate``) and on synthetic edge buckets (K past one staged chunk,
  S = 1, pairs that fire on every run or never), each called twice for the
  same bits; times ``pareto_flags`` against the pairwise loop it replaced
  on the 10^4 grid's outcomes (the same flags); then runs the closed-loop
  ``search_frontier`` (default families, 100 evaluations, a budget of 1% of
  active time) on the card and on the NumPy oracle over the same store:
  the same configs in the same order, trace, knee and budget answer,
  counts exact, floats within 1e-9; with its time, each round's, and K4's
  and K7's launches in each;
* live: drives ``LiveController`` ticking on the card: the reference
  benchmark's live deployment (``SyntheticProducer``, 10^4 streams, 60 s
  windows of 5 s samples; 3 windows a tick each, then a 3-window backlog in
  one tick, then one tick under torch.profiler) and the what-if fleet
  drip-fed by ``SimulatorProducer`` in 6 windows of 30 min (default
  families, K4 and K7 in every tick), each tick held to a NumPy-backend
  controller fed the same shards (the same configs in the same order,
  counts exact, floats within 1e-9, the same knee), every refreshed tick on
  the ``warm_torch`` rung with no fallback; staleness, spans and K4/K7
  launches per tick; the extended IR against the one-shot IR's counts;
  child processes of the tiny crash/resume deployment killed by a fire-once
  fault plan at each tick-phase boundary, relaunched, and a restart after
  every tick, each ending on the uninterrupted child's frontier byte for
  byte; a clock-skewed shard (stale knee, watermark held), a truncated
  shard (coverage < 1) and a corrupt checkpoint (cold start); the
  Prometheus exposition linted.

Output: one line per phase; before the last, a ``{"kernels": [...]}`` JSON
line and the card's name and power limit from nvidia-smi; last, the
``{"ok": true, "device": ...}`` line. Any failure exits non-zero before the
last line. Exits 2 without a CUDA device or without the repository's
``src/repro_torch``. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
BF16_TOL = 2e-2                    # kernel vs plain, bf16 (tests/test_kernels.py)
F32_TOL = 2e-5                     # kernel vs plain, f32
SSM_TOL = 2e-3                     # K5 vs plain (tests/test_kernels.py:128)
WKV_TOL = 1e-3                     # K6 vs plain (tests/test_kernels.py:95,110)
LOGITS_BF16_TOL = 5e-2             # normwise, 32-40 layers of bf16 rounding
LOGITS_F32_TOL = 1e-4              # normwise, two f32 layers
#: no float64 or int64 rate in the H100 table; the float32 rate (outside the
#: tensor cores) is above both, so ops / this rate stays a lower bound on time
F32_OPS_PER_S = 67e12
WHATIF_RTOL = 1e-9                 # the what-if oracle contract (energies, penalties)
#: the reference benchmark's what-if deployment (benchmarks/whatif_bench.py:71-74)
WHATIF_DEPLOYMENT = dict(n_devices=64, horizon_s=3 * 3600, seed=3, shard_s=3 * 3600)
#: its host counts in BENCH_whatif_sweep.json (counts, not speeds)
WHATIF_REF_COUNTS = {"rows": 691_200, "runs": 27_460}
WHATIF_SAMPLE = 1000

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm.py:16",
    "flash_attention": "src/repro/kernels/flash_attention.py:26",
    "decode_attention": "src/repro/kernels/decode_attention.py:22",
    "cap_bucket_scan": "src/repro/kernels/run_replay.py:42",
    "downscale_replay": "src/repro/whatif/backend.py:428",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:24",
    "wkv6": "src/repro/kernels/rwkv6_scan.py:30",
}
#: K2's cases at Sq != Sk or without the causal mask: (Sq, Sk, H, KV, d,
#: causal, window)
CROSS_CASES = ((65, 1500, 20, 20, 64, False, 0), (1500, 1500, 20, 20, 64, False, 0),
               (65, 200, 8, 2, 128, True, 0), (65, 200, 8, 2, 128, True, 16),
               (65, 200, 8, 2, 128, False, 16), (130, 70, 8, 2, 64, True, 0),
               (130, 70, 8, 2, 64, False, 64), (130, 70, 8, 2, 64, True, 64),
               (70, 130, 8, 1, 256, False, 0))
SERVING_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan", "wkv6")
#: per model: the serve run's cache length and the logit check's prompt
#: (hymba: 2,048 tokens cross its 1,024-token window, a multiple of it)
SERVE_MAX_SEQ = {"llama-13b": 256, "hymba-1.5b": 2048, "rwkv6-3b": 256}
LOGITS_PROMPT = {"llama-13b": 32, "hymba-1.5b": 2048, "rwkv6-3b": 32}


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


def bound_ms(n_bytes: float, ops: float,
             ops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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
    g, w = got.double(), want.double()
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
    the serving path's shapes and the cases around them (attention also in
    f32, and twice, to show the same bits). Returns the max abs error at the
    main-path shape of each kernel."""
    import torch
    from repro_torch.kernels import decode_attention, ops

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
    # K2 prefill attention, model layout (B, S, H, d); bf16 takes the
    # tensor-core kernel, f32 the CUDA-core one. Around the 64-row tiles
    # (63, 64, 65), hymba-1.5b's 2,048-token prefill with and without its
    # 1,024-token window (GQA 25/5), every head dim.
    cases = [  # (b, s, h, kv, d, window, dtype, main)
        (1, 32, 40, 40, 128, 0, torch.bfloat16, True),     # llama-13b prefill bucket
        (1, 64, 8, 1, 256, 0, torch.bfloat16, False),      # MQA at d = 256 (gemma-2b)
        (2, 96, 8, 2, 64, 40, torch.bfloat16, False),      # GQA with a sliding window
        (1, 37, 40, 40, 128, 0, torch.bfloat16, False),    # ragged length
        *[(1, s, 25, 5, 64, 0, torch.bfloat16, False) for s in (63, 64, 65, 2048)],
        (1, 2048, 25, 5, 64, 1024, torch.bfloat16, False),
        *[(1, 65, 8, 2, d, 0, torch.bfloat16, False) for d in (32, 128, 256)],
        (1, 65, 25, 5, 64, 0, torch.float32, False),
        (1, 2048, 25, 5, 64, 1024, torch.float32, False),
    ]
    for b, s, h, kv, d, window, dtype, main in cases:
        q, k, v = rnd(b, s, h, d, dtype=dtype), rnd(b, s, kv, d, dtype=dtype), rnd(b, s, kv, d, dtype=dtype)
        name = f"flash b={b} s={s} h={h} kv={kv} d={d} w={window} {str(dtype)[6:]}"
        got = ops.flash_attention(q, k, v, window=window)
        e = check_close(name, got, ops.flash_attention(q, k, v, window=window, plain=True),
                        BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
        if not torch.equal(got, ops.flash_attention(q, k, v, window=window)):
            raise AssertionError(f"{name}: two calls differ")
        if main:
            errs["flash_attention"] = e
    # K2 without the causal mask and at Sq != Sk (the causal and window masks
    # aligned top-left, as the TPU kernel aligns them), in both dtypes:
    # Whisper's cross-attention (65 queries over 1,500 encoder frames, 20
    # heads of 64) and encoder self-attention, then ragged tiles on either
    # side of Sq = Sk with and without a window (each row keeps a key)
    for sq, sk, h, kv, d, causal, window in CROSS_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (rnd(1, sq, h, d, dtype=dtype), rnd(1, sk, kv, d, dtype=dtype),
                       rnd(1, sk, kv, d, dtype=dtype))
            name = (f"flash sq={sq} sk={sk} h={h} kv={kv} d={d} causal={causal} w={window} "
                    f"{str(dtype)[6:]}")
            kw = dict(causal=causal, window=window)
            got = ops.flash_attention(q, k, v, **kw)
            check_close(name, got, ops.flash_attention(q, k, v, plain=True, **kw),
                        BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
            if not torch.equal(got, ops.flash_attention(q, k, v, **kw)):
                raise AssertionError(f"{name}: two calls differ")
    # K3 decode attention, read in place from an (L, B, S, KV, d) cache, at
    # cache lengths around the split plan's chunks: llama-13b, hymba-1.5b's
    # global cache, MQA at d = 256 with S not a multiple of the chunk
    for b, s, h, kv, d, dtype in ((4, 256, 40, 40, 128, torch.bfloat16),
                                  (4, 2048, 25, 5, 64, torch.bfloat16),
                                  (2, 100, 8, 1, 256, torch.bfloat16),
                                  (4, 2048, 25, 5, 64, torch.float32)):
        kc, vc = rnd(3, b, s, kv, d, dtype=dtype), rnd(3, b, s, kv, d, dtype=dtype)
        q = rnd(b, 1, h, d, dtype=dtype)
        c, _ = decode_attention.split_plan(b, kv, s, d, kc.element_size())
        for cl in (0, 1, c - 1, c, c + 1, s // 2 + 1, s, s + 9):
            n = torch.full((), cl, dtype=torch.int32, device=dev)
            name = f"decode b={b} s={s} h={h} kv={kv} d={d} len={cl} {str(dtype)[6:]}"
            got = ops.decode_attention(q, kc[1], vc[1], n)
            if not torch.equal(got, ops.decode_attention(q, kc[1], vc[1], n)):
                raise AssertionError(f"{name}: two calls differ")
            if cl == 0:       # no valid slot: 0, as the TPU kernel gives
                if not torch.equal(got, torch.zeros_like(got)):
                    raise AssertionError(f"{name}: not 0")
                continue
            e = check_close(name, got, ops.decode_attention(q, kc[1], vc[1], n, plain=True),
                            BF16_TOL if dtype == torch.bfloat16 else F32_TOL)
            if (b, s, cl, dtype) == (4, 256, 256, torch.bfloat16):
                errs["decode_attention"] = e
    torch.cuda.synchronize()
    return errs


def time_kernels(dev) -> dict[str, dict]:
    """Kernel, plain version and PyTorch yardstick at the main path's shapes
    (llama-13b, bf16): RMSNorm over the 4 decode rows, prefill attention over
    the 32-token bucket, decode attention over 4 slots x 256 cache slots with
    the cache rotated over 8 layers (168 MB, past the 50 MB L2, as a decode
    step finds it). Beside them, under "extra", attention at hymba-1.5b's
    shapes: the 2,048-token prefill (25 q / 5 kv heads of 64) global and in
    a 1,024-token window, and the decode step over a (4, 2048, 5, 64) cache
    rotated over 8 layers (84 MB), each with its bound and SDPA
    (``enable_gqa=True``; a boolean mask for the window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def heads(*ts):
        return [t.transpose(1, 2) for t in ts]

    out = {}
    x, w = rnd(4, 1, 5120), rnd(5120)
    out["rmsnorm"] = dict(
        shape="x (4, 1, 5120) bf16",
        kernel=timed(lambda: ops.rmsnorm(x, w, 1e-6)),
        plain=timed(lambda: ops.rmsnorm(x, w, 1e-6, plain=True)),
        library=timed(lambda: F.rms_norm(x, (5120,), w, 1e-6)),
        bound=bound_ms(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel()), extra={},
        launch=rmsnorm_launch(dev, rnd))
    # hymba's prefill rows rotate over 8 copies (52 MB, past the L2), so its
    # time is against device memory, as its bound is
    it = iter(range(1 << 62))
    for label, shape, copies in (("hymba_decode", (4, 1, 1600), 1),
                                 ("llama_prefill", (1, 32, 5120), 1),
                                 ("hymba_prefill", (1, 2048, 1600), 8)):
        xs, w = rnd(copies, *shape), rnd(shape[-1])
        x = xs[0]
        out["rmsnorm"]["extra"][label] = dict(
            shape=f"x {shape} bf16" + (f", rotated over {copies} copies" if copies > 1 else ""),
            ms=graph_ms(lambda xs=xs, w=w, n=copies: ops.rmsnorm(xs[next(it) % n], w, 1e-6)),
            library_ms=graph_ms(lambda xs=xs, w=w, n=copies: F.rms_norm(
                xs[next(it) % n], (w.numel(),), w, 1e-6)),
            bound=bound_ms(2 * x.numel() * 2 + w.numel() * 2, 4 * x.numel()))

    b, s, h, d = 1, 32, 40, 128
    q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
    pairs = s * (s + 1) // 2
    out["flash_attention"] = dict(
        shape="q, k, v (1, 32, 40, 128) bf16, causal",
        kernel=timed(lambda: ops.flash_attention(q, k, v)),
        plain=timed(lambda: ops.flash_attention(q, k, v, plain=True)),
        library=timed(lambda: F.scaled_dot_product_attention(*heads(q, k, v), is_causal=True)),
        bound=bound_ms(4 * q.numel() * 2, 4 * d * b * h * pairs), extra={})
    s, h, kv, d = 2048, 25, 5, 64
    q, k, v = rnd(1, s, h, d), rnd(1, s, kv, d), rnd(1, s, kv, d)
    pos = torch.arange(s, device=dev)
    for label, window in (("hymba_global", 0), ("hymba_window", 1024)):
        keep = pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
        pairs = int(keep.sum())
        sdpa = dict(is_causal=True) if not window else dict(attn_mask=keep)
        out["flash_attention"]["extra"][label] = dict(
            shape=f"q (1, 2048, 25, 64), k, v (1, 2048, 5, 64) bf16, causal"
                  + (", window 1024" if window else ""),
            ms=graph_ms(lambda w=window: ops.flash_attention(q, k, v, window=w), 20),
            library_ms=graph_ms(lambda kw=sdpa: F.scaled_dot_product_attention(
                *heads(q, k, v), enable_gqa=True, **kw), 20),
            bound=bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2, 4 * d * h * pairs))

    it = iter(range(1 << 62))

    def rotate(fn, n):
        return lambda: fn(next(it) % n)

    layers, b, s, h, d = 8, 4, 256, 40, 128
    kc, vc = rnd(layers, b, s, h, d), rnd(layers, b, s, h, d)
    q = rnd(b, 1, h, d)
    n = torch.full((), s, dtype=torch.int32, device=dev)
    out["decode_attention"] = dict(
        shape="q (4, 1, 40, 128), caches (4, 256, 40, 128) bf16, len 256",
        kernel=timed(rotate(lambda i: ops.decode_attention(q, kc[i], vc[i], n), layers)),
        plain=timed(rotate(lambda i: ops.decode_attention(
            q, kc[i], vc[i], n, plain=True), layers), 40),
        library=timed(rotate(lambda i: F.scaled_dot_product_attention(
            *heads(q, kc[i], vc[i])), layers)),
        bound=bound_ms(2 * q.numel() * 2 + 2 * b * s * h * d * 2, 4 * d * b * h * s))
    del kc, vc
    b, s, h, kv, d = 4, 2048, 25, 5, 64
    kc, vc = rnd(layers, b, s, kv, d), rnd(layers, b, s, kv, d)
    q = rnd(b, 1, h, d)
    n = torch.full((), s, dtype=torch.int32, device=dev)
    out["decode_attention"]["extra"] = {"hymba_global": dict(
        shape="q (4, 1, 25, 64), caches (4, 2048, 5, 64) bf16, len 2048",
        ms=graph_ms(rotate(lambda i: ops.decode_attention(q, kc[i], vc[i], n), layers)),
        library_ms=graph_ms(rotate(lambda i: F.scaled_dot_product_attention(
            *heads(q, kc[i], vc[i]), enable_gqa=True), layers)),
        bound=bound_ms(2 * q.numel() * 2 + 2 * b * s * kv * d * 2, 4 * d * b * h * s))}
    return out


def rmsnorm_launch(dev, rnd) -> dict:
    """K1's launch floor and marginal cost: the per-call time of an empty
    one-warp kernel launched as K1 is, and of K1 at (4, 1, 5120), each in a
    100-call graph; and in a graph of 100 x (the GEMM before K1 in the
    decode step, then K1 on its output) the time beyond 100 x the GEMM
    alone (the mean of one graph before and one after), for K1 and for the
    empty kernel in its place. GEMMs: llama-13b's (4, 5120) x (5120, 5120)
    and hymba-1.5b's attention out-projection (4, 1600) x (1600, 1600)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k1
    res = {"empty_ms": graph_ms(lambda: k1.empty_launch(dev), replays=20)}
    x, w = rnd(4, 1, 5120), rnd(5120)
    res["k1_ms"] = graph_ms(lambda: ops.rmsnorm(x, w, 1e-6), replays=20)
    for label, d in (("llama", 5120), ("hymba", 1600)):
        a, wgt, w = rnd(4, 1, d), rnd(d, d), rnd(d)
        gemm = graph_ms(lambda: a @ wgt, replays=20)
        both = graph_ms(lambda: ops.rmsnorm(a @ wgt, w, 1e-6), replays=20)
        empty = graph_ms(lambda: (a @ wgt, k1.empty_launch(dev)), replays=20)
        gemm = (gemm + graph_ms(lambda: a @ wgt, replays=20)) / 2
        res[label] = dict(gemm_ms=gemm, k1_marginal_ms=both - gemm,
                          empty_marginal_ms=empty - gemm)
    return res


def ssm_args(g, dev, bsz, s, big_dt=False):
    """K5 inputs at hymba-1.5b's widths (I = 3200, N = 16) as the Mamba
    branch passes them (float32): u, B, C normal, dt = softplus(normal)
    (x 100 for ``big_dt``), a = -exp(0.5 normal)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = F.softplus(rnd(bsz, s, 3200)) * (100.0 if big_dt else 1.0)
    return (rnd(bsz, s, 3200), dt, -torch.exp(0.5 * rnd(3200, 16)), rnd(bsz, s, 16),
            rnd(bsz, s, 16))


def wkv_args(g, dev, b, s, extreme=False):
    """K6 inputs at rwkv6-3b's widths (H = 40, K = 64) in the model's
    (B, S, H, K) layout (float32): r, k, v normal, w = 0.4 + 0.55
    sigmoid(normal) or, for ``extreme``, each decay from {1e-4, 0.999};
    u = 0.1 normal."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = rnd(b, s, 40, 64), rnd(b, s, 40, 64), rnd(b, s, 40, 64)
    if extreme:
        w = torch.where(rnd(b, s, 40, 64) > 0, 0.999, 1e-4)
    else:
        w = 0.4 + 0.55 * torch.sigmoid(rnd(b, s, 40, 64))
    return r, k, v, w, 0.1 * rnd(40, 64)


def check_recurrent_kernels(dev) -> dict[str, float]:
    """K5 and K6 against their plain versions per element, each call twice
    for the same bits: the serving path's prefill and decode shapes
    (hymba-1.5b I = 3200, N = 16; rwkv6-3b H = 40, K = 64), the 2,048-token
    prefill of the logit check, a ragged length, S = 1 from a carried state,
    a state carried across two calls against one call, large dt (exp(dt a)
    -> 0) and extreme decays; at the decode and the 32-token prefill shapes
    also every launch plan's branch (K5 with 1, 2 and 4 state entries a
    thread and the scalar path with a strided a; K6 with 1 and 2 column
    slices, and a state off the 16-byte grid, moved as single floats).
    Returns the max abs error at the decode-step shape of each."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(11)
    errs = {}

    def both(name, tol, fn, args, want, **kw):
        got = fn(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, fn(*args, **kw))):
            raise AssertionError(f"{name}: two calls differ")
        return max(check_close(f"{name} {i}", a, b, tol)
                   for i, (a, b) in enumerate(zip(got, want)))

    for bsz, s, state, big_dt in ((1, 32, False, False), (4, 1, True, False),
                                  (1, 2048, False, False), (2, 37, True, False),
                                  (2, 40, True, True)):
        u, dt, a, b, c = ssm_args(g, dev, bsz, s, big_dt=big_dt)
        h0 = torch.randn(bsz, 3200, 16, generator=g, device=dev) if state else None
        name = f"ssm_scan B={bsz} S={s} h0={state} big_dt={big_dt}"
        want = ops.ssm_scan(u, dt, a, b, c, h0, plain=True)
        e = both(name, SSM_TOL, ops.ssm_scan, (u, dt, a, b, c, h0), want)
        if (bsz, s) == (4, 1):
            errs["ssm_scan"] = e
        if (bsz, s) in ((4, 1), (1, 32)):           # every branch of the plan
            for group in k5.GROUPS:
                plan = k5.launch_plan(bsz, s, 3200, 16, True, group)
                both(f"{name} group={group}", SSM_TOL, k5.ssm_scan, (u, dt, a, b, c, h0),
                     want, plan=plan)
            strided = a.t().contiguous().t()
            both(f"{name} strided a", SSM_TOL, ops.ssm_scan, (u, dt, strided, b, c, h0), want)
        if s > 1:                       # carried across two calls, the second in place
            y1, h1 = ops.ssm_scan(u[:, :13], dt[:, :13], a, b[:, :13], c[:, :13], h0)
            y2, h2 = ops.ssm_scan(u[:, 13:], dt[:, 13:], a, b[:, 13:], c[:, 13:], h1, h1)
            for i, (x, w) in enumerate(zip((torch.cat([y1, y2], 1), h2), want)):
                check_close(f"{name} carried {i}", x, w, SSM_TOL)
    for bsz, s, state, extreme in ((1, 32, False, False), (4, 1, True, False),
                                   (2, 37, True, False), (1, 64, True, True)):
        r, k, v, w, u = wkv_args(g, dev, bsz, s, extreme=extreme)
        st0 = torch.randn(bsz, 40, 64, 64, generator=g, device=dev) if state else None
        name = f"wkv6 B={bsz} S={s} state={state} extreme={extreme}"
        want = ops.wkv6(r, k, v, w, u, st0, plain=True)
        e = both(name, WKV_TOL, ops.wkv6, (r, k, v, w, u, st0), want)
        if (bsz, s) == (4, 1):
            errs["wkv6"] = e
        if (bsz, s) in ((4, 1), (1, 32)):
            heads = [x.transpose(1, 2) for x in (r, k, v, w)]
            for slices in k6.SLICES:
                plan = k6.launch_plan(bsz, 40, s, 64, slices)
                y, st = k6.wkv6(*heads, u, st0, plan=plan)
                again = k6.wkv6(*heads, u, st0, plan=plan)
                if not (torch.equal(y, again[0]) and torch.equal(st, again[1])):
                    raise AssertionError(f"{name} slices={slices}: two calls differ")
                check_close(f"{name} slices={slices} 0", y.transpose(1, 2), want[0], WKV_TOL)
                check_close(f"{name} slices={slices} 1", st, want[1], WKV_TOL)
            if state:
                shifted = torch.empty(st0.numel() + 1, device=dev)[1:].view(st0.shape)
                both(f"{name} state off the 16-byte grid", WKV_TOL, ops.wkv6,
                     (r, k, v, w, u, shifted.copy_(st0)), want)
        if s > 1:
            y1, st1 = ops.wkv6(r[:, :13], k[:, :13], v[:, :13], w[:, :13], u, st0)
            y2, st2 = ops.wkv6(r[:, 13:], k[:, 13:], v[:, 13:], w[:, 13:], u, st1, st1)
            for i, (x, want_i) in enumerate(zip((torch.cat([y1, y2], 1), st2), want)):
                check_close(f"{name} carried {i}", x, want_i, WKV_TOL)
    torch.cuda.synchronize()
    return errs


def time_recurrent_kernels(dev) -> dict[str, dict]:
    """K5 and K6 at the decode step's shape, the state carried in place as
    the models carry it and rotated over enough layers' states (105 MB) to
    miss the 50 MB L2, as a decode step finds it; also their card time at the
    32-token prefill and K5's at the 2,048-token prefill of the logit check
    (u and dt rotated over 2 copies, 105 MB). Each beside the plan it used
    and, under "plans", the time under each other plan (K5's state entries
    a thread, K6's column slices). Bounds from this run's bytes (each input
    read once, each output written once) and operations (K5 ~8 per (row,
    step, channel, state), K6 ~7 per (row, step, head, k, v), at the float32
    rate). No single PyTorch call computes either function; beside the
    decode time, "state_floor_ms" is an in-place ``mul_(1.0)`` of the same
    state, rotated the same way: one streaming read and write of its bytes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(12)
    it = iter(range(1 << 62))

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def plan_str(plan):
        return ", ".join(f"{k}={v}" for k, v in dataclasses.asdict(plan).items())

    out = {}
    u, dt, a, b, c = ssm_args(g, dev, 4, 1)
    copies = 128                                   # 128 x 0.82 MB of state
    hs = torch.randn(copies, 4, 3200, 16, generator=g, device=dev)

    def k5_decode(plan=None, plain=False):
        h = hs[next(it) % copies]
        if plain:
            return ops.ssm_scan(u, dt, a, b, c, h, h, plain=True)
        return k5.ssm_scan(u, dt, a, b, c, h, h, plan=plan)

    pu, pdt, pa, pb, pc = ssm_args(g, dev, 1, 32)
    lus, ldts = [], []
    for _ in range(2):
        lu, ldt, la, lb, lc = ssm_args(g, dev, 1, 2048)
        lus.append(lu)
        ldts.append(ldt)

    def k5_long(plan=None):
        i = next(it) % 2
        return k5.ssm_scan(lus[i], ldts[i], la, lb, lc, plan=plan)

    shapes = {"decode": (4, 1), "prefill": (1, 32), "prefill_2048": (1, 2048)}
    calls = {"decode": k5_decode,
             "prefill": lambda plan=None: k5.ssm_scan(pu, pdt, pa, pb, pc, plan=plan),
             "prefill_2048": k5_long}
    plans = {label: {f"group={grp}": dict(
        plan=plan_str(k5.launch_plan(*shapes[label], 3200, 16, True, grp)),
        ms=graph_ms(lambda p=k5.launch_plan(*shapes[label], 3200, 16, True, grp), f=fn: f(p),
                    20 if label == "prefill_2048" else 100))
        for grp in k5.GROUPS} for label, fn in calls.items()}
    out["ssm_scan"] = dict(
        shape="u, dt (4, 1, 3200), a (3200, 16), B, C (4, 1, 16), h (4, 3200, 16) "
              "f32, state in place",
        state_floor_ms=graph_ms(lambda: hs[next(it) % copies].mul_(1.0)),
        plan=plan_str(k5.launch_plan(4, 1, 3200, 16, True)),
        kernel=timed(k5_decode), plain=timed(lambda: k5_decode(plain=True), 40), library=None,
        bound=bound_ms(nbytes(u, dt, a, b, c, hs[0]) + nbytes(u, hs[0]),
                       8 * u.numel() * 16, F32_OPS_PER_S),
        prefill=dict(shape="u, dt (1, 32, 3200) f32, zero state",
                     plan=plan_str(k5.launch_plan(1, 32, 3200, 16, True)),
                     ms=graph_ms(calls["prefill"]),
                     bound=bound_ms(nbytes(pu, pdt, pa, pb, pc, pu) + 3200 * 16 * 4,
                                    8 * pu.numel() * 16, F32_OPS_PER_S)),
        prefill_2048=dict(shape="u, dt (1, 2048, 3200) f32 rotated over 2 copies, zero state",
                          plan=plan_str(k5.launch_plan(1, 2048, 3200, 16, True)),
                          ms=graph_ms(k5_long, 20),
                          bound=bound_ms(nbytes(lus[0], ldts[0], la, lb, lc, lus[0])
                                         + 3200 * 16 * 4, 8 * lus[0].numel() * 16,
                                         F32_OPS_PER_S)),
        plans=plans)

    r, k, v, w, uu = wkv_args(g, dev, 4, 1)
    copies = 40                                    # 40 x 2.6 MB of state
    sts = torch.randn(copies, 4, 40, 64, 64, generator=g, device=dev)
    heads = [x.transpose(1, 2) for x in (r, k, v, w)]

    def k6_decode(plan=None, plain=False):
        st = sts[next(it) % copies]
        if plain:
            return ops.wkv6(r, k, v, w, uu, st, st, plain=True)
        return k6.wkv6(*heads, uu, st, st, plan=plan)

    pr, pk, pv, pw, pu6 = wkv_args(g, dev, 1, 32)
    pheads = [x.transpose(1, 2) for x in (pr, pk, pv, pw)]
    calls = {"decode": (k6_decode, (4, 40, 1, 64)),
             "prefill": (lambda plan=None: k6.wkv6(*pheads, pu6, plan=plan), (1, 40, 32, 64))}
    plans = {label: {f"slices={c}": dict(
        plan=plan_str(k6.launch_plan(*shape, c)),
        ms=graph_ms(lambda p=k6.launch_plan(*shape, c), f=fn: f(p)))
        for c in k6.SLICES} for label, (fn, shape) in calls.items()}
    out["wkv6"] = dict(
        shape="r, k, v, w (4, 1, 40, 64), u (40, 64), state (4, 40, 64, 64) f32, "
              "state in place",
        state_floor_ms=graph_ms(lambda: sts[next(it) % copies].mul_(1.0)),
        plan=plan_str(k6.launch_plan(4, 40, 1, 64)),
        kernel=timed(k6_decode), plain=timed(lambda: k6_decode(plain=True), 40), library=None,
        bound=bound_ms(nbytes(r, k, v, w, uu, sts[0]) + nbytes(r, sts[0]),
                       7 * r.numel() * 64, F32_OPS_PER_S),
        prefill=dict(shape="r, k, v, w (1, 32, 40, 64) f32, zero state",
                     plan=plan_str(k6.launch_plan(1, 40, 32, 64)),
                     ms=graph_ms(calls["prefill"][0]),
                     bound=bound_ms(nbytes(pr, pk, pv, pw, pu6, pr) + 40 * 64 * 64 * 4,
                                    7 * pr.numel() * 64, F32_OPS_PER_S)),
        plans=plans)
    return out


def step_ms(fn, steps: int = 10, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` as the engine's phases time a step:
    CUDA events around the call, then a synchronisation, so the host's
    launch cost is in the number wherever it exceeds the card's time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / steps


def covered(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: the time in
    which at least one of them runs."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def profile_steps(fn, steps: int = 3) -> dict:
    """``steps`` calls of ``fn`` under torch.profiler, after a profiled
    warm-up step (a profile's first device records can be lost): per call,
    the card's busy time as the sum of its operations' times (as earlier
    versions of this script read it) and as the time in which at least one runs (their intervals'
    union: a kernel launched early by programmatic dependent launch, as
    cuBLAS's may be, overlaps the one before it, and the sum counts the
    overlap twice), its device operations, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    active = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append((p.key_averages(),
                                                         p.events()))) as prof:
        for _ in range(2):
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    averages, events = active[0]
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    ours: dict[str, float] = {}
    launches: dict[str, float] = {}
    for e in on_card:                 # the port's kernels, by name
        m = re.search(r"repro::(\w+)", e.key)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / steps
            launches[m.group(1)] = launches.get(m.group(1), 0) + e.count / steps
    return {
        "card_busy_ms_per_step": sum(e.self_device_time_total for e in on_card) / 1e3 / steps,
        "card_active_ms_per_step": covered(spans) / 1e3 / steps,
        "device_ops_per_step": sum(e.count for e in on_card) / steps,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
        "repro_kernels_ms_per_step": ours,
        "repro_launches_per_step": launches,
    }


def decode_step_times(engine, serve_ms: float) -> dict:
    """The engine's decode step as a CUDA-graph replay and eagerly, on the
    same parameters and cache: each step's time (:func:`step_ms`) beside the
    card's busy time (:func:`profile_steps`) and the idle share between
    them; the serve run's mean decode phase beside them."""
    import torch
    from repro_torch.models import api

    tokens = torch.full((engine.ec.n_slots, 1), 7, dtype=torch.long,
                        device=engine.torch_device)
    steps = {"replayed": lambda: engine.decode(tokens),
             "eager": lambda: api.decode_step(engine.params, engine.cache, tokens, engine.cfg)}
    result = {}
    for label, fn in steps.items():
        ms = step_ms(fn)
        prof = profile_steps(fn)
        busy = prof["card_busy_ms_per_step"]
        if busy <= 0:
            raise AssertionError(f"{label} decode step: the profiler saw no device time")
        result[label] = {"step_ms": ms, "card_idle_share": 1.0 - busy / ms,
                         "card_idle_share_active": 1.0 - prof["card_active_ms_per_step"] / ms,
                         **prof}
    result["serve_run_mean_decode_ms"] = serve_ms
    name = engine.cfg.name
    log(f"profile {name} decode step " + json.dumps(result))
    rep, eag = result["replayed"], result["eager"]
    log(f"decode step {name} (4 slots): " + "; ".join(
        f"{label} {r['step_ms']:.4f} ms, card busy {r['card_busy_ms_per_step']:.4f} ms "
        f"(idle {r['card_idle_share']:.1%}), active {r['card_active_ms_per_step']:.4f} ms "
        f"(idle {r['card_idle_share_active']:.1%}), {r['device_ops_per_step']:.0f} device ops"
        for label, r in (("replayed", rep), ("eager", eag)))
        + f"; serve run's replayed phase {serve_ms:.4f} ms; card {nvidia_smi_line()}")
    return result


def same_bits(label: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max()
        raise AssertionError(f"{label}: the replay differs from the eager step "
                             f"(max abs diff {float(diff)})")


def lockstep(engine, start_len: int, steps: int = 8, seed: int = 5) -> dict:
    """The engine's captured graphs against the eager step functions, bit
    for bit: its cache is filled with seeded values and its shared ``len``
    set to ``start_len``, a clone of it goes forward ``steps`` decode steps
    by eager ``api.decode_step`` while the engine replays its decode graph
    on the same tokens, and the logits, every cache tensor and ``len`` are
    compared after each step; then one prefill, replayed and eager, on the
    same tokens. From ``max_seq_len - 4`` the steps cross the shared-length
    clamp, and for hymba its window layers' ring wrap. Leaves the engine's
    cache in its last state; launches count as they happen."""
    import torch
    from repro_torch.models import api
    from repro_torch.serving.engine import clone_cache

    cfg, dev, n = engine.cfg, engine.torch_device, engine.ec.n_slots
    g = torch.Generator(device=dev).manual_seed(seed)
    for t, _ in api.cache_rows(cfg, engine.cache):
        t.copy_(0.5 * torch.randn(t.shape, generator=g, device=dev))
    engine.cache["len"].fill_(start_len)
    eager = clone_cache(engine.cache)
    for step in range(steps):
        tokens = torch.randint(2, cfg.vocab_size, (n, 1), generator=g, device=dev)
        _, want = api.decode_step(engine.params, eager, tokens, cfg)
        got = engine.decode(tokens)
        same_bits(f"{cfg.name} decode step {step} logits", got, want)
        for i, ((a, _), (b, _)) in enumerate(zip(api.cache_rows(cfg, engine.cache),
                                                 api.cache_rows(cfg, eager))):
            same_bits(f"{cfg.name} decode step {step} cache tensor {i}", a, b)
        same_bits(f"{cfg.name} decode step {step} len", engine.cache["len"], eager["len"])
        if not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name} decode step {step}: non-finite logits")
    end_len = int(engine.cache["len"])
    if end_len != start_len + steps:
        raise AssertionError(f"{cfg.name}: len {end_len} after {steps} steps from {start_len}")
    tokens = torch.randint(2, cfg.vocab_size, (1, engine.bucket), generator=g, device=dev)
    want_cache, want = api.prefill(engine.params, tokens, cfg)
    got_cache, got = engine.prefill(tokens)
    same_bits(f"{cfg.name} prefill logits", got, want)
    for i, ((a, _), (b, _)) in enumerate(zip(api.cache_rows(cfg, got_cache),
                                             api.cache_rows(cfg, want_cache))):
        same_bits(f"{cfg.name} prefill cache tensor {i}", a, b)
    same_bits(f"{cfg.name} prefill len", got_cache["len"], want_cache["len"])
    result = {"steps": steps, "len": [start_len, end_len], "cache_len": engine.ec.max_seq_len,
              "cache_tensors": len(api.cache_rows(cfg, engine.cache)),
              "prefill_tokens": engine.bucket}
    log(f"lockstep {cfg.name}: {steps} replayed decode steps (len {start_len} -> {end_len}, "
        f"cache {engine.ec.max_seq_len} slots) and one replayed {engine.bucket}-token "
        f"prefill == the eager steps bit for bit (logits, {result['cache_tensors']} cache "
        f"tensors, len)")
    return result


def logit_runs(cfg, params, dev, prompt: int, plain: bool) -> list:
    """Logits of one ``prompt``-token prefill and two decode steps on seeded
    tokens (the same tokens for every call)."""
    import torch
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(2, cfg.vocab_size, (1, prompt), generator=g, device=dev)
    steps = torch.randint(2, cfg.vocab_size, (2, 1, 1), generator=g, device=dev)
    cache, logits = api.prefill(params, tokens, cfg, plain=plain)
    cache = api.pad_cache(cfg, cache, prompt + 8)
    seq = [logits.float()]
    for t in steps:
        cache, logits = api.decode_step(params, cache, t, cfg, plain=plain)
        seq.append(logits.float())
    return seq


def normwise_error(got: list, want: list, cfg, label: str) -> float:
    """The worst normwise relative error over the runs' logits, after
    checking that every logit is finite and of the expected shape."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: bad logits at step {i}: {a.shape}")
        worst = max(worst, float((a - b).norm() / b.norm()))
    return worst


def compare_logits(cfg, params, dev, tol: float, label: str, prompt: int = 32,
                   floor: bool = False):
    """Kernel path against plain path on the same tokens: the worst normwise
    relative logit error over a prefill and two decode steps, gated at
    ``tol``. With ``floor``, also the chaos floor beside it (the plain path
    against itself with attention in float64, :func:`attention_f64_floor`);
    returns both then."""
    plain = logit_runs(cfg, params, dev, prompt, True)
    worst = normwise_error(logit_runs(cfg, params, dev, prompt, False), plain, cfg, label)
    if worst > tol:
        raise AssertionError(f"{label}: normwise logit error {worst} > {tol}")
    msg = (f"logits {label}: {prompt}-token prefill + 2 decode steps, kernel vs plain "
           f"normwise rel err {worst:.3e} (tol {tol})")
    if not floor:
        log(msg)
        return worst
    chaos = attention_f64_floor(cfg, params, dev, prompt, plain)
    log(msg + f"; chaos floor (plain vs plain with attention in float64) {chaos:.3e}")
    return {"kernel_vs_plain": worst, "plain_f32_vs_f64_attention": chaos}


def mha_f64(q, k, v, *, causal: bool = True, window: int = 0):
    """The plain prefill attention in float64, cast to q's type: a second
    correct computation of the same function, for the chaos floor."""
    import torch
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k.double(), h // kvh, dim=1)
    v = torch.repeat_interleave(v.double(), h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k) / d ** 0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window > 0:
        keep &= kp > qp - window
    s = torch.where(keep, s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v).to(q.dtype)


def decode_f64(q, k_cache, v_cache, cache_len):
    """The plain decode attention in float64, cast to q's type."""
    import torch
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    k = torch.repeat_interleave(k_cache.double(), h // kvh, dim=1)
    v = torch.repeat_interleave(v_cache.double(), h // kvh, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", q.double(), k) / d ** 0.5
    sc = torch.where(torch.arange(s, device=q.device)[None, None, :] < cache_len, sc, -1e30)
    return torch.einsum("bhk,bhkd->bhd", torch.softmax(sc, -1), v).to(q.dtype)


def attention_f64_floor(cfg, params, dev, prompt: int, plain: list) -> float:
    """The plain path's logits with both attention functions in float64,
    against the plain path's (``plain``): how far two correct computations
    of the model fall apart in bf16. A kernel-vs-plain error near it cannot
    be told from rounding."""
    from repro_torch.kernels import decode_attention, flash_attention
    saved = flash_attention.flash_attention_plain, decode_attention.decode_attention_plain
    flash_attention.flash_attention_plain = mha_f64
    decode_attention.decode_attention_plain = decode_f64
    try:
        f64 = logit_runs(cfg, params, dev, prompt, True)
    finally:
        flash_attention.flash_attention_plain, decode_attention.decode_attention_plain = saved
    return normwise_error(f64, plain, cfg, f"{cfg.name} f64 attention")


def wkv6_f64(r, k, v, w, u, state0=None, state_out=None):
    """The plain WKV recurrence in float64, cast back to float32: a second
    correct computation of the same function, for the chaos floor."""
    import torch
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    b, h, s, kd = r.shape
    st = (torch.zeros((b, h, kd, kd), dtype=torch.float64, device=r.device)
          if state0 is None else state0.double())
    ys = []
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], st + u[None, :, :, None] * kv))
        st = w[:, :, t, :, None] * st + kv
    y = torch.stack(ys, dim=2).float()
    return y, (st.float() if state_out is None else state_out.copy_(st))


def rwkv_logits(cfg, params, dev, prompt: int) -> dict:
    """rwkv6-3b's end-to-end bf16 logits: kernel path against plain path, and
    the chaos floor beside it, the plain path against itself with the WKV
    recurrence in float64. The random-weight model is chaotic in bf16: a
    rounding-level change in the WKV outputs grows over 32 layers to tenths
    of the logits' norm (0.27 for float64 against float32 on an H100), so
    two correct computations fall that far apart and no limit on this
    number can tell a right kernel from a wrong one. Both numbers are
    reported; the kernel path is held layer by layer
    (:func:`rwkv_layers_check`) instead."""
    from repro_torch.kernels import rwkv6_scan
    plain = logit_runs(cfg, params, dev, prompt, True)
    kernel = normwise_error(logit_runs(cfg, params, dev, prompt, False), plain, cfg,
                            "rwkv kernel")
    saved = rwkv6_scan.wkv6_plain
    rwkv6_scan.wkv6_plain = wkv6_f64
    try:
        floor = normwise_error(logit_runs(cfg, params, dev, prompt, True), plain, cfg,
                               "rwkv f64")
    finally:
        rwkv6_scan.wkv6_plain = saved
    log(f"logits {cfg.name} bf16 ({cfg.n_layers} layers): {prompt}-token prefill + 2 "
        f"decode steps, kernel vs plain normwise rel err {kernel:.3e}; chaos floor "
        f"(plain vs plain with WKV in float64) {floor:.3e}; not gated, see the layer check")
    return {"kernel_vs_plain": kernel, "plain_f32_vs_f64_wkv": floor}


def rwkv_layers_check(cfg, params, dev, tol: float, prompt: int = 32) -> float:
    """Each RWKV-6 layer at full width, kernel path against plain path on the
    same input and carried states (the plain path's), over a
    ``prompt``-token prefill and two decode steps in bf16: the worst
    normwise relative error of the layer outputs and WKV states. Unlike the
    end-to-end logits these errors do not compound through the layers."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models import rwkv

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(2, cfg.vocab_size, (1, prompt), generator=g, device=dev)
    steps = torch.randint(2, cfg.vocab_size, (2, 1, 1), generator=g, device=dev)
    cache = rwkv.init_cache(cfg, 1, 0, dev)
    worst = 0.0
    for toks in [tokens, *steps]:
        x = cm.layernorm(params["embed"][toks], params["ln0_w"], params["ln0_b"])
        for i in range(cfg.n_layers):
            lp = cm.layer(params["layers"], i)
            outs = {}
            for plain in (False, True):
                state = cache["wkv"][i].clone()
                out = rwkv._block(x, lp, cfg, cache["tm_shift"][i], cache["cm_shift"][i],
                                  state, state, plain)
                outs[plain] = (out[0], state, *out[1:])
            for a, b in zip(outs[False][:2], outs[True][:2]):
                if not torch.isfinite(a).all():
                    raise AssertionError(f"rwkv layer {i}: non-finite output")
                worst = max(worst, float((a.float() - b.float()).norm() / b.float().norm()))
            x, state, tm, cmix = outs[True]
            cache["wkv"][i].copy_(state)
            cache["tm_shift"][i].copy_(tm)
            cache["cm_shift"][i].copy_(cmix)
    if worst > tol:
        raise AssertionError(f"rwkv layer check: normwise error {worst} > {tol}")
    log(f"layers {cfg.name} bf16: each of {cfg.n_layers} layers, kernel vs plain on the "
        f"plain path's input and state over a {prompt}-token prefill + 2 decode steps, "
        f"worst normwise rel err of outputs and WKV states {worst:.3e} (tol {tol})")
    return worst


def expected_launches(cfg, n_prefill: int, n_decode: int) -> dict[str, int]:
    """Each kernel's launches in a serve run of ``cfg``'s family: one RMSNorm
    per norm of each forward (dense 2 per layer + final, hymba 4 per layer +
    final), attention per layer (K2 at a prefill, K3 at a decode step), K5
    per hymba layer and K6 per RWKV layer of every forward; 0 elsewhere."""
    from repro_torch import kernels
    n_layers, fwd = cfg.n_layers, n_prefill + n_decode
    expect = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    if cfg.family in ("dense", "hybrid"):
        norms = 2 if cfg.family == "dense" else 4
        expect.update(rmsnorm=(norms * n_layers + 1) * fwd,
                      flash_attention=n_layers * n_prefill,
                      decode_attention=n_layers * n_decode)
    if cfg.family == "hybrid":
        expect["ssm_scan"] = n_layers * fwd
    if cfg.family == "rwkv":
        expect["wkv6"] = n_layers * fwd
    return expect


def serve(cfg, params, dev) -> tuple:
    """A main path: ServingEngine on azure_code requests, controller on, with
    every kernel's launches counted from 0 and checked exactly."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.telemetry import analyze_job
    from repro_torch.traces import generate_trace, get_trace

    ec = EngineConfig(n_slots=4, max_seq_len=SERVE_MAX_SEQ[cfg.name], prefill_bucket=32,
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
    wgmma = flash_attention.WGMMA_LAUNCHES

    n_prefill = len(engine.phase_ms["prefill"])
    n_decode = len(engine.phase_ms["decode"])
    expect = expected_launches(cfg, n_prefill, n_decode)
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if wgmma != launches["flash_attention"]:
        raise AssertionError(f"{wgmma} of {launches['flash_attention']} bf16 prefill "
                             "attention launches took the tensor-core kernel")
    if stats.n < 4:
        raise AssertionError(f"only {stats.n} requests completed (< 4)")
    if not all(0 <= r.req_id for r in engine.completed):
        raise AssertionError("bad completed requests")
    frame = engine.sampler.frame()
    ja = analyze_job(frame, job_id=1, min_duration_s=1.0)
    decode_ms = float(np.mean(engine.phase_ms["decode"]))
    result = {
        "model": cfg.name, "max_seq_len": ec.max_seq_len,
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
        "flash_wgmma_launches": wgmma,
    }
    log(f"serve {cfg.name} " + json.dumps(result))
    return result, engine


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return tree.numel()


def serve_model(name: str, dev) -> dict:
    """One model at full width: parameters made on the card from a seed, the
    logit checks (full depth in bf16, two layers in f32), the serve run, the
    replayed and eager decode steps timed and profiled, and the lockstep
    check of the engine's graphs. Frees the model before it returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(name)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"{name}: {count_params(params) / 1e9:.3f} B parameters in bf16, made on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    prompt = LOGITS_PROMPT[name]
    checks = {}
    if cfg.family == "rwkv":
        checks["logits_bf16"] = rwkv_logits(cfg, params, dev, prompt)
        checks["layers_bf16"] = rwkv_layers_check(cfg, params, dev, LOGITS_BF16_TOL, prompt)
    else:
        checks["logits_bf16"] = compare_logits(cfg, params, dev, LOGITS_BF16_TOL,
                                               f"{name} bf16 ({cfg.n_layers} layers)", prompt,
                                               floor=cfg.family == "hybrid")
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params32 = api.init_params(torch.Generator(device=dev).manual_seed(4), cfg32)
    checks["logits_f32_2_layers"] = compare_logits(
        cfg32, params32, dev, LOGITS_F32_TOL, f"{name} widths f32 (2 layers)", prompt)
    del params32
    torch.cuda.empty_cache()

    result, engine = serve(cfg, params, dev)
    result["decode_step"] = decode_step_times(engine, result["mean_decode_step_ms"])
    result["lockstep"] = lockstep(engine, SERVE_MAX_SEQ[name] - 4)
    result["checks"] = checks
    del params, engine
    torch.cuda.empty_cache()
    return result


def log_times(times: dict) -> None:
    for name, t in times.items():
        lib = t["library"]
        log(f"time {name} [{t['shape']}] card ms (per call with host ms): kernel "
            f"{t['kernel']['ms']:.5f} ({t['kernel']['call_ms']:.5f}), plain "
            f"{t['plain']['ms']:.5f} ({t['plain']['call_ms']:.5f}), torch "
            + (f"{lib['ms']:.5f} ({lib['call_ms']:.5f})" if lib else "none")
            + f", bound {t['bound'][0]:.5f} ({t['bound'][1]})"
            + (f"; plan {t['plan']}" if "plan" in t else "")
            + (f"; state read and written in place by mul_ {t['state_floor_ms']:.5f}"
               if "state_floor_ms" in t else ""))
        for label in ("prefill", "prefill_2048"):
            if label in t:
                pre = t[label]
                log(f"time {name} {label} [{pre['shape']}] card ms: kernel {pre['ms']:.5f}, "
                    f"bound {pre['bound'][0]:.5f} ({pre['bound'][1]}); plan {pre['plan']}")
        for label, plans in t.get("plans", {}).items():
            log(f"time {name} {label} by plan, card ms: " + "; ".join(
                f"{x['ms']:.5f} ({x['plan']})" for x in plans.values()))
        for label, x in t.get("extra", {}).items():
            log(f"time {name} {label} [{x['shape']}] card ms: kernel {x['ms']:.5f}, torch "
                f"{x['library_ms']:.5f}, bound {x['bound'][0]:.5f} ({x['bound'][1]}), "
                f"{x['bound'][0] / x['ms']:.1%} of the bound")
        if "launch" in t:
            log(f"time {name} launch floor and marginal card ms (100-call graphs): "
                + json.dumps(t["launch"]))


# --------------------------------------------------------------------------- #
# the what-if replay
# --------------------------------------------------------------------------- #
def grid_10k():
    """The reference benchmark's 10^4-config grid (benchmarks/whatif_bench.py
    ``_grid_10k``), built from the port's classes: 1 no-op + 2048 Algorithm-1
    downscale (32 X x 32 Y x 2 modes) + 50 consolidation pools + 7901 caps."""
    import numpy as np
    from repro_torch.core.controller import ControllerConfig, DownscaleMode
    from repro_torch.core.imbalance import PoolConfig, PoolPolicy
    from repro_torch.whatif import (DownscalePolicy, NoOpPolicy, ParkingPolicy,
                                    PowerCapPolicy)
    grid = [NoOpPolicy()]
    for x in np.linspace(0.5, 16.0, 32):
        for y in np.linspace(1.0, 12.0, 32):
            for mode in (DownscaleMode.SM_ONLY, DownscaleMode.SM_AND_MEM):
                grid.append(DownscalePolicy(config=ControllerConfig(
                    threshold_x_s=round(float(x), 4),
                    cooldown_y_s=round(float(y), 4), mode=mode)))
    for n_devices in (4, 8):
        for k in range(1, n_devices):
            for resume_s in (2.0, 5.0, 10.0, 30.0, 60.0):
                grid.append(ParkingPolicy(
                    pool=PoolConfig(n_devices=n_devices,
                                    policy=PoolPolicy.CONSOLIDATED, n_active=k),
                    resume_latency_s=resume_s))
    for frac in np.linspace(0.2, 0.99, 10_000 - len(grid)):
        grid.append(PowerCapPolicy(cap_fraction=round(float(frac), 6)))
    return grid


def sample_indices(grid, n: int, seed: int = 0) -> list[int]:
    """A seeded sample of ``n`` configs that holds every family: the no-op,
    every parking pool, and the rest drawn from downscale and caps."""
    import numpy as np
    names = [p.name for p in grid]
    keep = [i for i, nm in enumerate(names) if nm in ("noop", "parking")]
    rest = np.array([i for i, nm in enumerate(names) if nm not in ("noop", "parking")])
    drawn = np.random.default_rng(seed).choice(rest, n - len(keep), replace=False)
    return sorted(keep + [int(i) for i in drawn])


WHATIF_EXACT = ("name", "params", "n_jobs", "wake_events", "downscale_events",
                "throttled_time_s")
WHATIF_FLOAT = ("baseline_energy_j", "counterfactual_energy_j", "energy_saved_j",
                "saved_fraction", "penalty_s", "penalty_fraction",
                "exec_idle_energy_fraction_baseline", "exec_idle_energy_fraction_cf")


def compare_outcomes(ref, out, label: str) -> dict:
    """The oracle contract of tests/test_whatif_backend.py: time and count
    fields equal, float fields and per-job CDFs within 1e-9 (rtol = atol =
    1e-9, as ``np.isclose``). Returns, per float field, the worst relative
    error, and under "limit_share" the worst element's share of its
    ``np.isclose`` limit (the atol part covers fields near zero, such as a
    saving that is a small difference of two large energies)."""
    import numpy as np
    if len(ref) != len(out):
        raise AssertionError(f"{label}: {len(out)} outcomes, want {len(ref)}")
    fields = WHATIF_FLOAT + ("per_job_saved_fraction", "per_job_penalty_s")
    worst = dict.fromkeys(fields + ("limit_share",), 0.0)
    for a, b in zip(ref, out):
        for f in WHATIF_EXACT:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{label}: {a.name} {a.params} {f}: "
                                     f"{getattr(b, f)} != oracle {getattr(a, f)}")
        for f in fields:
            x = np.atleast_1d(np.asarray(getattr(a, f), dtype=np.float64))
            y = np.atleast_1d(np.asarray(getattr(b, f), dtype=np.float64))
            if x.shape != y.shape:
                raise AssertionError(f"{label}: {a.name} {a.params} {f}: shape")
            diff = np.abs(y - x)
            share = diff / (WHATIF_RTOL + WHATIF_RTOL * np.abs(x))
            if not (share <= 1.0).all():
                raise AssertionError(f"{label}: {a.name} {a.params} {f}: differs "
                                     f"from the oracle beyond rtol = atol = 1e-9")
            worst["limit_share"] = max(worst["limit_share"], float(share.max(initial=0.0)))
            nz = diff > 0
            if nz.any():
                worst[f] = max(worst[f], float((diff[nz] / np.abs(x[nz])).max()))
    return worst



def compare_frontier(ref, out, label: str) -> dict:
    """Two frontiers under the oracle contract: counts and coverage exact,
    the same configs in the same order (trace and Pareto flags), and every
    outcome as :func:`compare_outcomes` holds it. Returns its worst."""
    if (out.n_rows, out.n_jobs, out.n_runs, out.coverage) != \
            (ref.n_rows, ref.n_jobs, ref.n_runs, ref.coverage):
        raise AssertionError(f"{label}: counts {(out.n_rows, out.n_jobs, out.n_runs, out.coverage)}"
                             f", oracle {(ref.n_rows, ref.n_jobs, ref.n_runs, ref.coverage)}")
    worst = compare_outcomes(ref.outcomes, out.outcomes, label)
    if [o.pareto for o in out.outcomes] != [o.pareto for o in ref.outcomes]:
        raise AssertionError(f"{label}: Pareto flags differ from the oracle's")
    if [(t["i"], t["round"], t["family"]) for t in out.trace] != \
            [(t["i"], t["round"], t["family"]) for t in ref.trace]:
        raise AssertionError(f"{label}: the trace differs from the oracle's")
    return worst

def cap_scan_plans(n: int, c: int, rows: int) -> dict:
    """Every plan K4 may take for these shapes, by label: the plan's own
    choice, and each number of tiles a row it weighs at each number of caps
    a thread for the row branch (where the row fits) and at the plan's
    number for the tree branch."""
    from repro_torch.kernels import run_replay as k4
    plans = {"plan": k4.launch_plan(n, c, rows)}
    for branch, choices in (("row", k4.CAPS), ("tree", (None,))):
        for caps in choices:
            for t in k4.TILES:
                try:
                    plan = k4.launch_plan(n, c, rows, t, branch, caps)
                except ValueError:          # a row too wide for the row branch
                    continue
                plans[f"{branch} {plan.caps} x{t}"] = plan
    return plans


def check_cap_scan(name: str, sp, caps, plans=(), yardstick: bool = True):
    """K4 on (``sp``, ``caps``) exactly equal to its plain version under its
    own plan and every plan in ``plans``, two calls the same bits, and,
    where ``yardstick`` (rows without NaN), equal to ``torch.searchsorted``
    wherever the cap is not NaN (a NaN cap counts Np, as in the Pallas
    kernel). Returns the counts."""
    import torch
    from repro_torch.kernels import run_replay as k4
    got, want = k4.cap_bucket_scan(sp, caps), k4.cap_bucket_scan_plain(sp, caps)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain")
    if not torch.equal(got, k4.cap_bucket_scan(sp, caps)):
        raise AssertionError(f"{name}: two calls differ")
    for plan in plans:
        if not torch.equal(k4.cap_bucket_scan(sp, caps, plan), want):
            raise AssertionError(f"{name}: kernel != plain under {plan}")
    if yardstick:
        n, c = sp.shape[-1], caps.shape[-1]
        flat = caps.reshape(-1, c)
        yard = n - torch.searchsorted(sp.reshape(-1, n), flat.contiguous(), right=True)
        if not (torch.isnan(flat) | (yard == got.reshape(-1, c))).all():
            raise AssertionError(f"{name}: kernel != torch.searchsorted")
    return got


def cap_scan_edge_cases(dev) -> None:
    """K4 against its plain version, under every plan (:func:`cap_scan_plans`),
    and against ``torch.searchsorted``, on ties and -inf padded rows: Np = 1,
    Np not a power of two, NaN, +inf and -inf caps, rows all padding, a
    finite tail of 1, an odd padding count (the staged part starts off the
    16-byte grid), the widest row the row branch takes, widths past it
    (2^15 and 40,000), C = 1, C no multiple of a tile, caps as a stride-0
    expand and as a transposed view, and rows ending in +inf and NaN (as
    ``torch.sort`` orders them)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)

    def inputs(rows, n, c, pad, special=False):
        sp = np.sort(rng.integers(-40, 40, (rows, n)).astype(np.float64) * 2.5, axis=1)
        sp[:, :pad] = -np.inf
        caps = rng.integers(-45, 45, (rows, c)).astype(np.float64) * 2.5
        if special:
            caps[:, 0::4], caps[:, 1::4], caps[:, 2::4] = np.nan, np.inf, -np.inf
        return torch.from_numpy(sp).to(dev), torch.from_numpy(caps).to(dev)

    for rows, n, c, pad, special in (
            (1, 1, 7, 0, False), (3, 17, 5, 4, False), (4, 1000, 33, 40, False),
            (2, 6, 5, 0, False), (3, 17, 13, 0, True), (2, 64, 9, 64, True),
            (2, 33, 8, 32, True), (4, 4096, 300, 1001, True), (3, 8191, 1000, 2, False),
            (2, 29055, 300, 7, True), (2, 1 << 15, 513, 20001, True),
            (3, 40000, 257, 12345, True), (5, 8192, 1, 5000, False),
            (6, 4096, 1000, 3, False)):
        sp, caps = inputs(rows, n, c, pad, special)
        got = check_cap_scan(f"cap_bucket_scan rows={rows} n={n} c={c} pad={pad}", sp, caps,
                             cap_scan_plans(n, c, rows).values())
        if special and not (got[:, 0::4] == n).all():
            raise AssertionError(f"cap_bucket_scan n={n}: a NaN cap did not count Np")
    sp, caps = inputs(12, 2048, 301, 999)
    grouped = sp.reshape(3, 4, 2048)
    table = caps[:3]
    check_cap_scan("cap_bucket_scan caps expanded over 4 buckets", grouped,
                   table[:, None, :].expand(3, 4, 301), cap_scan_plans(2048, 301, 12).values())
    check_cap_scan("cap_bucket_scan transposed caps", sp, caps.t().contiguous().t(),
                   cap_scan_plans(2048, 301, 12).values())
    ends = sp.clone()                                   # as torch.sort leaves them
    ends[:, 1800:], ends[:, 1900:] = float("inf"), float("nan")
    check_cap_scan("cap_bucket_scan +inf and NaN samples last", ends, caps,
                   cap_scan_plans(2048, 301, 12).values(), yardstick=False)
    torch.cuda.synchronize()


def cap_bounds(sp, caps_table, n_out: int) -> dict:
    """K4's bounds: the rows as stored, and only their real samples, which
    is all a kernel that skips the padding must read; each with every
    distinct cap (``caps_table``) read and every count written once.
    Operations: ~5 a probe, bit_length(Np) probes a count, at the float32
    rate."""
    n_p = sp.shape[-1]
    ops = n_out * max(n_p.bit_length(), 1) * 5
    rest = caps_table.numel() * 8 + n_out * 4
    real = int((sp != float("-inf")).sum())
    return {"stored": bound_ms(sp.numel() * 8 + rest, ops, F32_OPS_PER_S),
            "stored_bytes": sp.numel() * 8 + rest,
            "real": bound_ms(real * 8 + rest, ops, F32_OPS_PER_S),
            "real_bytes": real * 8 + rest, "real_samples": real}


def after_read_ms(fn, flush, pattern: str, iters: int = 20) -> float:
    """Card ms a launch of the kernels matching ``pattern`` that ``fn``
    runs, each call after a read of ``flush`` (past the L2, so ``fn``'s
    inputs come from HBM, as in ``evaluate``): profiled over ``iters``
    calls after as many under the profiler's warm-up step, the mean over
    the launches the profile kept (it can drop a record or two)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    steps = []
    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: steps.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(iters):
                flush.sum()
                fn()
            torch.cuda.synchronize()
            prof.step()
    hits = [e for e in steps[0] if e.device_type == DeviceType.CUDA
            and re.search(pattern, e.key)]
    n = sum(e.count for e in hits)
    if not iters // 2 < n <= iters:
        raise AssertionError(f"after_read_ms: {n} launches matching {pattern!r} in the "
                             f"profile of {iters} calls")
    return sum(e.self_device_time_total for e in hits) / 1e3 / n


#: bytes read between launches to leave the L2 (50 MB on an H100) cold
FLUSH_BYTES = 128 << 20


def cap_buckets(dev, packed, fracs, alternatives: bool = True) -> list[dict]:
    """K4 at every padding bucket of the 10^4 run, as the power-cap family
    calls it ([S, 4, Np] rows, the grid's C caps a stream expanded over its
    4 buckets): checked by :func:`check_cap_scan` (under every plan where
    ``alternatives``), then its card time back to back (20 calls in a
    graph; all seven buckets' rows fit in the L2) under its plan and, where
    ``alternatives``, every other, and after an L2-sized read (profiled);
    its time on the first cap alone under the bucket's plan (the launch,
    the padding probe and the staging of every row with the same blocks,
    one search a row: the blocks' set-up; without ``alternatives``, under
    the plan for C = 1); ``torch.searchsorted``'s in both settings; both
    bounds (:func:`cap_bounds`). Without ``alternatives`` it calls only the
    wrapper's two-argument form, which earlier commits share."""
    import numpy as np
    import torch
    from repro_torch.kernels import run_replay as k4
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = []
    for b in packed.buckets:
        sp = b.device_tensors(dev)["cap_sorted"]
        s_dim, n_b, n_p = sp.shape
        table = torch.from_numpy(np.asarray(fracs)[None, :] * packed.tdp[b.idx][:, None]).to(dev)
        c = table.shape[1]
        view = table[:, None, :].expand(s_dim, n_b, c)
        name = f"cap_bucket_scan bucket ({s_dim}, {n_b}, {n_p})"
        plans = cap_scan_plans(n_p, c, s_dim * n_b) if alternatives else {}
        got = check_cap_scan(name, sp, view, plans.values())
        flat_sp, flat_caps = sp.reshape(-1, n_p), view.reshape(-1, c)    # materialised
        first = view[..., :1]
        one_cap = ((lambda: k4.cap_bucket_scan(sp, first, plans["plan"])) if alternatives
                   else (lambda: k4.cap_bucket_scan(sp, first)))
        row = dict(streams=s_dim, n=n_p, caps=c,
                   ms=graph_ms(lambda: k4.cap_bucket_scan(sp, view), 20),
                   one_cap_ms=graph_ms(one_cap, 20),
                   ms_by_plan={k: graph_ms(lambda p=p: k4.cap_bucket_scan(sp, view, p), 20)
                               for k, p in plans.items()},
                   library_ms=graph_ms(lambda: torch.searchsorted(
                       flat_sp, flat_caps, right=True), 20),
                   cold_ms=after_read_ms(lambda: k4.cap_bucket_scan(sp, view), flush,
                                         r"cap_bucket_scan_kernel"),
                   cold_library_ms=after_read_ms(lambda: torch.searchsorted(
                       flat_sp, flat_caps, right=True), flush, r"searchsorted"),
                   **cap_bounds(sp, table, got.numel()))
        if alternatives:
            row["plan"] = str(plans["plan"])
        out.append(row)
        log(f"time {name}, {c} caps, {row['real_samples']} real samples: card ms "
            f"{row['ms']:.5f} back to back, {row['cold_ms']:.5f} after a "
            f"{FLUSH_BYTES >> 20} MB read, {row['one_cap_ms']:.5f} on one cap; "
            f"torch.searchsorted {row['library_ms']:.5f} / "
            f"{row['cold_library_ms']:.5f}; bound {row['stored'][0]:.5f} as stored "
            f"({row['stored_bytes']} bytes), {row['real'][0]:.5f} real samples only "
            f"({row['real_bytes']} bytes), {row['real'][0] / row['ms']:.1%} of the "
            f"second" + (f"; {row['plan']}; by plan: " + ", ".join(
                f"{k} {v:.5f}" for k, v in row["ms_by_plan"].items()) if alternatives else ""))
    tot = {k: sum(r[k] for r in out)
           for k in ("ms", "cold_ms", "one_cap_ms", "library_ms", "cold_library_ms")}
    log(f"time cap_bucket_scan, all {len(out)} buckets, card ms for one launch each: "
        f"{tot['ms']:.5f} back to back, {tot['cold_ms']:.5f} after a read, "
        f"{tot['one_cap_ms']:.5f} on one cap; "
        f"torch.searchsorted {tot['library_ms']:.5f} / {tot['cold_library_ms']:.5f}; bound "
        f"{sum(r['stored'][0] for r in out):.5f} as stored, "
        f"{sum(r['real'][0] for r in out):.5f} real samples only")
    if alternatives:
        log("time cap_bucket_scan, all buckets by plan: " + ", ".join(
            f"{k} {sum(r['ms_by_plan'][k] for r in out):.5f}"
            for k in out[0]["ms_by_plan"] if all(k in r["ms_by_plan"] for r in out)))
    return out


def pareto_flags_pairwise(saved, penalty) -> list[bool]:
    """The O(n^2) Pareto flags the port's ``pareto_flags`` replaced (the
    JAX package's loop, which the port copied first): the yardstick of its
    time and of its flags."""
    flags = []
    for i, (s_i, p_i) in enumerate(zip(saved, penalty)):
        dominated = any(
            (s_j >= s_i and p_j <= p_i) and (s_j > s_i or p_j < p_i)
            for j, (s_j, p_j) in enumerate(zip(saved, penalty)) if j != i)
        flags.append(not dominated)
    return flags


def pareto_times(outcomes) -> dict:
    """``pareto_flags`` against the pairwise loop on the 10^4 grid's
    outcomes: the same flags, each one's host time."""
    from repro_torch.whatif import pareto_flags

    saved = [o.energy_saved_j for o in outcomes]
    penalty = [o.penalty_s for o in outcomes]
    t0 = time.perf_counter()
    new = pareto_flags(saved, penalty)
    new_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    old = pareto_flags_pairwise(saved, penalty)
    old_s = time.perf_counter() - t0
    if new != old:
        raise AssertionError("10^4 grid: pareto_flags differs from the pairwise loop")
    result = {"points": len(saved), "pareto": sum(new), "sort_s": new_s, "pairwise_s": old_s}
    log(f"what-if pareto_flags on the 10^4 grid ({len(saved)} points, {sum(new)} on the "
        f"front): O(n log n) {new_s * 1e3:.3f} ms, the pairwise loop {old_s * 1e3:.1f} ms, "
        f"the same flags (host time)")
    return result


#: the search's budgets on the card: every default family, the operator's
#: budget of 1% of the recorded active time
SEARCH_EVALS = 100
SEARCH_BUDGET_FRACTION = 0.01


def search(dev, store, kw) -> dict:
    """The closed-loop search (``search_frontier``, default families,
    ``SEARCH_EVALS`` evaluations, a penalty budget of 1% of active time) on
    the card, held against the same search on the NumPy oracle: the same
    configs in the same order, rounds, trace, knee and budget answer;
    counts exact, floats within 1e-9. Times the search and each round, and
    counts K4's and K7's launches in each round."""
    import torch
    from repro_torch import kernels
    from repro_torch.whatif import PenaltyBudget, search_frontier
    from repro_torch.whatif import search as search_mod

    rounds: list[dict] = []
    evaluate_outcomes = search_mod._evaluate_outcomes

    def counted(configs, *args, **kwargs):
        """One round's evaluate, timed to its end on the card, with the
        kernels it launched."""
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out = evaluate_outcomes(configs, *args, **kwargs)
        if kwargs.get("backend") == "torch":
            torch.cuda.synchronize(dev)
        after = kernels.launch_counts()
        rounds.append({"configs": len(configs), "s": time.perf_counter() - t0,
                       **{k: after[k] - before[k] for k in ("cap_bucket_scan",
                                                            "downscale_replay")}})
        return out

    budget = PenaltyBudget(max_penalty_fraction=SEARCH_BUDGET_FRACTION)
    runs = {}
    search_mod._evaluate_outcomes = counted
    try:
        for backend in ("torch", "numpy"):
            rounds.clear()
            torch.cuda.synchronize(dev)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = search_frontier(store, budget=budget, max_evals=SEARCH_EVALS,
                                  backend=backend, **kw)
            torch.cuda.synchronize(dev)
            runs[backend] = (res, time.perf_counter() - t0, list(rounds),
                             kernels.launch_counts())
    finally:
        search_mod._evaluate_outcomes = evaluate_outcomes
    (res, search_s, card_rounds, launches), (ref, oracle_s, _, host_launches) = \
        runs["torch"], runs["numpy"]
    if launches["cap_bucket_scan"] <= 0 or launches["downscale_replay"] <= 0 \
            or any(launches[k] for k in SERVING_KERNELS) or any(host_launches.values()):
        raise AssertionError(f"search launches: card {launches}, oracle {host_launches}")
    worst = compare_frontier(ref.frontier, res.frontier, "search")
    if (res.n_evals, res.n_rounds, res.converged) != (ref.n_evals, ref.n_rounds, ref.converged):
        raise AssertionError(f"search: {res.n_evals} evals / {res.n_rounds} rounds, oracle "
                             f"{ref.n_evals} / {ref.n_rounds}")
    if [h.knee_params for h in res.history] != [h.knee_params for h in ref.history]:
        raise AssertionError("search: the knee moved differently from the oracle's")
    if res.knee.params != ref.knee.params or res.best is None or ref.best is None \
            or res.best.params != ref.best.params:
        raise AssertionError(f"search: knee {res.knee.params} / best "
                             f"{res.best and res.best.params}, oracle {ref.knee.params} / "
                             f"{ref.best and ref.best.params}")
    if any(r["cap_bucket_scan"] <= 0 or r["downscale_replay"] <= 0 for r in card_rounds):
        raise AssertionError(f"search: a round launched no K4 or K7: {card_rounds}")
    result = {
        "max_evals": SEARCH_EVALS, "budget_penalty_fraction": SEARCH_BUDGET_FRACTION,
        "n_evals": res.n_evals, "n_rounds": res.n_rounds, "converged": res.converged,
        "search_s": search_s, "oracle_search_s": oracle_s, "rounds": card_rounds,
        "knee": res.knee.params, "knee_saved_fraction": res.knee.saved_fraction,
        "knee_penalty_fraction": res.knee.penalty_fraction,
        "best": res.best.params, "best_saved_fraction": res.best.saved_fraction,
        "best_penalty_fraction": res.best.penalty_fraction,
        "worst_limit_share": worst["limit_share"], "launches": launches,
    }
    log("what-if search " + json.dumps(result))
    log(f"what-if search_frontier on the card ({res.n_evals} configs in {res.n_rounds} "
        f"rounds, budget {SEARCH_BUDGET_FRACTION:.0%} of active time): {search_s:.3f} s, "
        f"rounds " + ", ".join(f"{r['configs']} configs {r['s']:.3f} s (K4 "
                               f"{r['cap_bucket_scan']}, K7 {r['downscale_replay']} "
                               f"launches)" for r in card_rounds)
        + f"; == the numpy oracle's search ({oracle_s:.3f} s on the host): same configs "
        f"in the same order, trace, knee and budget answer, counts exact, floats within "
        f"{WHATIF_RTOL} (worst {worst['limit_share']:.3f} of the limit); card "
        f"{nvidia_smi_line()}")
    return result


def profile_evaluate(grid, store, kw) -> dict:
    """One 10^4-config ``evaluate`` under torch.profiler, after one under its
    warm-up step (late in this process, a profile's first device records
    can be lost, and the cooldown chain's launches come first): the card's
    busy time against the wall time, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.whatif import evaluate

    torch.cuda.synchronize()
    steps = []                        # the active step's events, as the profiler hands them over
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: steps.append(p.key_averages())) as prof:
        evaluate(grid, store, **kw)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        evaluate(grid, store, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    on_card = [e for e in steps[0] if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]    # the step's own range
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    ours: dict[str, float] = {}
    launches: dict[str, int] = {}
    for e in on_card:                 # the port's kernels, by name
        m = re.search(r"repro::(\w+)", e.key)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + e.self_device_time_total / 1e3
            launches[m.group(1)] = launches.get(m.group(1), 0) + e.count
    result = {"wall_ms_profiled": wall_ms, "card_busy_ms": busy_ms,
              "repro_kernel_launches": launches,
              "card_idle_share": 1.0 - busy_ms / wall_ms,
              "device_ops": sum(e.count for e in on_card),
              "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
              "repro_kernels_ms": ours}
    log("profile what-if evaluate " + json.dumps(result))
    return result


def replay_kernels(dev, grid, packed) -> dict:
    """K4 and K7 at the largest padding bucket of the 10^4 run (the most
    streams x padded low runs): kernel against plain, then times."""
    import numpy as np
    import torch
    from repro_torch.kernels import downscale_replay as k7
    from repro_torch.kernels import run_replay as k4
    from repro_torch.whatif.policies import DownscaleBatch, PowerCapBatch, make_batches

    bucket = max(packed.buckets, key=lambda b: b.key[0] * b.idx.size)
    a = bucket.device_tensors(dev)
    s_dim = bucket.idx.size
    batches = [b for b, _ in make_batches(grid)]
    cap_batch = next(b for b in batches if isinstance(b, PowerCapBatch))
    ds_batch = next(b for b in batches if isinstance(b, DownscaleBatch))

    # K4, as the power-cap family calls it: [S, 4, Np] rows, [S, C] caps
    # expanded over the 4 buckets
    caps = torch.from_numpy(np.asarray(cap_batch._fracs)[None, :]
                            * packed.tdp[bucket.idx][:, None]).to(dev)
    sp = a["cap_sorted"]
    n_b, n_p = sp.shape[1], sp.shape[2]
    c4 = caps.shape[1]
    view = caps[:, None, :].expand(s_dim, n_b, c4)
    got = check_cap_scan("cap_bucket_scan at the main shape", sp, view)
    k4_err = float((got - k4.cap_bucket_scan_plain(sp, view)).abs().max())
    cap_scan_edge_cases(dev)
    rows = sp.reshape(s_dim * n_b, n_p)
    caps_rows = view.reshape(s_dim * n_b, c4)           # materialised for searchsorted
    bounds = cap_bounds(sp, caps, got.numel())
    k4_row = dict(
        shape=f"sorted_p ({s_dim}, 4, {n_p}) f64, caps ({s_dim}, {c4}) f64 "
              f"expanded over 4 buckets",
        kernel=timed(lambda: k4.cap_bucket_scan(sp, view)),
        plain=timed(lambda: k4.cap_bucket_scan_plain(sp, view), 20),
        library=timed(lambda: torch.searchsorted(rows, caps_rows, right=True)),
        bound=bounds["real"], bound_stored=bounds["stored"],
        plan=str(k4.launch_plan(n_p, c4, s_dim * n_b)),
        max_abs_err=k4_err,
        buckets=cap_buckets(dev, packed, cap_batch._fracs))

    # K7, as the downscale family calls it: the unique (trigger, cooldown) pairs
    key = np.stack([ds_batch._trig.astype(np.float64), ds_batch._y], axis=1)
    _, uniq = np.unique(key, axis=0, return_index=True)
    trig = torch.from_numpy(ds_batch._trig[uniq].astype(np.int64)).to(dev)
    y = torch.from_numpy(ds_batch._y[uniq].astype(np.float64)).to(dev)
    args = (a["lr_s0"], a["lr_len"], a["lr_busy"], a["lr_valid"], a["lr_trail"],
            a["cum_res"], a["ds_cum"], a["ts_first"], packed.dt_s, trig, y)
    got = k7.downscale_replay(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    want = k7.downscale_replay_plain(*args)
    torch.cuda.synchronize()
    plain_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    for i, (g, w) in enumerate(zip(got[:3], want[:3])):
        if not torch.equal(g, w):
            raise AssertionError(f"downscale_replay: integer output {i} kernel != plain")
    k7_err = 0.0
    for g, w in zip(got[3:], want[3:]):
        k7_err = max(k7_err, check_close("downscale_replay savings", g, w, WHATIF_RTOL))
    c7 = trig.numel()
    k_dim = a["lr_s0"].shape[1]
    valid_runs = int(a["lr_valid"].sum())
    fired = int(got[0].sum())
    bound, n_bytes = chain_bound(args)
    k7_row = dict(
        shape=f"lr_* ({s_dim}, {k_dim}), ds_cum ({s_dim}, 4, {a['ds_cum'].shape[2]}) "
              f"f64, {c7} (trigger, cooldown) pairs",
        kernel=timed(lambda: k7.downscale_replay(*args), 20),
        plain=timed(lambda: k7.downscale_replay_plain(*args), 2),
        library=None,
        bound=bound, bound_bytes=n_bytes,
        max_abs_err=k7_err, plain_peak_gib=plain_gib, fired=fired,
        valid_runs=valid_runs, pairs=c7,
        buckets=chain_buckets(dev, packed, trig, y))
    chain_edge_cases(dev)
    return {"cap_bucket_scan": k4_row, "downscale_replay": k7_row}


def check_chain(name: str, args) -> tuple:
    """K7 on ``args`` against its plain version: the integer outputs equal,
    the savings within 1e-9 (rtol = atol), two calls the same bits, and the
    same at every lanes-per-pair choice. Returns the default call's
    outputs."""
    import torch
    from repro_torch.kernels import downscale_replay as k7
    got, want = k7.downscale_replay(*args), k7.downscale_replay_plain(*args)
    tensors = dict(zip([n for n, _, _ in k7._INPUTS], args[:8] + args[9:]))
    plans = [k7.launch(tensors, args[8], k7.replay_plan(args[0].shape[1], args[9].numel(), n))
             for n in k7.LANES]
    for out in [got, *plans]:
        for i, (g, w) in enumerate(zip(out, want)):
            if i < 3 and not torch.equal(g, w):
                raise AssertionError(f"{name}: integer output {i} kernel != plain")
            if i >= 3:
                check_close(f"{name} savings", g, w, WHATIF_RTOL)
    if not all(torch.equal(g, h) for g, h in zip(got, k7.downscale_replay(*args))):
        raise AssertionError(f"{name}: two calls differ")
    return got


def chain_bound(args) -> tuple[tuple[float, str], int]:
    """K7's bound on ``args`` and the bytes it counts. Bytes: the run
    tables, ``ts_first``, the pairs and the seven ``[S, C]`` results, each
    moved once, and of the prefix tables only the 32-byte sectors that hold
    a fired run's end row or trigger row, in ``cum_res`` and in each of
    ``ds_cum``'s four planes (the rows this run's fires need, from the plain
    version's decisions). Operations: a compare per (valid run, pair) and
    some 40 per fire, at the float32 rate."""
    import torch
    from repro_torch.kernels import downscale_replay as k7
    lr_s0, lr_len, lr_busy, lr_valid, lr_trail, cum_res, ds_cum, ts_first, dt, trig, y = args
    s_dim, n1, c_dim = lr_s0.shape[0], cum_res.shape[1], trig.numel()
    fire, gpos = k7.chain_rows(lr_s0, lr_len, lr_busy, lr_valid, ts_first, dt, trig, y)
    k, s, _ = fire.nonzero(as_tuple=True)
    rows = torch.cat([s * n1 + (lr_s0 + lr_len)[s, k], s * n1 + gpos[fire]]).unique()
    s_of, r_of = rows // n1, rows % n1
    addr = [cum_res.data_ptr() + rows * 8]
    addr += [ds_cum.data_ptr() + ((s_of * 4 + p) * n1 + r_of) * 8 for p in range(4)]
    sectors = (torch.cat(addr) // 32).unique().numel()
    small = (lr_s0, lr_len, lr_busy, lr_valid, lr_trail, ts_first, trig, y)
    n_bytes = (sum(t.numel() * t.element_size() for t in small) + 32 * sectors
               + 7 * s_dim * c_dim * 8)
    ops = 3 * int(lr_valid.sum()) * c_dim + 40 * int(fire.sum())
    return bound_ms(n_bytes, ops, F32_OPS_PER_S), n_bytes


def chain_buckets(dev, packed, trig, y) -> list[dict]:
    """K7 at every padding bucket of the 10^4 run: checked by
    :func:`check_chain`, then its card time (20 calls in a graph) at each
    lanes-per-pair choice beside its bound (:func:`chain_bound`)."""
    from repro_torch.kernels import downscale_replay as k7
    rows = []
    for b in packed.buckets:
        a = b.device_tensors(dev)
        args = (a["lr_s0"], a["lr_len"], a["lr_busy"], a["lr_valid"], a["lr_trail"],
                a["cum_res"], a["ds_cum"], a["ts_first"], packed.dt_s, trig, y)
        s_dim, k_dim = a["lr_s0"].shape
        c7 = trig.numel()
        got = check_chain(f"downscale_replay bucket K={k_dim}", args)
        tensors = dict(zip([n for n, _, _ in k7._INPUTS], args[:8] + args[9:]))
        ms = {n: graph_ms(lambda n=n: k7.launch(tensors, packed.dt_s,
                                                k7.replay_plan(k_dim, c7, n)), 20)
              for n in k7.LANES}
        plan = k7.replay_plan(k_dim, c7)
        fired, valid = int(got[0].sum()), int(a["lr_valid"].sum())
        bound, n_bytes = chain_bound(args)
        rows.append(dict(streams=s_dim, k=k_dim, n1=a["cum_res"].shape[1], pairs=c7,
                         valid_runs=valid, fired=fired, lanes=plan.lanes, ms=ms[plan.lanes],
                         ms_by_lanes=ms, bound_ms=bound[0], bound_by=bound[1],
                         bound_bytes=n_bytes))
        log(f"time downscale_replay bucket (S {s_dim}, K {k_dim}, N1 {rows[-1]['n1']}), "
            f"{c7} pairs, {valid} valid runs, {fired} fires: card ms {ms[plan.lanes]:.5f} "
            f"at {plan.lanes} lanes a pair (8 / 32: {ms[8]:.5f} / {ms[32]:.5f}), bound "
            f"{bound[0]:.5f} ({bound[1]}; {n_bytes} bytes), "
            f"{bound[0] / ms[plan.lanes]:.1%} of the bound")
    total, bound = sum(r["ms"] for r in rows), sum(r["bound_ms"] for r in rows)
    log(f"time downscale_replay, all {len(rows)} buckets: card ms {total:.5f} for one launch "
        f"each, bound {bound:.5f} ({sum(r['bound_bytes'] for r in rows)} bytes), "
        f"{bound / total:.1%} of the bound")
    return rows


def synthetic_bucket(seed: int, s_dim: int, k_dim: int, n_max: int | None = None,
                     dt: float = 0.25) -> dict:
    """A packed bucket of ``s_dim`` streams with 1 to ``n_max`` (default K)
    low runs each out of ``k_dim``, the rest padding, as NumPy arrays keyed
    by the kernel's argument names: runs of 1-20 rows with gaps of 1-10,
    each run's busy time the timestamp of the row after it, one trailing
    flag drawn per stream, random resident-sample and saving prefix tables
    of ``31 * K + 2`` entries. Seconds per row: ``dt``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n1 = 31 * k_dim + 2
    s0 = np.zeros((s_dim, k_dim), np.int64)
    ln = np.zeros((s_dim, k_dim), np.int64)
    valid = np.zeros((s_dim, k_dim), bool)
    trail = np.zeros((s_dim, k_dim), bool)
    tsf = rng.uniform(0.0, 1000.0, s_dim)
    for i in range(s_dim):
        n = int(rng.integers(1, (n_max or k_dim) + 1))
        lens = rng.integers(1, 21, n)
        s0[i, :n] = np.cumsum(rng.integers(1, 11, n) + np.r_[0, lens[:-1]])
        ln[i, :n], valid[i, :n], trail[i, n - 1] = lens, True, bool(rng.integers(0, 2))
    res = np.concatenate([np.zeros((s_dim, 1), np.int64),
                          np.cumsum(rng.integers(0, 2, (s_dim, n1 - 1)), 1)], 1)
    ds = np.cumsum(rng.uniform(0.0, 300.0, (s_dim, 4, n1)), 2)
    return dict(lr_s0=s0, lr_len=ln, lr_busy=tsf[:, None] + dt * (s0 + ln), lr_valid=valid,
                lr_trail=trail, cum_res=res, ds_cum=ds, ts_first=tsf)


def chain_edge_cases(dev) -> None:
    """K7 on :func:`synthetic_bucket`s: K past one staged chunk (1,300
    runs), S = 1, every run padding but one; 25 pairs (no multiple of a
    tile) holding trigger 0 at cooldown 0, which fires on every valid run,
    and trigger 1 << 62, which never fires."""
    import torch
    pairs = [(t, yy) for t in (0, 1, 3, 8, 1 << 62) for yy in (0.0, 0.5, 2.0, 7.5, 30.0)]
    trig = torch.tensor([p[0] for p in pairs], dtype=torch.int64, device=dev)
    y = torch.tensor([p[1] for p in pairs], dtype=torch.float64, device=dev)
    dt = 0.25
    for seed, s_dim, k_dim, n_max in ((1, 3, 1300, 1300), (2, 1, 40, 40), (3, 4, 64, 1)):
        a = synthetic_bucket(seed, s_dim, k_dim, n_max, dt)
        t = [torch.from_numpy(v).to(dev) for v in a.values()]
        got = check_chain(f"downscale_replay S={s_dim} K={k_dim}", (*t, dt, trig, y))
        if not torch.equal(got[0][:, 0], t[3].sum(1)) or got[0][:, -5:].any():
            raise AssertionError(f"downscale_replay S={s_dim} K={k_dim}: trigger 0 does not "
                                 "fire on every run, or 1 << 62 fires")
    torch.cuda.synchronize()


def whatif(dev) -> dict:
    """The what-if main path: the reference benchmark's fleet into a store,
    the dense and 10^4 grids replayed on the card through ``run_sweep``, the
    oracle checks, the counted run and the kernel checks."""
    import numpy as np
    import torch
    from repro_torch import kernels, obs
    from repro_torch.cluster import generate_cluster
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import (default_policy_grid, evaluate, get_ir,
                                    ir_config_for, ir_supported, run_sweep)
    from repro_torch.whatif import backend as B

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        t0 = time.perf_counter()
        store = TelemetryStore(d, shard_format="npy_dir")
        generate_cluster(store=store, **WHATIF_DEPLOYMENT)
        gen_s = time.perf_counter() - t0
        dense = default_policy_grid()
        t0 = time.perf_counter()
        ir = get_ir(store, ir_config_for(dense))
        ir_s = time.perf_counter() - t0
        counts = {"rows": store.total_rows, "runs": ir.n_runs}
        log(f"what-if fleet {WHATIF_DEPLOYMENT}: {counts['rows']} rows, "
            f"{len(ir.streams)} streams, {counts['runs']} IR runs (reference host "
            f"counts {WHATIF_REF_COUNTS}: "
            f"{'match' if counts == WHATIF_REF_COUNTS else 'DIFFER'}); simulated "
            f"in {gen_s:.2f} s, IR built in {ir_s:.2f} s on the host")

        kw = dict(min_job_duration_s=0.0)
        front_np = run_sweep(store, dense, backend="numpy", **kw)
        front = run_sweep(store, dense, **kw)
        worst_dense = compare_outcomes(front_np.outcomes, front.outcomes, "dense grid")
        if [o.pareto for o in front.outcomes] != [o.pareto for o in front_np.outcomes]:
            raise AssertionError("dense grid: Pareto flags differ from the oracle")
        log(f"what-if dense grid ({len(dense)} configs): torch on the card == numpy "
            f"oracle (time and count fields exact; worst relative error per float "
            f"field, rtol = atol = {WHATIF_RTOL}: {json.dumps(worst_dense)})")

        grid = grid_10k()
        n_ir = sum(ir_supported(p, ir_config_for(grid)) for p in grid)
        # the replay (evaluate, which run_sweep wraps): warm-up, min of 3
        evaluate(grid, store, **kw)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate(grid, store, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        card_s = min(times)

        # the counted main-path run
        obs.reset()
        obs.enable()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        front10 = run_sweep(store, grid, **kw)
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        stages = obs.stage_totals(obs.spans())
        fam = obs.REGISTRY.family("repro_replay_configs_total")
        by_path = {dict(k).get("path"): m.value for k, m in fam.metrics.items()}
        obs.disable()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        if launches["cap_bucket_scan"] <= 0 or launches["downscale_replay"] <= 0:
            raise AssertionError(f"the 10^4 run did not launch K4 and K7: {launches}")
        if any(launches[k] for k in SERVING_KERNELS):
            raise AssertionError(f"the 10^4 run launched serving kernels: {launches}")
        if by_path != {"torch": float(n_ir)}:
            raise AssertionError(f"configs by path {by_path}, want torch = {n_ir}")
        outs = front10.outcomes
        if len(outs) != len(grid) or not all(np.isfinite(o.counterfactual_energy_j)
                                             for o in outs):
            raise AssertionError("10^4 grid: missing or non-finite outcomes")

        idx = sample_indices(grid, WHATIF_SAMPLE)
        t0 = time.perf_counter()
        ref = evaluate([grid[i] for i in idx], store, backend="numpy", **kw)
        host_s = time.perf_counter() - t0
        worst_10k = compare_outcomes(ref, [outs[i] for i in idx], "10^4 grid sample")
        families = sorted({grid[i].name for i in idx})
        log(f"what-if 10^4 grid sample ({len(idx)} configs, {families}): torch on "
            f"the card == numpy oracle (time and count fields exact; worst relative "
            f"error per float field: {json.dumps(worst_10k)})")
        pareto = pareto_times(outs)
        searched = search(dev, store, kw)
        idle = profile_evaluate(grid, store, kw)

        packed = B.pack_ir(get_ir(store, ir_config_for(grid)), 5, **kw)
        krows = replay_kernels(dev, grid, packed)

    result = {
        "deployment": WHATIF_DEPLOYMENT, **counts, "streams": len(ir.streams),
        "kept_streams": packed.n_streams, "buckets": [list(b.key) + [int(b.idx.size)]
                                                     for b in packed.buckets],
        "dense_worst_limit_share": worst_dense["limit_share"],
        "grid": len(grid), "ir_capable": n_ir,
        "card_s_min_of_3": card_s, "card_s_runs": times,
        "configs_per_s_card": len(grid) / card_s,
        "run_sweep_s": counted_s,
        "frontier_s": counted_s - stages.get("whatif.evaluate", {}).get("total_s", 0.0),
        "sample": len(idx), "sample_families": families,
        "sample_worst_limit_share": worst_10k["limit_share"],
        "evaluate_profile": idle,
        "host_numpy_s_sample": host_s,
        "configs_per_s_host_numpy_sample": len(idx) / host_s,
        "stages_s": {k: stages.get(k, {}).get("total_s") for k in
                     ("whatif.evaluate", "backend.pack", "backend.kernels",
                      "backend.assembly")},
        "peak_memory_gib": peak_gib,
        "launches": launches, "configs_by_path": by_path,
        "pareto_flags": pareto, "search": searched,
    }
    log("what-if " + json.dumps(result))
    log(f"what-if 10^4 grid: {result['configs_per_s_card']:.1f} configs/s on the card "
        f"(torch backend, {torch.cuda.get_device_name(0)}, evaluate, min of 3; the "
        f"counted run_sweep took {counted_s:.2f} s, {result['frontier_s']:.2f} s of "
        f"it the host's Pareto frontier); "
        f"{result['configs_per_s_host_numpy_sample']:.1f} configs/s on the host "
        f"(numpy backend, this machine's CPU, the {len(idx)}-config sample)")
    return result, krows


# --------------------------------------------------------------------------- #
# live phase: the controller's tick loop on the card
# --------------------------------------------------------------------------- #
#: the reference benchmark's live deployment (benchmarks/live_bench.py:59-69),
#: 10^4 streams, 120,000 rows a shard
LIVE_DEPLOYMENT = dict(n_streams=10_000, window_s=60, dt_s=5.0)
LIVE_WINDOWS = 3                   # one tick each, then a backlog of 3 in one tick
LIVE_EVALS = 24
#: the live searches replay at the producers' sample interval and keep every
#: job: at the default dt_s = 1 the run-level IR refuses 5-second samples (the
#: torch backend could not carry the store), and the default 2-hour job filter
#: drops every job of a 60-second window (no stream would reach the card)
LIVE_REPLAY = dict(dt_s=5.0, min_job_duration_s=0.0)
#: the what-if deployment (WHATIF_DEPLOYMENT) drip-fed in 6 windows of 30 min
LIVE_SIM = dict(n_devices=64, horizon_s=3 * 3600, seed=3, window_s=1800, min_job_s=1800)
LIVE_SIM_EVALS = 64
#: tests/test_live.py's crash/resume deployment (:46-51), 3 windows
LIVE_TINY = dict(n_streams=16, window_s=30, dt_s=5.0, seed=3)
LIVE_TINY_WINDOWS = 3
LIVE_TINY_EVALS = 16
#: the spans read per tick
LIVE_SPANS = ("live.tick", "ir.build", "ir.extend", "whatif.search", "search.round",
              "whatif.evaluate", "backend.pack", "backend.kernels", "backend.assembly",
              "live.checkpoint")
#: tests/test_live.py's crash/resume loop, run as a child process on the
#: card: argv root, checkpoint, output, windows and a fault plan ("" for
#: none), which the child arms once a checkpoint is committed, so that the
#: planned crash lands in its second tick or later
LIVE_CHILD = r"""
import json, os, pathlib, sys
from repro_torch.live import LiveConfig, LiveController, SyntheticProducer
from repro_torch.telemetry import TelemetryStore
from repro_torch.whatif import frontier_to_dict
from repro_torch.whatif.search import default_families
root, ckpt, out, n_windows, plan = sys.argv[1:6]
n_windows = int(n_windows)
store = TelemetryStore(root)
prod = SyntheticProducer(store, **%(tiny)r)
prod.window = len(store.manifest["shards"])
fams = [f for f in default_families(composites=False) if f.name == "downscale"]
ctrl = LiveController(store, ckpt, LiveConfig(max_evals=%(evals)d, search_kwargs={
    "max_rounds": 1, "families": fams, **%(replay)r}))
print("resumed", ctrl.tick_no, ctrl.n_shards, flush=True)
for _ in range(20 * n_windows + 20):
    if plan and ctrl.tick_no >= 1:
        os.environ["REPRO_FAULT_PLAN"] = plan
    store.refresh()
    if store.shards_since(ctrl.n_shards):
        r = ctrl.tick()
        print("tick", r.tick, r.result, r.rung, flush=True)
    elif prod.window < n_windows:
        prod.step()
    else:
        break
else:
    sys.exit(2)
pathlib.Path(out).write_text(json.dumps(frontier_to_dict(ctrl.frontier), sort_keys=True))
""" % {"tiny": LIVE_TINY, "evals": LIVE_TINY_EVALS, "replay": LIVE_REPLAY}


def live_search_kwargs(family: str) -> dict:
    """The synthetic deployments' ``search_kwargs``: one round over one
    family (the bench's, downscale), at the producer's 5-second samples."""
    from repro_torch.whatif.search import default_families
    fams = [f for f in default_families(composites=False) if f.name == family]
    return {"max_rounds": 1, "families": fams, **LIVE_REPLAY}


def live_compare(oracle, card, label: str) -> float:
    """One tick of the card's controller against the NumPy-backend
    controller's over the same shards: the same result, shards and
    coalescing, the frontiers as :func:`compare_frontier` holds them, the
    same knee. Returns the worst float's share of its limit."""
    if (card.result, card.n_new_shards, card.coalesced) != \
            (oracle.result, oracle.n_new_shards, oracle.coalesced):
        raise AssertionError(f"{label}: tick {card.result} {card.n_new_shards}/"
                             f"{card.coalesced}, oracle {oracle.result} "
                             f"{oracle.n_new_shards}/{oracle.coalesced}")
    worst = compare_frontier(oracle.frontier, card.frontier, label)
    if card.knee.params != oracle.knee.params:
        raise AssertionError(f"{label}: knee {card.knee.params}, oracle {oracle.knee.params}")
    return worst["limit_share"]


def live_tick(dev, prod, ctrl, oprod, octrl, windows: int, label: str) -> dict:
    """Land ``windows`` windows and take them in one tick of the card's
    controller (timed to its end on the card, with its spans and kernel
    launches), then the same on the NumPy-backend controller's own store,
    with obs off; hold the two ticks to each other."""
    import torch
    from repro_torch import kernels, obs
    for _ in range(windows):
        prod.step()
    n0 = len(obs.spans())
    before = kernels.launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = ctrl.tick()
    torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    stages = obs.stage_totals(obs.spans()[n0:])
    obs.disable()
    try:
        for _ in range(windows):
            oprod.step()
        t0 = time.perf_counter()
        o = octrl.tick()
        oracle_s = time.perf_counter() - t0
    finally:
        obs.enable()
    if r.result != "refreshed" or r.rung != "warm_torch":
        raise AssertionError(f"{label}: tick {r.result} on {r.rung} ({r.error})")
    share = live_compare(o, r, label)
    return {"tick": r.tick, "n_new_shards": r.n_new_shards, "coalesced": r.coalesced,
            "rung": r.rung, "staleness_s": r.staleness_s, "tick_s": wall_s,
            "oracle_tick_s": oracle_s, "coverage": r.coverage,
            "knee": r.knee.params.get("policy"), "knee_saved_fraction": r.knee.saved_fraction,
            "worst_limit_share": share,
            "launches": {k: after[k] - before[k] for k in ("cap_bucket_scan",
                                                          "downscale_replay")},
            "spans_s": {k: stages[k]["total_s"] for k in LIVE_SPANS if k in stages},
            "rounds": stages.get("search.round", {}).get("count", 0)}


def profile_tick(dev, prod, ctrl) -> tuple[dict, object]:
    """Land one window and take it in one tick under torch.profiler, after a
    warm-up step with one device op (a profile's first device records can
    be lost): the card's busy time against the tick's wall time, and the
    port's kernels in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    prod.step()
    steps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: steps.append(p.key_averages())) as prof:
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
        prof.step()
        t0 = time.perf_counter()
        r = ctrl.tick()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    on_card = [e for e in steps[0] if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    ours: dict[str, float] = {}
    launches: dict[str, int] = {}
    for e in on_card:
        m = re.search(r"repro::(\w+)", e.key)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + e.self_device_time_total / 1e3
            launches[m.group(1)] = launches.get(m.group(1), 0) + e.count
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall_ms_profiled": wall_ms, "card_busy_ms": busy_ms,
            "card_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in on_card),
            "repro_kernels_ms": ours, "repro_kernel_launches": launches,
            "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}, r


def live_fleet(dev, root: Path) -> dict:
    """The reference benchmark's live deployment on the card: 3 windows of
    10^4 streams, one tick each, then a 3-window backlog in one tick, each
    tick held to the NumPy-backend controller's; then one more window's tick
    under torch.profiler."""
    import torch
    from repro_torch import kernels
    from repro_torch.live import LiveConfig, LiveController, SyntheticProducer
    from repro_torch.telemetry import TelemetryStore

    cfg = LiveConfig(max_evals=LIVE_EVALS, search_kwargs=live_search_kwargs("downscale"))
    ocfg = dataclasses.replace(cfg, backend="numpy")
    store, ostore = TelemetryStore(root / "fleet"), TelemetryStore(root / "fleet_oracle")
    prod = SyntheticProducer(store, **LIVE_DEPLOYMENT)
    oprod = SyntheticProducer(ostore, **LIVE_DEPLOYMENT)
    ctrl = LiveController(store, root / "fleet_ckpt.json", cfg,
                          publish_path=root / "fleet_knee.json")
    octrl = LiveController(ostore, root / "fleet_oracle_ckpt.json", ocfg)
    torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    ticks = [live_tick(dev, prod, ctrl, oprod, octrl, 1, f"live fleet window {w}")
             for w in range(LIVE_WINDOWS)]
    backlog = live_tick(dev, prod, ctrl, oprod, octrl, LIVE_WINDOWS, "live fleet backlog")
    torch.cuda.synchronize(dev)
    launches = kernels.launch_counts()
    if (backlog["n_new_shards"], backlog["coalesced"]) != (LIVE_WINDOWS, LIVE_WINDOWS - 1):
        raise AssertionError(f"live fleet backlog: {backlog['n_new_shards']} shards, "
                             f"{backlog['coalesced']} coalesced")
    if any(t["launches"]["downscale_replay"] <= 0 for t in ticks + [backlog]):
        raise AssertionError("live fleet: a tick launched no K7")
    prof, r = profile_tick(dev, prod, ctrl)
    oprod.step()
    live_compare(octrl.tick(), r, "live fleet profiled tick")
    if r.rung != "warm_torch":
        raise AssertionError(f"live fleet profiled tick on {r.rung}")
    staleness = [t["staleness_s"] for t in ticks]
    steady = staleness[1:]
    mean = sum(steady) / len(steady)
    published = json.loads((root / "fleet_knee.json").read_text())
    if published["tick"] != ctrl.tick_no or published["stale"]:
        raise AssertionError(f"live fleet: published {published}")
    rows = store.manifest["shards"][0]["rows"]
    result = {"deployment": LIVE_DEPLOYMENT, "rows_per_shard": rows,
              "max_evals": LIVE_EVALS, "search_kwargs": {"max_rounds": 1,
                                                         "families": ["downscale"],
                                                         **LIVE_REPLAY},
              "staleness_s_first": staleness[0], "staleness_s_steady_mean": mean,
              "staleness_s_steady_max": max(steady),
              "streams_per_s_steady": LIVE_DEPLOYMENT["n_streams"] / mean,
              "ticks": ticks, "backlog": backlog, "profiled_tick": prof,
              "launches": launches}
    log("live fleet " + json.dumps(result))
    log(f"live fleet ({LIVE_DEPLOYMENT['n_streams']} streams, {rows} rows a shard, "
        f"{LIVE_EVALS} evaluations): staleness first {staleness[0]:.4f} s, steady mean "
        f"{mean:.4f} s, max {max(steady):.4f} s, {result['streams_per_s_steady']:.0f} "
        f"streams/s; backlog of {LIVE_WINDOWS} in one tick {backlog['staleness_s']:.4f} s; "
        f"card idle {prof['card_idle_share']:.1%} of a profiled tick "
        f"({prof['card_busy_ms']:.3f} of {prof['wall_ms_profiled']:.1f} ms); K7 launches a "
        f"tick {[t['launches']['downscale_replay'] for t in ticks + [backlog]]}; every "
        f"tick on warm_torch == the numpy controller's; card {nvidia_smi_line()}")
    return result


def live_simulated(dev, root: Path) -> dict:
    """The what-if deployment drip-fed to the card's controller in 6
    windows, default families, each tick held to the NumPy-backend
    controller's; K4 and K7 in every tick; the extended IR's counts against
    the one-shot IR's."""
    import torch
    from repro_torch import kernels, obs
    from repro_torch.live import LiveConfig, LiveController, SimulatorProducer
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import default_policy_grid, get_ir, ir_config_for

    # the simulator samples at 1 s, the replay's default dt_s
    cfg = LiveConfig(max_evals=LIVE_SIM_EVALS,
                     search_kwargs={"min_job_duration_s": 0.0})
    ocfg = dataclasses.replace(cfg, backend="numpy")
    store = TelemetryStore(root / "sim", shard_format="npy_dir")
    ostore = TelemetryStore(root / "sim_oracle", shard_format="npy_dir")
    prod, oprod = SimulatorProducer(store, **LIVE_SIM), SimulatorProducer(ostore, **LIVE_SIM)
    ctrl = LiveController(store, root / "sim_ckpt.json", cfg)
    octrl = LiveController(ostore, root / "sim_oracle_ckpt.json", ocfg)
    torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    ticks = []
    while not prod.exhausted:
        ticks.append(live_tick(dev, prod, ctrl, oprod, octrl, 1,
                               f"live simulated window {len(ticks)}"))
    torch.cuda.synchronize(dev)
    launches = kernels.launch_counts()
    if len(ticks) != LIVE_SIM["horizon_s"] // LIVE_SIM["window_s"]:
        raise AssertionError(f"live simulated: {len(ticks)} ticks")
    if any(min(t["launches"].values()) <= 0 for t in ticks):
        raise AssertionError(f"live simulated: a tick launched no K4 or K7: "
                             f"{[t['launches'] for t in ticks]}")
    ir = get_ir(store, ir_config_for(default_policy_grid()))
    counts = {"rows": ir.source_rows, "runs": ir.n_runs}
    if counts != WHATIF_REF_COUNTS or store.total_rows != ir.source_rows:
        raise AssertionError(f"live simulated: extended IR {counts} over a store of "
                             f"{store.total_rows} rows, one-shot {WHATIF_REF_COUNTS}")
    fam = obs.REGISTRY.family("repro_ir_cache_hits_total")
    levels = {dict(k).get("level"): m.value for k, m in fam.metrics.items()} if fam else {}
    result = {"deployment": LIVE_SIM, "max_evals": LIVE_SIM_EVALS,
              "ticks": ticks, "ir_counts": counts, "ir_stream_rows": ir.n_rows,
              "ir_cache_hits": levels,
              "launches": launches}
    log("live simulated " + json.dumps(result))
    log(f"live simulated ({LIVE_SIM['n_devices']} devices, {len(ticks)} windows of "
        f"{LIVE_SIM['window_s']} s, default families, {LIVE_SIM_EVALS} evaluations): "
        f"staleness {[round(t['staleness_s'], 4) for t in ticks]} s; K4 "
        f"{[t['launches']['cap_bucket_scan'] for t in ticks]} and K7 "
        f"{[t['launches']['downscale_replay'] for t in ticks]} launches a tick; every tick "
        f"on warm_torch == the numpy controller's; extended IR {counts} == the one-shot "
        f"IR's")
    return result


def live_crash_resume(dev, root: Path) -> dict:
    """tests/test_live.py's crash/resume contract on the card, for real: a
    child process driving the tiny deployment is killed by a fire-once
    fault plan at each tick-phase boundary, in its second tick or later
    (the child arms the plan once its first checkpoint is committed), and
    relaunched; the relaunch must resume from the last committed checkpoint
    (the tick and watermark the killed child had reached) and write the
    uninterrupted child's frontier byte for byte. Then a controller made
    anew from its checkpoint after every tick (in this process, IR caches
    cleared each time) must end on it too. The children run side by side."""
    import os
    import torch
    from repro_torch.live import LiveConfig, LiveController, SyntheticProducer
    from repro_torch.live.checkpoint import MID_CHECKPOINT_STAGE
    from repro_torch.live.controller import PRE_CHECKPOINT_STAGE, PRE_EXTEND_STAGE
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.testing import faults
    from repro_torch.whatif import frontier_to_dict
    from repro_torch.whatif import ir as ir_mod

    stages = (PRE_EXTEND_STAGE, PRE_CHECKPOINT_STAGE, MID_CHECKPOINT_STAGE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def launch(name: str, plan=None):
        d = root / name
        return subprocess.Popen(
            [sys.executable, "-c", LIVE_CHILD, str(d / "store"), str(d / "ckpt.json"),
             str(d / "frontier.json"), str(LIVE_TINY_WINDOWS), str(plan or "")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def lines(text: str, word: str) -> list[list[str]]:
        return [line.split()[1:] for line in text.splitlines() if line.startswith(word + " ")]

    def wait(procs: dict) -> dict:
        out = {}
        for name, p in procs.items():
            text, _ = p.communicate(timeout=300)
            out[name] = (p.returncode, text)
        return out

    t0 = time.perf_counter()
    plans = {}
    for stage in stages:
        plans[stage] = faults.install_plan(root / f"plan_{stage}", crash=[stage])
        faults.clear_plan()
    first = wait({"baseline": launch("baseline"),
                  **{s: launch(s, plans[s]) for s in stages}})
    rc, text = first["baseline"]
    if rc != 0:
        raise AssertionError(f"live crash/resume: the uninterrupted child exited {rc}:\n{text}")
    baseline = (root / "baseline" / "frontier.json").read_text()
    before_crash = {}
    for stage in stages:
        rc, text = first[stage]
        ticks = lines(text, "tick")
        before_crash[stage] = len(ticks)
        if rc != faults.CRASH_EXIT_CODE or (root / stage / "frontier.json").exists() \
                or lines(text, "resumed") != [["0", "0"]] or len(ticks) < 1:
            raise AssertionError(f"live crash/resume: the child planned to die at {stage} in "
                                 f"its second tick or later exited {rc}:\n{text}")
    second = wait({s: launch(s, plans[s]) for s in stages})
    resumed = {}
    for stage in stages:
        rc, text = second[stage]
        resumed[stage] = [int(v) for v in lines(text, "resumed")[0]]
        if rc != 0 or (root / stage / "frontier.json").read_text() != baseline:
            raise AssertionError(f"live crash/resume: the relaunch after {stage} exited {rc} "
                                 f"or differs from the uninterrupted frontier:\n{text}")
        if resumed[stage][0] != before_crash[stage] or resumed[stage][1] < 1:
            raise AssertionError(f"live crash/resume: the relaunch after {stage} resumed at "
                                 f"tick/shards {resumed[stage]}, the killed child had "
                                 f"committed {before_crash[stage]} ticks:\n{text}")
    rungs = sorted({t[2] for _, text in [first["baseline"]] + list(second.values())
                    for t in lines(text, "tick")})
    if rungs != ["warm_torch"]:
        raise AssertionError(f"live crash/resume: children's ticks ran on {rungs}")
    children_s = time.perf_counter() - t0

    store = TelemetryStore(root / "restart" / "store")
    prod = SyntheticProducer(store, **LIVE_TINY)
    cfg = LiveConfig(max_evals=LIVE_TINY_EVALS, search_kwargs=live_search_kwargs("downscale"))
    for _ in range(LIVE_TINY_WINDOWS):
        prod.step()
        ir_mod._IR_CACHE.clear()
        ir_mod._IR_UNSUPPORTED.clear()
        ctrl = LiveController(store, root / "restart" / "ckpt.json", cfg)
        r = ctrl.tick()
        if r.result != "refreshed" or r.rung != "warm_torch":
            raise AssertionError(f"live restart per tick: {r.result} on {r.rung} ({r.error})")
    torch.cuda.synchronize(dev)
    if json.dumps(frontier_to_dict(ctrl.frontier), sort_keys=True) != baseline:
        raise AssertionError("live restart per tick: the frontier differs from the "
                             "uninterrupted child's")
    result = {"deployment": LIVE_TINY, "windows": LIVE_TINY_WINDOWS,
              "stages": list(stages), "ticks_before_crash": before_crash,
              "resumed_tick_shards": resumed, "children_s": children_s,
              "frontier_bytes": len(baseline)}
    log("live crash/resume " + json.dumps(result))
    log(f"live crash/resume on the card: children killed (exit {faults.CRASH_EXIT_CODE}) at "
        f"{', '.join(stages)} after {before_crash} committed ticks and relaunched from "
        f"those checkpoints (tick, shards {resumed}), each frontier byte-identical to the "
        f"uninterrupted child's ({len(baseline)} bytes); a restart from the checkpoint "
        f"after every tick byte-identical too; {children_s:.1f} s for the 7 children")
    return result


def live_degradation(dev, root: Path) -> dict:
    """Degradation on the card: a clock-skewed shard exhausts the ladder
    and serves the stale knee with the watermark held; a truncated shard is
    skipped with coverage < 1; a corrupt checkpoint cold-starts."""
    from repro_torch import obs
    from repro_torch.live import LiveConfig, LiveController, SyntheticProducer
    from repro_torch.telemetry import FaultTolerance, TelemetryStore
    from repro_torch.testing import faults
    from repro_torch.whatif import ir as ir_mod

    cfg = LiveConfig(max_evals=LIVE_TINY_EVALS, search_kwargs=live_search_kwargs("downscale"))

    def fresh(name: str, c=cfg):
        store = TelemetryStore(root / name / "store")
        prod = SyntheticProducer(store, **LIVE_TINY)
        prod.step()
        ctrl = LiveController(store, root / name / "ckpt.json", c)
        r = ctrl.tick()
        if r.result != "refreshed" or r.rung != "warm_torch":
            raise AssertionError(f"live degradation {name}: first tick {r.result} on {r.rung}")
        return store, prod, ctrl

    def fallbacks() -> dict:
        fam = obs.REGISTRY.family("repro_fallbacks_total")
        return {tuple(sorted(dict(k).items())): m.value
                for k, m in fam.metrics.items()} if fam else {}

    store, prod, ctrl = fresh("skew", dataclasses.replace(cfg, fault=FaultTolerance(
        max_retries=1, timeout_s=None, backoff_s=0.0)))
    good = ctrl.frontier
    prod.step()
    faults.skew_shard(store, store.manifest["shards"][-1]["file"])
    ir_mod._IR_CACHE.clear()
    ir_mod._IR_UNSUPPORTED.clear()
    before = fallbacks()
    r = ctrl.tick()
    walked = {k: v - before.get(k, 0.0) for k, v in fallbacks().items()
              if v != before.get(k, 0.0)}
    if r.result != "stale" or ctrl.frontier is not good or ctrl.n_shards != 1 \
            or r.knee is None:
        raise AssertionError(f"live degradation skew: {r.result}, watermark {ctrl.n_shards}")
    steps = {(dict(k)["from"], dict(k)["to"]) for k in walked}
    if not {("warm_torch", "warm_numpy"), ("warm_numpy", "cold_numpy"),
            ("live_tick", "stale_knee")} <= steps or \
            {dict(k)["reason"] for k in walked if dict(k)["from"] == "warm_torch"} \
            != {"IRUnsupportedError"}:
        raise AssertionError(f"live degradation skew: ladder walked {walked}")
    skew = {"result": r.result, "error": r.error, "watermark": ctrl.n_shards,
            "fallbacks": {"/".join(f"{a}={b}" for a, b in k): v for k, v in walked.items()}}

    store, prod, ctrl = fresh("truncate")
    prod.step()
    faults.truncate_file(store.root / store.manifest["shards"][-1]["file"])
    ir_mod._IR_CACHE.clear()
    r = ctrl.tick()
    if r.result != "refreshed" or not r.coverage < 1.0 or ctrl.n_shards != 2:
        raise AssertionError(f"live degradation truncate: {r.result}, coverage {r.coverage}")
    truncate = {"result": r.result, "rung": r.rung, "coverage": r.coverage,
                "watermark": ctrl.n_shards}

    store, prod, ctrl = fresh("checkpoint")
    faults.corrupt_checkpoint(root / "checkpoint" / "ckpt.json", mode="truncate")
    before = fallbacks()
    ctrl = LiveController(store, root / "checkpoint" / "ckpt.json", cfg)
    key = (("from", "checkpoint"), ("reason", "checkpoint_corrupt"), ("to", "cold_start"))
    if ctrl.tick_no != 0 or ctrl.frontier is not None \
            or fallbacks().get(key, 0.0) - before.get(key, 0.0) != 1.0:
        raise AssertionError("live degradation checkpoint: no cold start counted")
    r = ctrl.tick()
    if r.result != "refreshed" or r.rung != "warm_torch":
        raise AssertionError(f"live degradation checkpoint: {r.result} on {r.rung}")
    result = {"skew": skew, "truncate": truncate,
              "corrupt_checkpoint": {"cold_start": True, "next_tick": r.result}}
    log("live degradation " + json.dumps(result))
    return result


def live(dev) -> dict:
    """The live path: ``LiveController`` ticking on the card, K4 and K7 in
    every tick's search. Every refreshed tick of the two deployments must
    run on ``warm_torch`` with ``repro_fallbacks_total`` at 0; the
    degradation checks then walk the ladder on purpose."""
    import torch
    from repro_torch import obs

    t_phase = time.perf_counter()
    obs.reset()
    obs.enable()
    obs.init_live_metrics()
    obs.init_degradation_metrics()
    launches: dict[str, int] = {}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            root = Path(d)
            fleet = live_fleet(dev, root)
            simulated = live_simulated(dev, root)
            fam = obs.REGISTRY.family("repro_fallbacks_total")
            if fam is None or any(m.value for m in fam.metrics.values()):
                raise AssertionError("live: a tick fell back: " + json.dumps(
                    {str(k): m.value for k, m in (fam.metrics.items() if fam else ())}))
            for counts in (fleet["launches"], simulated["launches"]):
                for name, n in counts.items():
                    launches[name] = launches.get(name, 0) + n
            if launches["cap_bucket_scan"] <= 0 or launches["downscale_replay"] <= 0 \
                    or any(launches[k] for k in SERVING_KERNELS):
                raise AssertionError(f"live: launches {launches}")
            crash = live_crash_resume(dev, root)
            degradation = live_degradation(dev, root)
        text = obs.render_prometheus()
    finally:
        obs.disable()
    errors = obs.lint_exposition(text)
    missing = [name for name, _, _ in obs.LIVE_FAMILIES if f"\n{name}" not in text]
    if errors or missing:
        raise AssertionError(f"live exposition: lint {errors}, missing {missing}")
    emitted = sorted({line.split("{")[0].split(" ")[0] for line in text.splitlines()
                      if line.startswith("repro_live_") and not line.endswith(" 0")})
    torch.cuda.synchronize(dev)
    phase_s = time.perf_counter() - t_phase
    log(f"live exposition: {len(text.splitlines())} lines lint clean, every repro_live_* "
        f"family present, non-zero: {emitted}")
    log(f"live phase: {phase_s:.1f} s")
    return {"fleet": fleet, "simulated": simulated, "crash_resume": crash,
            "degradation": degradation, "launches": launches, "phase_s": phase_s}


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
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"build: {len(_build.sources())} sources in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        entry = re.search(r"Compiling entry function '_Z(?:N5repro)?\d+(\w+)'", line)
        if line.startswith("== "):
            log("  nvcc " + line[3:])
        elif entry:                     # the mangled name from the kernel's own name on
            log("  ptxas entry " + entry.group(1))
        elif "registers" in line or "spill" in line or "wgmma" in line:
            log("  ptxas " + line.strip().removeprefix("ptxas info    : "))

    errs = check_kernels(dev)
    log(f"kernels vs plain (bf16 per element, |err| <= {BF16_TOL} * (1 + |plain|)): "
        f"max abs err at the main shapes {errs}")
    errs.update(check_recurrent_kernels(dev))
    log(f"recurrent kernels vs plain (f32 per element, |err| <= tol * (1 + |plain|), "
        f"tol {SSM_TOL} for ssm_scan, {WKV_TOL} for wkv6): max abs err at the decode "
        f"step's shape {{'ssm_scan': {errs['ssm_scan']}, 'wkv6': {errs['wkv6']}}}")
    for name, used in LIMIT_USED.items():
        log(f"  {name}: {used:.4f} of the limit at the worst element")
    times = time_kernels(dev)
    times.update(time_recurrent_kernels(dev))
    log_times(times)

    # full width, bf16, random weights drawn on the card; each model is
    # freed before the next is made
    runs = [serve_model(name, dev) for name in SERVE_MAX_SEQ]

    wresult, wtimes = whatif(dev)
    lresult = live(dev)
    log_times(wtimes)
    k7 = wtimes["downscale_replay"]
    log(f"downscale_replay plain version at the main shape used "
        f"{k7['plain_peak_gib']:.3f} GiB of device memory; {k7['fired']} of "
        f"{k7['valid_runs'] * k7['pairs']} (valid run, pair) lanes fired")
    prof_k7 = wresult["evaluate_profile"]["repro_kernels_ms"].get("downscale_chain_kernel")
    log(f"downscale_replay card time: {sum(b['ms'] for b in k7['buckets']):.5f} ms over the "
        f"{len(k7['buckets'])} buckets timed alone, {prof_k7} ms in the profiled 10^4 evaluate")
    k4 = wtimes["cap_bucket_scan"]
    prof_k4 = wresult["evaluate_profile"]["repro_kernels_ms"].get("cap_bucket_scan_kernel")
    log(f"cap_bucket_scan card time: {sum(b['ms'] for b in k4['buckets']):.5f} ms over the "
        f"{len(k4['buckets'])} buckets timed alone back to back, "
        f"{sum(b['cold_ms'] for b in k4['buckets']):.5f} ms each after an L2-sized read, "
        f"{prof_k4} ms in the profiled 10^4 evaluate")
    errs.update({name: t["max_abs_err"] for name, t in wtimes.items()})
    # each main path ran with the counts set to 0 just before it
    launches = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    wgmma_launches = sum(r["flash_wgmma_launches"] for r in runs)
    for counts in [r["launches"] for r in runs] + [wresult["launches"],
                                                   wresult["search"]["launches"],
                                                   lresult["launches"]]:
        for name, n in counts.items():
            launches[name] += n
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"a kernel was launched no time on its main path: {launches}")
    rows = []
    for name, t in {**times, **wtimes}.items():
        lib = t["library"]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": t["kernel"]["ms"], "plain_ms": t["plain"]["ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": lib["ms"] if lib else None,
            "call_ms": t["kernel"]["call_ms"], "plain_call_ms": t["plain"]["call_ms"],
            "library_call_ms": lib["call_ms"] if lib else None,
            "shape": t["shape"],
        }
        for label in ("prefill", "prefill_2048"):
            if label in t:
                row.update({f"{label}_ms": t[label]["ms"],
                            f"{label}_bound_ms": t[label]["bound"][0],
                            f"{label}_plan": t[label]["plan"]})
        for label, x in t.get("extra", {}).items():
            row[label] = {"shape": x["shape"], "ms": x["ms"], "library_ms": x["library_ms"],
                          "bound_ms": x["bound"][0], "bound_by": x["bound"][1]}
        if "bound_stored" in t:
            row["bound_stored_ms"] = t["bound_stored"][0]
        for key in ("plan", "plans", "state_floor_ms", "launch", "buckets"):
            if key in t:
                row[key] = t[key]
        if name == "flash_attention":
            row["launches_tensor_cores"] = wgmma_launches
        if lresult["launches"].get(name):
            row["launches_live"] = lresult["launches"][name]
        rows.append(row)
    assert set(kernels.KERNEL_MODULES) == {r["name"] for r in rows}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
