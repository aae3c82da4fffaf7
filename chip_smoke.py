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
  an in-place read and write of the same state; holds their backward
  kernels (K5′ ``ssm_scan_bwd``, K6′ ``wkv6_bwd``) against the plain reverse
  recurrences at the training shapes, S = 1, an odd S, with and without
  the initial state and the final state's gradient, large dt and extreme
  decays, each called twice for the same bits, and times them at the
  training shapes beside their bounds; then, for
  hymba-1.5b and rwkv6-3b at full width, compares kernel-path and
  plain-path logits (each beside its chaos floor: the plain path against
  itself with attention, or the WKV recurrence, in float64) and serves each
  through ``ServingEngine`` as above, with exact launch counts, the step
  times and the lockstep check (hymba's steps also cross its 1,024-slot
  ring);
* granite-moe-3b-a800m (the dense MoE dispatch: 40 experts, top 8) at
  full width: the kernel path against the plain path end to end in bf16,
  with how often the two route each token of each layer to the same
  experts and the chaos floor beside it (the end-to-end gate applies only
  where every token-layer routes alike), each layer on the plain path's
  input (gated), and two layers in f32; served through ``ServingEngine``
  as above, with the MoE FFNs' and the expert products' card time in the
  replayed decode step; granite-3-8b and qwen1.5-4b: the end-to-end bf16
  logit check only;
* the last three families at full width (random weights from a seed,
  bf16), each served as above: whisper-tiny (K2 over its 1,500 encoder
  frames and across to them, K3 over the self and the cross caches; its
  logit checks on random frames), llama-3.2-vision-90b cut to 8 whole
  groups (40 layers; K1, K2 causal and across 1,601 vision tokens, K3; its
  logit checks on cross gates redrawn from a seed and random vision, since
  the reference's zero gates and the engine's zero vision keep the cross
  path from the logits) and deepseek-v3-671b cut to its 3 dense and 2 MoE
  layers (MLA's two attention forms plain PyTorch as in the reference, K1
  for every norm; checked as granite-moe, with its routing); K2 and K3 also
  held against their plain versions at the five new shapes (the encoder,
  whisper's and the VLM's cross-attention, the two cross caches) and timed
  there beside SDPA and their bounds; each model's f32 check is made
  before its bf16 model, so the two never share the card;
* every serve run spills its telemetry into a ``TelemetryStore`` every 30 s
  of engine time: at least 3 shards, one job at 1 s, ``analyze_store``
  against ``analyze_job`` on the concatenation, and the store priced by
  ``run_sweep`` (dense 200-config grid, K4 and K7) on the card against the
  NumPy oracle, every job kept (``min_job_duration_s=0``);
* the pool DES (host): §5.1's 8-device pool (``bench_fig10``'s deployment)
  under the balanced, 4-active and 2-active policies with the paper's
  L40S calibration (energy ratios and p95 increases, not this card's); the
  2-active run spilled every 300 s, held to the monolithic run and priced
  on the card as above;
* training: K1's and K2's autograd Functions against autograd through
  their plain versions (outputs and every input gradient, bf16 and f32,
  qwen1.5-0.5b's shapes, K2 also without the causal mask at whisper's and
  the VLM's cross-attention shapes and with a window), timed beside them;
  every family's loss (dense, moe, mla_moe, encdec, vlm, hybrid, rwkv)
  kernel path against plain path in f32, loss and every gradient, at
  F32_DEPTH's depth (deepseek-v3's routed experts cut to 64); every
  training-path wrapper refusing a CUDA tensor that requires grad, by the
  Function's name or as having no backward; then qwen1.5-0.5b at
  full width through ``repro_torch.launch.train``'s ``Trainer`` (bf16,
  AdamW, batch 8 x 128, 20 steps, the controller on, a checkpoint every
  10 steps), which replays its step from one CUDA graph after 2 eager
  steps: step 0 against the plain path beside its chaos floor leaf by
  leaf, the loss gate shown to fail an unmasked attention, K1 and
  K2 launches per step as the remat implies (the capture none, a replay
  one eager step's), a fresh trainer over the
  finished run resuming byte for byte and a restart from step 10
  reproducing steps 11-20; then an eager run of ``make_train_step``'s
  function from the same seed, which the graphed run's losses and final
  trees equal bit for bit (or, where two eager runs differ, within their
  spread, measured in the same call); the replayed step's and the eager
  step's median time, tokens/s, card-active time and peak memory side by
  side, each step's idle share as the card's share of its profiled steps'
  span on the host clock, the FLOP rate, bound and the checkpoints' times; the
  sharded step on a world of one held to the eager run; then
  hymba-1.5b (2 x 2,048 tokens, 6 steps), rwkv6-3b (8 x 128, 6 steps) and
  whisper-tiny (8 x 128 over 1,500 frames, 10 steps) the same way without
  checkpoints, each step 0 against the plain path beside its chaos floors
  (hymba over the first 256 tokens a row; rwkv6-3b, chaotic in bf16, by its
  loss over its first 4 layers and its backward kernel inside the whole
  model), every loss finite, launches per step exact (K5 and K6 twice a layer
  with the remat, their backward kernels once), with the same graphed-
  against-eager check and step measurements (the eager step of hymba-1.5b
  and rwkv6-3b timed, not profiled);
* dry-run: the runs the train and serve phases measure (the qwen1.5-0.5b,
  hymba-1.5b, rwkv6-3b and whisper-tiny train steps, llama-13b's 4-slot
  decode step) traced on the meta device by ``repro_torch.launch.dryrun``
  on a world of one, each in a process of its own with no CUDA device
  visible, beside the train phase's checks (which time nothing), under the
  H100's constants: each's compute, memory and collective terms and bound
  (the plain path's) beside the card-active time measured in this run, the
  measured time at least the card's own compute term, a train step's
  dry-run FLOPs at least ``train_flops``' with the difference named term by
  term; the K2 Function's backward under ``attn_probs_bf16`` bit for bit
  the knob-off one;
  and hymba-1.5b's train run's parameters and first batch through one
  forward and backward with ``attn_block_remat`` at ``q_block`` 512 and one
  without: the same loss bit for bit, the gradients within bounds set by
  the floor measured in the same run (two blocks of 1,024), and each one's
  peak memory;
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
* the row path, the routing and the process pool, on the same store: the
  48-config sparse grid on rows five ways (per-policy serial, batched,
  4 and 2 pool workers, mmap reads) equal bit for bit, and the dense grid
  on rows against the card's replay (times and counts exact, floats within
  1e-9), configs/s of each by host clock; the dense grid plus two configs
  the run-level IR cannot carry under ``backend="torch"`` (the IR-capable
  ones on the card, K4 and K7, the two on rows, as counted) against the
  numpy backend; a store with one sample dropped (one ``compact -> row``
  fallback, no kernel launch, the numpy backend's frontier); the pool's
  start-up (its workers never initialise CUDA), ``build_ir`` and
  ``analyze_store`` at 4 workers against 1, the torch sweep on the
  pool-built IR against the main phase's, and a sweep whose worker a fault
  plan crashes, retried to the same frontier;
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
  Prometheus exposition linted; and the reference live bench at its own
  settings (10^4 streams, the replay's defaults, so the IR refuses the
  5-second samples and every config replays on rows, as counted): the
  first window and one steady one, with their staleness.

Output: one line per phase; before the last, a ``{"kernels": [...]}`` JSON
line and the card's name and power limit from nvidia-smi; last, the
``{"ok": true, "device": ...}`` line. Any failure exits non-zero before the
last line. Exits 2 without a CUDA device or without the repository's
``src/repro_torch``. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
BF16_TOL = 2e-2                    # kernel vs plain, bf16 (tests/test_kernels.py)
F32_TOL = 2e-5                     # kernel vs plain, f32
SSM_TOL = 2e-3                     # K5 vs plain (tests/test_kernels.py:128)
WKV_TOL = 1e-3                     # K6 vs plain (tests/test_kernels.py:95,110)
#: K5's and K6's backward kernels vs their plain backwards, per element: 3x
#: and 8x the worst readings of their first runs (3.34e-4, K5′'s dc under
#: large dt; 1.26e-4, K6′'s du at the training shape, a sum over 1,024 rows
#: and steps; NVIDIA H100 80GB HBM3)
SSM_BWD_TOL = 1e-3
WKV_BWD_TOL = 1e-3
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
    # no TPU kernel: the reference differentiates its lax.scan with XLA
    "ssm_scan_bwd": "src/repro/models/hymba.py:113",
    "wkv6_bwd": "src/repro/models/rwkv.py:160",
    # no TPU kernel: the reference differentiates its attention's einsums with XLA
    "flash_attention_bwd_dq": "src/repro/models/common.py:123",
    "flash_attention_bwd_dkv": "src/repro/models/common.py:123",
}
#: the source of each kernel not in a file of its own name
SOURCES = {"flash_attention_bwd_dq": "flash_attention_bwd",
           "flash_attention_bwd_dkv": "flash_attention_bwd"}
#: K2's cases at Sq != Sk or without the causal mask: (Sq, Sk, H, KV, d,
#: causal, window)
CROSS_CASES = ((65, 1500, 20, 20, 64, False, 0), (1500, 1500, 20, 20, 64, False, 0),
               (65, 200, 8, 2, 128, True, 0), (65, 200, 8, 2, 128, True, 16),
               (65, 200, 8, 2, 128, False, 16), (130, 70, 8, 2, 64, True, 0),
               (130, 70, 8, 2, 64, False, 64), (130, 70, 8, 2, 64, True, 64),
               (70, 130, 8, 1, 256, False, 0),
               # whisper-tiny's encoder and cross-attention, the VLM's
               # cross-attention over 1,601 vision tokens (an odd length)
               (1500, 1500, 6, 6, 64, False, 0), (32, 1500, 6, 6, 64, False, 0),
               (32, 1601, 64, 8, 128, False, 0))
SERVING_KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "ssm_scan", "wkv6")
#: per model: the serve run's cache length and the logit check's prompt
#: (hymba: 2,048 tokens cross its 1,024-token window, a multiple of it)
SERVE_MAX_SEQ = {"llama-13b": 256, "hymba-1.5b": 2048, "rwkv6-3b": 256,
                 "granite-moe-3b-a800m": 256, "whisper-tiny": 256,
                 "llama-3.2-vision-90b": 256, "deepseek-v3-671b": 256}
LOGITS_PROMPT = {"llama-13b": 32, "hymba-1.5b": 2048, "rwkv6-3b": 32,
                 "granite-moe-3b-a800m": 32, "whisper-tiny": 32,
                 "llama-3.2-vision-90b": 32, "deepseek-v3-671b": 32}
#: depth cuts of the served models that do not fit one 80-GB card (widths
#: as published): the VLM to 8 whole groups of 4 self + 1 cross layers
#: (72.6 GB of bf16), deepseek-v3 to its 3 dense layers and 2 MoE layers
#: (52.8 GB, with the MTP module's parameters)
SERVE_DEPTH = {"llama-3.2-vision-90b": dict(n_layers=40),
               "deepseek-v3-671b": dict(n_layers=5)}
#: the f32 check's depth: two layers, or whole groups and stacks
F32_DEPTH = {"llama-3.2-vision-90b": dict(n_layers=5),
             "deepseek-v3-671b": dict(n_layers=2, first_k_dense=1),
             "whisper-tiny": dict(n_layers=2, n_enc_layers=2)}
#: dense configs held kernel path against plain path at full width, not served
DENSE_LOGIT_MODELS = ("granite-3-8b", "qwen1.5-4b")
#: seconds of engine time between the serve run's telemetry spills
ENGINE_DRAIN_S = 30.0
#: bench_fig10's pool (benchmarks/paper_benches.py:245-266): 8 devices,
#: azure_code at 1.9x its median gap, 1,800 s, seed 2, 0.1 s ticks, every
#: 13th request to the downscaled set; the paper's L40S calibration
POOL_DEPLOYMENT = dict(n_devices=8, duration_s=1800.0, seed=2, gap_scale=1.9,
                       tick_s=0.1, spill_every=13)
POOL_POLICIES = (("8active", "balanced", 8), ("4active", "consolidated", 4),
                 ("2active", "consolidated", 2))
#: seconds of simulated time between the 2-active pool's telemetry spills
POOL_DRAIN_S = 300.0


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
    # K1 RMSNorm: decode (4 slots) and prefill (32 tokens) rows at D = 5120;
    # granite-moe's and MLA's q_norm at 1536, the VLM's 8192, MLA's d_model
    # 7168 and kv_norm 512
    for rows, d, main in ((4, 5120, True), (32, 5120, False), (37, 5120, False),
                          *[(r, d, False) for d in (1536, 8192, 7168, 512) for r in (4, 32)]):
        x, w = rnd(rows, 1, d), rnd(d)
        e = check_close(f"rmsnorm rows={rows} d={d}", ops.rmsnorm(x, w, 1e-6),
                        ops.rmsnorm(x, w, 1e-6, plain=True), BF16_TOL)
        if main:
            errs["rmsnorm"] = e
    for d in (5120, 1536, 8192, 7168, 512):
        xf, wf = rnd(5, d, dtype=torch.float32), rnd(d, dtype=torch.float32)
        check_close(f"rmsnorm f32 d={d}", ops.rmsnorm(xf, wf),
                    ops.rmsnorm(xf, wf, plain=True), F32_TOL)
    # K2 prefill attention, model layout (B, S, H, d); bf16 takes the
    # tensor-core kernel, f32 the CUDA-core one. Around the 64-row tiles
    # (63, 64, 65), hymba-1.5b's 2,048-token prefill with and without its
    # 1,024-token window (GQA 25/5), every head dim, granite-moe (GQA 24/8),
    # the VLM's self layers (GQA 64/8, the kernel's limit of 8 q heads a kv
    # head) and whisper-tiny's decoder.
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
        (1, 32, 24, 8, 64, 0, torch.bfloat16, False),      # granite-moe prefill bucket
        (1, 32, 24, 8, 64, 0, torch.float32, False),
        (1, 32, 64, 8, 128, 0, torch.bfloat16, False),     # VLM self layers (GQA 64/8)
        (1, 32, 64, 8, 128, 0, torch.float32, False),
        (1, 32, 6, 6, 64, 0, torch.bfloat16, False),       # whisper-tiny decoder
        (1, 32, 6, 6, 64, 0, torch.float32, False),
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
    # global cache, MQA at d = 256 with S not a multiple of the chunk,
    # granite-moe (3 q heads a kv head), the self caches of the VLM (8 q
    # heads a kv head) and whisper-tiny
    for b, s, h, kv, d, dtype in ((4, 256, 40, 40, 128, torch.bfloat16),
                                  (4, 2048, 25, 5, 64, torch.bfloat16),
                                  (2, 100, 8, 1, 256, torch.bfloat16),
                                  (4, 2048, 25, 5, 64, torch.float32),
                                  (4, 256, 24, 8, 64, torch.bfloat16),   # granite-moe
                                  (4, 256, 24, 8, 64, torch.float32),
                                  (4, 256, 64, 8, 128, torch.bfloat16),  # the VLM
                                  (4, 256, 64, 8, 128, torch.float32),
                                  (4, 256, 6, 6, 64, torch.bfloat16),    # whisper-tiny
                                  (4, 256, 6, 6, 64, torch.float32),
                                  # the cross caches: whisper-tiny, the VLM
                                  (4, 1500, 6, 6, 64, torch.bfloat16),
                                  (4, 1500, 6, 6, 64, torch.float32),
                                  (4, 1601, 64, 8, 128, torch.bfloat16),
                                  (4, 1601, 64, 8, 128, torch.float32)):
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
    (``enable_gqa=True``; a boolean mask for the window); at
    granite-moe-3b-a800m's: K1 over its decode rows and prefill bucket at
    D = 1536; K1 over llama-3.2-vision-90b's decode rows (D = 8192) and
    deepseek-v3-671b's (the hidden size 7168, the q and kv LoRA ranks 1536
    and 512); K2 over its 32-token bucket (24 q / 8 kv heads of 64), K3 over
    a (4, 256, 8, 64) cache rotated over its 32 layers (64 MB); and at the
    last three families': K2 over whisper-tiny's 1,500 encoder frames and
    across to them from 32 tokens, and across the VLM's 1,601 vision tokens
    (64 q / 8 kv heads of 128), none masked; K3 over both cross caches."""
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
                                 ("hymba_prefill", (1, 2048, 1600), 8),
                                 ("granite_moe_decode", (4, 1, 1536), 1),
                                 ("granite_moe_prefill", (1, 32, 1536), 1),
                                 ("vlm_decode", (4, 1, 8192), 1),
                                 ("mla_decode_hidden", (4, 1, 7168), 1),
                                 ("mla_decode_q_lora", (4, 1, 1536), 1),
                                 ("mla_decode_kv_lora", (4, 1, 512), 1)):
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
    s, h, kv, d = 32, 24, 8, 64
    q, k, v = rnd(1, s, h, d), rnd(1, s, kv, d), rnd(1, s, kv, d)
    out["flash_attention"]["extra"]["granite_moe"] = dict(
        shape="q (1, 32, 24, 64), k, v (1, 32, 8, 64) bf16, causal",
        ms=graph_ms(lambda: ops.flash_attention(q, k, v)),
        library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
            *heads(q, k, v), is_causal=True, enable_gqa=True)),
        bound=bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2,
                       4 * d * h * s * (s + 1) // 2))

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
    del kc, vc
    layers, b, s, h, kv, d = 32, 4, 256, 24, 8, 64
    kc, vc = rnd(layers, b, s, kv, d), rnd(layers, b, s, kv, d)
    q = rnd(b, 1, h, d)
    n = torch.full((), s, dtype=torch.int32, device=dev)
    out["decode_attention"]["extra"]["granite_moe"] = dict(
        shape="q (4, 1, 24, 64), caches (4, 256, 8, 64) bf16, len 256, rotated over 32 layers",
        ms=graph_ms(rotate(lambda i: ops.decode_attention(q, kc[i], vc[i], n), layers)),
        library_ms=graph_ms(rotate(lambda i: F.scaled_dot_product_attention(
            *heads(q, kc[i], vc[i]), enable_gqa=True), layers)),
        bound=bound_ms(2 * q.numel() * 2 + 2 * b * s * kv * d * 2, 4 * d * b * h * s))
    del kc, vc
    # the last three families: whisper-tiny's encoder over its 1,500 frames
    # and its cross-attention from the 32-token bucket, the VLM's
    # cross-attention over 1,601 vision tokens, none masked
    for label, (sq, sk, h, kv, d) in (("whisper_encoder", (1500, 1500, 6, 6, 64)),
                                      ("whisper_cross", (32, 1500, 6, 6, 64)),
                                      ("vlm_cross", (32, 1601, 64, 8, 128))):
        q, k, v = rnd(1, sq, h, d), rnd(1, sk, kv, d), rnd(1, sk, kv, d)
        out["flash_attention"]["extra"][label] = dict(
            shape=f"q (1, {sq}, {h}, {d}), k, v (1, {sk}, {kv}, {d}) bf16, no mask",
            ms=graph_ms(lambda q=q, k=k, v=v: ops.flash_attention(q, k, v, causal=False)),
            library_ms=graph_ms(lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                *heads(q, k, v), enable_gqa=True)),
            bound=bound_ms(2 * q.numel() * 2 + 2 * k.numel() * 2, 4 * d * h * sq * sk))
    # K3 over the two cross caches at their full length, rotated over 8
    # copies (74 MB and 210 MB, past the L2)
    layers, b = 8, 4
    for label, (s, h, kv, d) in (("whisper_cross", (1500, 6, 6, 64)),
                                 ("vlm_cross", (1601, 64, 8, 128))):
        kc, vc = rnd(layers, b, s, kv, d), rnd(layers, b, s, kv, d)
        q = rnd(b, 1, h, d)
        n = torch.full((), s, dtype=torch.int32, device=dev)
        out["decode_attention"]["extra"][label] = dict(
            shape=f"q (4, 1, {h}, {d}), caches (4, {s}, {kv}, {d}) bf16, len {s}, "
                  f"rotated over {layers} copies",
            ms=graph_ms(rotate(lambda i, q=q, kc=kc, vc=vc, n=n: ops.decode_attention(
                q, kc[i], vc[i], n), layers)),
            library_ms=graph_ms(rotate(lambda i, q=q, kc=kc, vc=vc: F.scaled_dot_product_attention(
                *heads(q, kc[i], vc[i]), enable_gqa=True), layers)),
            bound=bound_ms(2 * q.numel() * 2 + 2 * b * s * kv * d * 2, 4 * d * b * h * s))
        del kc, vc
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


def ssm_bwd_args(g, dev, bsz, s, state, dstate, big_dt=False, di=3200, n=16):
    """K5's backward inputs: :func:`ssm_args`'s (at I = ``di``, N = ``n``),
    h0 (``state``), dy normal and dh_out (``dstate``); None where not
    given."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    dt = F.softplus(rnd(bsz, s, di)) * (100.0 if big_dt else 1.0)
    return (rnd(bsz, s, di), dt, -torch.exp(0.5 * rnd(di, n)), rnd(bsz, s, n),
            rnd(bsz, s, n), rnd(bsz, di, n) if state else None, rnd(bsz, s, di),
            rnd(bsz, di, n) if dstate else None)


def wkv_bwd_args(g, dev, bsz, s, state, dstate, extreme=False, h=40, kd=64):
    """K6's backward inputs, head-major views of the model's (B, S, H, K)
    layout as :func:`wkv_args` draws them (at H = ``h``, K = ``kd``),
    state0 (``state``), dy normal and dstate_out (``dstate``); None where
    not given."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v, dy = (rnd(bsz, s, h, kd).transpose(1, 2) for _ in range(4))
    if extreme:
        w = torch.where(rnd(bsz, s, h, kd) > 0, 0.999, 1e-4).transpose(1, 2)
    else:
        w = (0.4 + 0.55 * torch.sigmoid(rnd(bsz, s, h, kd))).transpose(1, 2)
    return (r, k, v, w, 0.1 * rnd(h, kd), rnd(bsz, h, kd, kd) if state else None, dy,
            rnd(bsz, h, kd, kd) if dstate else None)


#: K5's backward cases: (B, S, h0, dh_out, large dt, I, N); the first is
#: hymba-1.5b's training shape (2 x 2,048 tokens)
SSM_BWD_CASES = ((2, 2048, False, False, False, 3200, 16), (1, 1, True, True, False, 3200, 16),
                 (2, 37, True, False, False, 3200, 16), (2, 37, False, True, False, 3200, 16),
                 (2, 40, True, True, True, 3200, 16), (1, 33, True, True, False, 100, 8))
#: K6's backward cases: (B, S, state0, dstate_out, extreme decays, H, K); the
#: first is rwkv6-3b's training shape (8 x 128 tokens)
WKV_BWD_CASES = ((8, 128, False, False, False, 40, 64), (1, 1, True, True, False, 40, 64),
                 (2, 37, True, False, False, 40, 64), (2, 37, False, True, False, 40, 64),
                 (1, 64, True, True, True, 40, 64), (2, 19, True, True, False, 3, 16),
                 (2, 19, False, True, False, 3, 32))
#: K5's backward under every plan (``ssm_scan.backward_plan``: each group, each
#: segment count the length allows), cases as SSM_BWD_CASES': the training
#: shape; a ragged last channel tile at N = 16 and 8 with S not a multiple of
#: the chunk, long enough for 4 and 8 segments, large dt at N = 8; S = 1
SSM_BWD_PLAN_CASES = ((2, 2048, False, False, False, 3200, 16),
                      (2, 301, True, True, False, 100, 16),
                      (1, 177, True, True, True, 100, 8), (1, 1, True, True, False, 3200, 8))


#: cases run on inputs off the 16-byte grid (the wrappers copy them onto it):
#: one each of SSM_BWD_CASES and WKV_BWD_CASES, and K5's at an I that is no
#: multiple of 4 (the wrapper pads it with channels of zeros)
BWD_OFFSET_CASES = {"ssm_scan_bwd": ((2, 37, True, True, False, 3200, 16),
                                     (1, 33, True, True, False, 98, 8)),
                    "wkv6_bwd": ((2, 37, True, True, False, 40, 64),)}


def offset_copy(t):
    """``t``'s values, contiguous, 4 bytes off the 16-byte grid (None stays
    None): inputs that the backward wrappers copy onto the grid."""
    if t is None:
        return None
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def ssm_bwd_plans(bsz: int, s: int, di: int, n: int) -> list:
    """Every plan of K5's backward at (``bsz``, ``s``, ``di``, ``n``): each
    group with each segment count the length allows."""
    from repro_torch.kernels import ssm_scan as k5
    plans = []
    for grp in k5.GROUPS:
        for seg in k5.BWD_SEGMENTS:
            try:
                plans.append(k5.backward_plan(bsz, s, di, n, group=grp, segments=seg))
            except ValueError:
                pass
    return plans


def bwd_plan_str(plan) -> str:
    """A backward plan's numbers, as the kernel takes them."""
    if hasattr(plan, "segments"):
        return (f"group={plan.group}, lanes={plan.lanes}, channels={plan.channels}, "
                f"chunk={plan.chunk}, segments={plan.segments}, seg_chunks={plan.seg_chunks}, "
                f"blocks={plan.blocks}, smem={plan.smem_bytes}, "
                f"scratch={plan.scratch_bytes}, bc_part={plan.bc_part_bytes}")
    from repro_torch.kernels import rwkv6_scan as k6
    return (f"slices={plan.slices}, threads={plan.threads}, chunk={k6.BWD_CHUNK}, "
            f"round={k6.BWD_ROUND}, blocks={plan.blocks}, smem={plan.smem_bytes}, "
            f"scratch={plan.scratch_bytes}")


def check_recurrent_backward(dev) -> dict[str, float]:
    """K5's and K6's backward kernels against their plain backwards (the
    reverse recurrences in PyTorch ops, on the card) per element, each call
    twice for the same bits: the training shapes, S = 1, an odd S, with and
    without the initial state and the final state's gradient, large dt
    (exp(dt a) -> 0) and decays at 1e-4 and 0.999, and the other compiled
    N and K, cases off the 16-byte grid (BWD_OFFSET_CASES); then K5's at
    every plan (SSM_BWD_PLAN_CASES). Returns the max abs error at each
    training shape."""
    import torch
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(13)
    errs = {}

    def held(name, tol, kernel, args, want, label):
        got, again = kernel(*args), kernel(*args)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name} {label}: two calls differ")
        return max(check_close(f"{name} {label} {j}", x, w, tol)
                   for j, (x, w) in enumerate(zip(got, want)))

    for name, tol, kernel, plain, cases, args_of in (
            ("ssm_scan_bwd", SSM_BWD_TOL, k5.ssm_scan_backward, k5.ssm_scan_backward_plain,
             SSM_BWD_CASES, lambda bsz, s, st, ds, edge, a, b: ssm_bwd_args(
                 g, dev, bsz, s, st, ds, edge, di=a, n=b)),
            ("wkv6_bwd", WKV_BWD_TOL, k6.wkv6_backward, k6.wkv6_backward_plain,
             WKV_BWD_CASES, lambda bsz, s, st, ds, edge, a, b: wkv_bwd_args(
                 g, dev, bsz, s, st, ds, edge, h=a, kd=b))):
        for i, case in enumerate(cases):
            args = args_of(*case)
            worst = held(name, tol, kernel, args, plain(*args), case)
            if i == 0:
                errs[name] = worst
        for case in BWD_OFFSET_CASES[name]:
            args = [offset_copy(x) for x in args_of(*case)]
            held(name, tol, kernel, args, plain(*args), f"{case} off the grid")
    for bsz, s, st, ds, edge, di, n in SSM_BWD_PLAN_CASES:
        args = ssm_bwd_args(g, dev, bsz, s, st, ds, edge, di=di, n=n)
        want = k5.ssm_scan_backward_plain(*args)
        for plan in ssm_bwd_plans(bsz, s, di, n):
            held("ssm_scan_bwd", SSM_BWD_TOL, lambda *x, p=plan: k5.ssm_scan_backward(
                *x, plan=p), args, want, f"{(bsz, s, di, n)} group {plan.group} segments "
                f"{plan.segments}")
    torch.cuda.synchronize()
    return errs


def time_recurrent_backward(dev) -> dict[str, dict]:
    """K5's and K6's backward kernels alone at the training shapes (hymba-1.5b
    2 x 2,048 tokens, rwkv6-3b 8 x 128), from a zero initial state and with
    no final-state gradient, as the losses call them; K5's also under every
    other plan ("plans"); the plain backward beside each (eager: its Python
    loop over the steps). Bounds from this run's bytes (each input read
    once, each output written once; not the kernels' state scratch) and
    operations at the float32 rate: K5′ 26 per (row, step, channel, state
    entry), the 6 that recompute the state and the reverse step's 20; K6′ 15
    per (row, head, step, k, v), 2 and 13. No single PyTorch call computes
    either gradient."""
    import torch
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(14)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, kernel, plain, args, ops_per, plan in (
            ("ssm_scan_bwd", k5.ssm_scan_backward, k5.ssm_scan_backward_plain,
             ssm_bwd_args(g, dev, 2, 2048, False, False), 26,
             k5.backward_plan(2, 2048, 3200, 16, sms=sms)),
            ("wkv6_bwd", k6.wkv6_backward, k6.wkv6_backward_plain,
             wkv_bwd_args(g, dev, 8, 128, False, False), 15,
             k6.backward_plan(8, 40, 128, 64))):
        grads = kernel(*args)
        work = args[0].numel() * (args[2].shape[-1] if name == "ssm_scan_bwd"
                                  else args[0].shape[-1])
        plain_ms = cuda_ms(lambda: plain(*args), iters=2, warmup=1)
        out[name] = dict(
            shape=", ".join(f"{tuple(t.shape)}" for t in args if t is not None) + " f32",
            kernel=timed(lambda: kernel(*args), 10),
            plain={"ms": plain_ms, "call_ms": plain_ms}, library=None,
            bound=bound_ms(nbytes(*args, *grads), ops_per * work, F32_OPS_PER_S),
            plan=bwd_plan_str(plan))
        if name == "ssm_scan_bwd":
            out[name]["plans"] = {"train": {
                f"group={p.group}, segments={p.segments}": dict(
                    plan=bwd_plan_str(p),
                    ms=graph_ms(lambda p=p: kernel(*args, plan=p), 10))
                for p in ssm_bwd_plans(2, 2048, 3200, 16)}}
        del grads
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
    overlap twice), its device operations, and the kernels that take it;
    beside them the host clock's span of the profiled calls from the first
    one's start to the card's end (``wall_ms_per_step``) and the card's idle
    share of that span, both sides from the same calls; and the NCCL kernels
    among the operations (names starting ``nccl``), by name. The train
    step's marks (``repro::mark_*``, empty kernels that only label the
    timeline) are left out of every tally."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    active, wall_s = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: active.append((p.key_averages(),
                                                         p.events()))) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_s.append(time.perf_counter() - t0)
            prof.step()
    averages, events = active[0]

    def counted(name):
        return not name.startswith("ProfilerStep") and "repro::mark_" not in name

    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and counted(e.name)]
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA and counted(e.key)]
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]
    ours: dict[str, float] = {}
    launches: dict[str, float] = {}
    for e in on_card:                 # the port's kernels, by name
        m = re.search(r"repro::(\w+)", e.key)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / steps
            launches[m.group(1)] = launches.get(m.group(1), 0) + e.count / steps
    nccl = [e for e in on_card if e.key.lower().startswith("nccl")]
    active_ms, wall_ms = covered(spans) / 1e3 / steps, wall_s[1] * 1e3 / steps
    return {
        "card_busy_ms_per_step": sum(e.self_device_time_total for e in on_card) / 1e3 / steps,
        "card_active_ms_per_step": active_ms,
        "wall_ms_per_step": wall_ms,
        "idle_share": 1 - active_ms / wall_ms,
        "device_ops_per_step": sum(e.count for e in on_card) / steps,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / steps
                                    for e in top},
        "repro_kernels_ms_per_step": ours,
        "repro_launches_per_step": launches,
        "nccl_ops_per_step": sum(e.count for e in nccl) / steps,
        "nccl_kernels": sorted({e.key[:60] for e in nccl}),
    }


def decode_step_times(engine, serve_ms: float) -> dict:
    """The engine's decode step as a CUDA-graph replay and eagerly, on the
    same parameters and cache: each step's time (:func:`step_ms`) beside the
    card's busy time (:func:`profile_steps`) and the idle share between
    them; the serve run's mean decode phase beside them. The profiler can
    lose every record of a profile (a harness flake, as in
    :func:`after_read_ms`): a profile that saw no device time is taken
    again, up to 3 in all, each retry logged."""
    import torch
    from repro_torch.models import api

    tokens = torch.full((engine.ec.n_slots, 1), 7, dtype=torch.long,
                        device=engine.torch_device)
    steps = {"replayed": lambda: engine.decode(tokens),
             "eager": lambda: api.decode_step(engine.params, engine.cache, tokens, engine.cfg)}
    result = {}
    for label, fn in steps.items():
        ms = step_ms(fn)
        for attempt in range(1, 4):
            prof = profile_steps(fn)
            busy = prof["card_busy_ms_per_step"]
            if busy > 0:
                break
            log(f"{label} decode step: profile {attempt} of 3 saw no device time")
        else:
            raise AssertionError(f"{label} decode step: the profiler saw no device time")
        result[label] = {"step_ms": ms, "card_idle_share": 1.0 - busy / ms,
                         "card_idle_share_active": 1.0 - prof["card_active_ms_per_step"] / ms,
                         **prof}
    result["serve_run_mean_decode_ms"] = serve_ms
    weight_bytes = decode_weight_bytes(engine)
    result["weight_read_bound_ms"] = bound_ms(weight_bytes, 0)[0]
    name = engine.cfg.name
    if engine.cfg.family in ("moe", "mla_moe"):
        result["moe"] = moe_step_times(engine, result["replayed"]["step_ms"])
    log(f"profile {name} decode step " + json.dumps(result))
    rep, eag = result["replayed"], result["eager"]
    log(f"decode step {name} (4 slots): " + "; ".join(
        f"{label} {r['step_ms']:.4f} ms, card busy {r['card_busy_ms_per_step']:.4f} ms "
        f"(idle {r['card_idle_share']:.1%}), active {r['card_active_ms_per_step']:.4f} ms "
        f"(idle {r['card_idle_share_active']:.1%}), {r['device_ops_per_step']:.0f} device ops"
        for label, r in (("replayed", rep), ("eager", eag)))
        + f"; serve run's replayed phase {serve_ms:.4f} ms; weight-read bound "
        f"{result['weight_read_bound_ms']:.4f} ms ({weight_bytes / 1e9:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); card {nvidia_smi_line()}")
    return result


def decode_weight_bytes(engine) -> int:
    """Bytes of weights one decode step of the engine reads: each weight it
    reads whole once (``api.decode_params``: no encoder, no cross key and
    value projections, no MTP module), and the rows of the embedding it
    gathers, one a slot, where the embedding is not among them."""
    from repro_torch.models import api

    read = api.decode_params(engine.params, engine.cfg)
    embed = engine.params["embed"]
    gathered = 0 if any(t is embed for t in read) else (
        engine.ec.n_slots * embed.shape[1] * embed.element_size())
    return count_bytes(read) + gathered


def moe_step_times(engine, step_ms: float) -> dict:
    """Card time per decode step of the MoE FFNs of every MoE layer at the
    decode step's (n_slots, 1) tokens, whole (``moe.moe_ffn``: router, the
    expert products, combine) and the expert products alone (each layer's
    three batched GEMMs over all experts and the activation), each in a CUDA
    graph on the engine's weights, beside the bytes of expert weights they
    read; with their shares of the replayed step's ``step_ms``."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models import moe

    cfg, params = engine.cfg, engine.params
    n = engine.ec.n_slots
    g = torch.Generator(device=engine.torch_device).manual_seed(6)
    x = torch.randn((n, 1, cfg.d_model), generator=g,
                    device=engine.torch_device).to(cm.param_dtype(cfg))
    stacks = params["layers"] if cfg.family == "moe" else params["moe_layers"]
    layers = [cm.layer(stacks, i) for i in range(stacks["we_gate"].shape[0])]
    act = cm.act_fn(cfg.act)
    n_experts = layers[0]["we_gate"].shape[0]

    def ffn():
        for lp in layers:
            moe.moe_ffn(x, lp, cfg)

    def products():
        xe = x.reshape(1, n, cfg.d_model).expand(n_experts, n, cfg.d_model)
        for lp in layers:
            h = torch.bmm(xe, lp["we_gate"])
            torch.bmm(act(h) * torch.bmm(xe, lp["we_up"]), lp["we_down"])

    expert_bytes = count_bytes([stacks[k] for k in ("we_gate", "we_up", "we_down")])
    out = {"moe_ffn_ms": graph_ms(ffn, 5), "expert_products_ms": graph_ms(products, 5),
           "expert_bytes": expert_bytes,
           "expert_read_bound_ms": bound_ms(expert_bytes, 0)[0]}
    out["moe_ffn_share"] = out["moe_ffn_ms"] / step_ms
    out["expert_products_share"] = out["expert_products_ms"] / step_ms
    log(f"moe {cfg.name} decode step: MoE FFNs {out['moe_ffn_ms']:.4f} ms "
        f"({out['moe_ffn_share']:.1%} of the replayed step), expert products "
        f"{out['expert_products_ms']:.4f} ms ({out['expert_products_share']:.1%}); "
        f"expert weights {expert_bytes / 1e9:.2f} GB, read bound "
        f"{out['expert_read_bound_ms']:.4f} ms")
    return out


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


def stub_inputs(cfg, dev, seed: int = 7) -> dict:
    """Seeded random ``frames=`` (whisper) or ``vision=`` (the VLM) for one
    sequence, in the model's dtype; {} for the other families. Without them
    the frames and the vision K/V are zeros, as in the engine's serve run."""
    import torch
    from repro_torch.models import common as cm

    n = {"encdec": cfg.n_frames, "vlm": cfg.n_vision_tokens}.get(cfg.family)
    if n is None:
        return {}
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, n, cfg.d_model), generator=g, device=dev).to(cm.param_dtype(cfg))
    return {"frames" if cfg.family == "encdec" else "vision": x}


def open_gates(cfg, params, dev, seed: int = 8) -> None:
    """Redraw the VLM's cross-attention gates in place at 0.5 +- 0.1 from a
    seed: at the reference's 0, tanh(0) = 0 and the cross blocks never reach
    the logits. A no-op for the other families."""
    import torch
    if cfg.family != "vlm":
        return
    g = torch.Generator(device=dev).manual_seed(seed)
    for name in ("gate_attn", "gate_mlp"):
        gate = params["cross_layers"][name]
        gate.copy_(0.5 + 0.1 * torch.randn(gate.shape, generator=g, device=dev))


def logit_runs(cfg, params, dev, prompt: int, plain: bool) -> list:
    """Logits of one ``prompt``-token prefill and two decode steps on seeded
    tokens (the same tokens for every call), whisper's on random frames and
    the VLM's on random vision (:func:`stub_inputs`)."""
    import torch
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(2, cfg.vocab_size, (1, prompt), generator=g, device=dev)
    steps = torch.randint(2, cfg.vocab_size, (2, 1, 1), generator=g, device=dev)
    cache, logits = api.prefill(params, tokens, cfg, plain=plain, **stub_inputs(cfg, dev))
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


def mha_f64(q, k, v, *, causal: bool = True, window: int = 0, knobs=None):
    """The plain prefill attention in float64, cast to q's type: a second
    correct computation of the same function, for the chaos floor (with no
    tuning knob; ``knobs`` is taken and ignored)."""
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


def decode_f64(q, k_cache, v_cache, cache_len, knobs=None):
    """The plain decode attention in float64, cast to q's type (``knobs``
    taken and ignored, as by :func:`mha_f64`)."""
    import torch
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    k = torch.repeat_interleave(k_cache.double(), h // kvh, dim=1)
    v = torch.repeat_interleave(v_cache.double(), h // kvh, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", q.double(), k) / d ** 0.5
    sc = torch.where(torch.arange(s, device=q.device)[None, None, :] < cache_len, sc, -1e30)
    return torch.einsum("bhk,bhkd->bhd", torch.softmax(sc, -1), v).to(q.dtype)


def mla_attention_f64(q, k, v):
    """MLA's plain prefill attention in float64, cast to v's type."""
    import torch
    s = q.shape[1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / q.shape[-1] ** 0.5
    pos = torch.arange(s, device=q.device)
    sc = torch.where(pos[None, :] <= pos[:, None], sc, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v.double()).to(v.dtype)


def attention_f64_floor(cfg, params, dev, prompt: int, plain: list) -> float:
    """The plain path's logits with both attention functions in float64
    (MLA's: its prefill attention), against the plain path's (``plain``):
    how far two correct computations of the model fall apart in bf16. A
    kernel-vs-plain error near it cannot be told from rounding."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import mla
    saved = (flash_attention.flash_attention_plain, decode_attention.decode_attention_plain,
             mla._causal_attention)
    flash_attention.flash_attention_plain = mha_f64
    decode_attention.decode_attention_plain = decode_f64
    mla._causal_attention = mla_attention_f64
    try:
        f64 = logit_runs(cfg, params, dev, prompt, True)
    finally:
        (flash_attention.flash_attention_plain, decode_attention.decode_attention_plain,
         mla._causal_attention) = saved
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


def routed(fn):
    """``fn()`` with every ``moe.router_topk`` call's expert ids recorded, in
    call order (one a layer a forward): (fn's result, [ids])."""
    from repro_torch.models import moe
    seen = []
    orig = moe.router_topk

    def record(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out[1])
        return out

    moe.router_topk = record
    try:
        return fn(), seen
    finally:
        moe.router_topk = orig


def route_agreement(a: list, b: list) -> tuple[int, int]:
    """(token-layers whose top-k expert sets agree, token-layers) between
    two runs' recorded ids."""
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} router calls against {len(b)}")
    agree = total = 0
    for x, y in zip(a, b):
        same = (x.sort(-1).values == y.sort(-1).values).all(-1)
        agree += int(same.sum())
        total += same.numel()
    return agree, total


def moe_logits(cfg, params, dev, tol: float, prompt: int) -> dict:
    """An MoE model's (granite-moe's, deepseek-v3's) end-to-end bf16 logits,
    kernel path against plain path,
    with how often the two paths route each token of each layer to the same
    experts, and the chaos floor (the plain path against itself with
    attention in float64) with its own routing agreement. A rounding-level
    change can move a token's 8th and 9th router logits past each other
    and route it elsewhere, which moves the logits far more than rounding
    does; so the end-to-end gate applies only when every token-layer routes
    alike, and the layer check (:func:`moe_layers_check`) is gated always."""
    plain, r_plain = routed(lambda: logit_runs(cfg, params, dev, prompt, True))
    kernel, r_kernel = routed(lambda: logit_runs(cfg, params, dev, prompt, False))
    label = f"{cfg.name} bf16 ({cfg.n_layers} layers)"
    err = normwise_error(kernel, plain, cfg, label)
    agree, total = route_agreement(r_kernel, r_plain)
    floor, r_floor = routed(lambda: attention_f64_floor(cfg, params, dev, prompt, plain))
    f_agree, _ = route_agreement(r_floor, r_plain)
    gated = agree == total
    if gated and err > tol:
        raise AssertionError(f"{label}: normwise logit error {err} > {tol}")
    log(f"logits {label}: {prompt}-token prefill + 2 decode steps, kernel vs plain "
        f"normwise rel err {err:.3e} ({'tol ' + str(tol) if gated else 'not gated'}); "
        f"router top-{cfg.top_k} sets agree in {agree} of {total} token-layers; chaos "
        f"floor (plain vs plain with attention in float64) {floor:.3e}, its routing "
        f"agrees in {f_agree} of {total}")
    return {"kernel_vs_plain": err, "gated": gated, "routes_agree": agree,
            "token_layers": total, "plain_f32_vs_f64_attention": floor,
            "floor_routes_agree": f_agree}


def moe_layers_check(cfg, params, dev, tol: float, prompt: int = 32) -> dict:
    """Each layer of an MoE model (granite-moe, deepseek-v3) at full width,
    kernel path against plain path on the same input and cache (the plain
    path's), over a ``prompt``-token prefill and two decode steps in bf16:
    the worst normwise relative error of the layer outputs and of what they
    write to the cache (keys and values, MLA's latents), and the routing
    agreement of the same inputs. Unlike the end-to-end logits these errors
    do not compound through the layers."""
    import torch
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(2, cfg.vocab_size, (1, prompt), generator=g, device=dev)
    steps = torch.randint(2, cfg.vocab_size, (2, 1, 1), generator=g, device=dev)
    family = api.family_module(cfg)
    layers = family.layers(params, cfg)
    # each layer's cache tensors (keys and values, MLA's latents), zero
    caches = [t for t, _ in api.cache_rows(cfg, api.init_cache(cfg, 1, prompt + 8, dev))]
    worst, agree, total = 0.0, 0, 0

    def compare(i, outs, r):
        nonlocal worst, agree, total
        for a, b in zip(outs[False], outs[True]):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{cfg.name} layer {i}: non-finite output")
            worst = max(worst, float((a.float() - b.float()).norm() / b.float().norm()))
        n, t = route_agreement(r[0::2], r[1::2])
        agree, total = agree + n, total + t

    x = params["embed"][tokens]
    positions = torch.arange(prompt, device=dev)
    for i in range(cfg.n_layers):
        outs, r = routed(lambda: {
            plain: family._prefill_layer(x, layers[i], cfg, positions, plain)[:3]
            for plain in (False, True)})
        compare(i, outs, r)
        x, *parts = outs[True]
        for c, part in zip(caches, parts):
            c[i, :, :prompt] = part
    for step, toks in enumerate(steps):
        at = family.decode_at(torch.tensor(prompt + step, dtype=torch.int32, device=dev),
                              prompt + 8)
        x = params["embed"][toks]
        for i in range(cfg.n_layers):

            def layer(plain):
                cs = [c[i].clone() for c in caches]
                return family._decode_layer(x, layers[i], cfg, cs, at, plain), *cs

            outs, r = routed(lambda: {plain: layer(plain) for plain in (False, True)})
            compare(i, outs, r)
            x, *cs = outs[True]
            for c, new in zip(caches, cs):
                c[i].copy_(new)
    if worst > tol:
        raise AssertionError(f"{cfg.name} layer check: normwise error {worst} > {tol}")
    log(f"layers {cfg.name} bf16: each of {cfg.n_layers} layers, kernel vs plain on the "
        f"plain path's input and cache over a {prompt}-token prefill + 2 decode steps, "
        f"worst normwise rel err of outputs, "
        f"{'keys and values' if cfg.family == 'moe' else 'latents'} {worst:.3e} (tol {tol}); "
        f"router top-{cfg.top_k} sets agree in {agree} of {total} token-layers")
    return {"worst": worst, "routes_agree": agree, "token_layers": total}


def absorbed_vs_expanded(cfg, params, dev, tol: float, prompt: int) -> dict:
    """MLA's two attention forms on the same weights: the absorbed decode
    step of token ``prompt + 1`` after a ``prompt``-token prefill against
    the last logits of the expanded prefill of all ``prompt + 1`` tokens,
    equal in exact arithmetic. The normwise relative error is gated at
    ``tol`` where both route the last token alike in every MoE layer (a
    rounding-level change can flip a near-tie, as in :func:`moe_logits`)."""
    import torch
    from repro_torch.models import api

    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(2, cfg.vocab_size, (1, prompt + 1), generator=g, device=dev)

    def absorbed():
        cache, _ = api.prefill(params, tokens[:, :-1], cfg)
        cache = api.pad_cache(cfg, cache, prompt + 8)
        return api.decode_step(params, cache, tokens[:, -1:], cfg)[1]

    step, r_step = routed(absorbed)
    whole, r_whole = routed(lambda: api.prefill(params, tokens, cfg)[1])
    n_moe = cfg.n_layers - cfg.first_k_dense
    agree, total = route_agreement(r_step[-n_moe:], [r[:, -1:] for r in r_whole])
    label = f"{cfg.name} {cfg.dtype} ({cfg.n_layers} layers) absorbed vs expanded"
    err = normwise_error([step], [whole], cfg, label)
    gated = agree == total
    if gated and err > tol:
        raise AssertionError(f"{label}: normwise logit error {err} > {tol}")
    log(f"logits {label}: the decode step of token {prompt + 1} after a {prompt}-token "
        f"prefill vs the last logits of a {prompt + 1}-token prefill, normwise rel err "
        f"{err:.3e} ({'tol ' + str(tol) if gated else 'not gated'}); the last token "
        f"routes alike in {agree} of {total} MoE layers")
    return {"absorbed_vs_expanded": err, "gated": gated, "routes_agree": agree,
            "moe_layers": total}


def expected_launches(cfg, n_prefill: int, n_decode: int) -> dict[str, int]:
    """Each kernel's launches in a serve run of ``cfg``'s family: one RMSNorm
    per norm of each forward (dense, moe and vlm 2 per layer + final, hymba
    and MLA 4 per layer + final, whisper none: its norms are LayerNorms),
    attention per layer (K2 at a prefill, K3 at a decode step; whisper's
    also per encoder layer at a prefill and twice per decoder layer, self
    and cross; none for MLA, whose attention is plain), K5 per hymba layer
    and K6 per RWKV layer of every forward; 0 elsewhere."""
    from repro_torch import kernels
    n_layers, fwd = cfg.n_layers, n_prefill + n_decode
    expect = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    if cfg.family in ("dense", "moe", "hybrid", "vlm"):
        norms = 4 if cfg.family == "hybrid" else 2
        expect.update(rmsnorm=(norms * n_layers + 1) * fwd,
                      flash_attention=n_layers * n_prefill,
                      decode_attention=n_layers * n_decode)
    if cfg.family == "encdec":
        expect.update(flash_attention=(cfg.n_enc_layers + 2 * n_layers) * n_prefill,
                      decode_attention=2 * n_layers * n_decode)
    if cfg.family == "mla_moe":
        expect["rmsnorm"] = (4 * n_layers + 1) * fwd
    if cfg.family == "hybrid":
        expect["ssm_scan"] = n_layers * fwd
    if cfg.family == "rwkv":
        expect["wkv6"] = n_layers * fwd
    return expect


def serve(cfg, params, dev) -> tuple:
    """A main path: ServingEngine on azure_code requests, controller on, with
    every kernel's launches counted from 0 and checked exactly; its telemetry
    spilled into a store every ``ENGINE_DRAIN_S`` of engine time and the
    store checked and priced on the card (:func:`check_engine_store`)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.telemetry import TelemetryStore, analyze_job
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

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=scratch)
    store = TelemetryStore(tmp.name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stats = engine.run(trace, prompts, store=store, drain_every_s=ENGINE_DRAIN_S)
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
    if len(engine.sampler.frame()):
        raise AssertionError("the sampler kept rows after its last spill")
    with tmp:
        spill = check_engine_store(store, dev, cfg.name)
        frame = store.read_all()
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
        "spill": spill,
    }
    log(f"serve {cfg.name} " + json.dumps(result))
    return result, engine


def check_engine_store(store, dev, name: str) -> dict:
    """The serve run's spilled telemetry: at least 3 shards, timestamps 1 s
    apart, one job (id 1); ``analyze_store`` over the shards against
    ``analyze_job`` on their concatenation (time per state exact, energy
    within 1e-9); and the store priced on the card (:func:`price_store`)."""
    import numpy as np
    from repro_torch.telemetry import analyze_job, analyze_store

    shards = len(store.manifest["shards"])
    frame = store.read_all()
    if shards < 3:
        raise AssertionError(f"{name}: {shards} shards, want >= 3")
    if not (np.diff(frame["timestamp"]) == 1.0).all() or not (frame["job_id"] == 1).all():
        raise AssertionError(f"{name}: spilled rows are not one job at 1 s")
    fleet = analyze_store(store, min_job_duration_s=0.0)
    job = analyze_job(frame, job_id=1)
    if len(fleet.jobs) != 1:
        raise AssertionError(f"{name}: {len(fleet.jobs)} jobs in the store")
    for state, t in job.breakdown.time_s.items():
        e, got_e = job.breakdown.energy_j[state], fleet.fleet.energy_j[state]
        if fleet.fleet.time_s[state] != t or abs(got_e - e) > WHATIF_RTOL * (1 + abs(e)):
            raise AssertionError(f"{name}: analyze_store {state}: {fleet.fleet.time_s[state]} s "
                                 f"{got_e} J, analyze_job {t} s {e} J")
    result = {"shards": shards, "rows": len(frame),
              "exec_idle_time_fraction": fleet.in_execution_time_fraction,
              **price_store(store, dev, f"{name} serve store")}
    log(f"spill {name}: {result['rows']} rows in {shards} shards (every "
        f"{ENGINE_DRAIN_S:.0f} s of engine time), 1 s apart, job 1; analyze_store == "
        f"analyze_job on the concatenation (time exact, energy within {WHATIF_RTOL})")
    return result


def price_store(store, dev, label: str) -> dict:
    """``run_sweep`` of the dense 200-config grid over a spilled store on
    the card (torch backend: K4, K7) against the NumPy oracle on the same
    store, under the what-if contract (:func:`compare_frontier`). Every job
    is kept (``min_job_duration_s=0``): these stores hold single jobs
    shorter than the default 2-hour filter, which would drop them all.
    Returns the card run's time and its kernel launches, counted from 0."""
    import torch
    from repro_torch import kernels
    from repro_torch.whatif import default_policy_grid, run_sweep

    grid = default_policy_grid()
    kw = dict(min_job_duration_s=0.0)
    oracle = run_sweep(store, grid, backend="numpy", **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    front = run_sweep(store, grid, device=str(dev), **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if launches["cap_bucket_scan"] <= 0 or launches["downscale_replay"] <= 0:
        raise AssertionError(f"{label}: run_sweep did not launch K4 and K7: {launches}")
    worst = compare_frontier(oracle, front, label)
    log(f"what-if {label}: run_sweep of {len(grid)} configs ({front.n_rows} rows, "
        f"{front.n_jobs} jobs at min_job_duration_s=0, {front.n_runs} IR runs) on the "
        f"card == numpy oracle (counts exact, the same Pareto flags, worst share of the "
        f"1e-9 limit {worst['limit_share']:.3g}); {card_s:.3f} s; K4 "
        f"{launches['cap_bucket_scan']} and K7 {launches['downscale_replay']} launches")
    return {"run_sweep_s": card_s, "n_rows": front.n_rows, "n_jobs": front.n_jobs,
            "n_runs": front.n_runs, "worst_limit_share": worst["limit_share"],
            "launches": launches}


def leaves(tree):
    """The tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def count_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def serve_model(name: str, dev) -> dict:
    """One model at full width (depth cut as :data:`SERVE_DEPTH` says):
    first the f32 check (two layers, or :data:`F32_DEPTH`'s whole groups
    and stacks), its parameters freed before the bf16 model is made; then
    parameters made on the card from a seed, the bf16 logit checks at full
    depth, the serve run, the replayed and eager decode steps timed and
    profiled, and the lockstep check of the engine's graphs. MLA's f32
    check also holds its absorbed decode to its expanded prefill
    (:func:`absorbed_vs_expanded`). The VLM's
    logit checks run on gates redrawn from a seed (:func:`open_gates`); its
    serve run on the reference's zero gates. Frees the model before it
    returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(name), **SERVE_DEPTH.get(name, {}))
    prompt = LOGITS_PROMPT[name]
    checks = {}
    cfg32 = dataclasses.replace(cfg, dtype="float32", **F32_DEPTH.get(name, dict(n_layers=2)))
    params32 = api.init_params(torch.Generator(device=dev).manual_seed(4), cfg32)
    open_gates(cfg32, params32, dev)
    checks["logits_f32_2_layers"] = compare_logits(
        cfg32, params32, dev, LOGITS_F32_TOL,
        f"{name} widths f32 ({cfg32.n_layers} layers)", prompt)
    if cfg.is_mla:
        checks["absorbed_vs_expanded_f32"] = absorbed_vs_expanded(
            cfg32, params32, dev, LOGITS_F32_TOL, prompt)
    del params32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    log(f"{name}: {count_params(params) / 1e9:.3f} B parameters in bf16 "
        f"({count_bytes(params) / 1e9:.2f} GB), {cfg.n_layers} layers"
        + (f" (cut from {get_config(name).n_layers})" if name in SERVE_DEPTH else "")
        + f", made on the card in {time.perf_counter() - t0:.1f} s")
    if cfg.family == "vlm":
        closed = {k: params["cross_layers"][k].clone() for k in ("gate_attn", "gate_mlp")}
        open_gates(cfg, params, dev)
    if cfg.family == "rwkv":
        checks["logits_bf16"] = rwkv_logits(cfg, params, dev, prompt)
        checks["layers_bf16"] = rwkv_layers_check(cfg, params, dev, LOGITS_BF16_TOL, prompt)
    elif cfg.is_moe:
        checks["logits_bf16"] = moe_logits(cfg, params, dev, LOGITS_BF16_TOL, prompt)
        checks["layers_bf16"] = moe_layers_check(cfg, params, dev, LOGITS_BF16_TOL, prompt)
    else:
        checks["logits_bf16"] = compare_logits(cfg, params, dev, LOGITS_BF16_TOL,
                                               f"{name} bf16 ({cfg.n_layers} layers)", prompt,
                                               floor=cfg.family == "hybrid")
    if cfg.family == "vlm":
        for k, gate in closed.items():
            params["cross_layers"][k].copy_(gate)

    result, engine = serve(cfg, params, dev)
    result["decode_step"] = decode_step_times(engine, result["mean_decode_step_ms"])
    result["lockstep"] = lockstep(engine, SERVE_MAX_SEQ[name] - 4)
    result["checks"] = checks
    del params, engine
    gc.collect()                        # the next model may need the whole card
    torch.cuda.empty_cache()
    return result


def dense_logits(name: str, dev) -> dict:
    """A dense config that is not served: parameters made on the card from a
    seed at full width, kernel path against plain path in bf16 (the
    end-to-end 5e-2 gate), freed before it returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(name)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"{name}: {n_params / 1e9:.3f} B parameters in bf16 "
        f"({count_bytes(params) / 1e9:.2f} GB), made on the card")
    err = compare_logits(cfg, params, dev, LOGITS_BF16_TOL,
                         f"{name} bf16 ({cfg.n_layers} layers)", LOGITS_PROMPT["llama-13b"])
    del params
    torch.cuda.empty_cache()
    return {"params": n_params, "kernel_vs_plain": err}


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
# the pool DES (host) and its spilled telemetry (card)
# --------------------------------------------------------------------------- #
def pool(dev) -> dict:
    """§5.1's load-imbalance experiment through the port's pool DES: the
    balanced, 4-active and 2-active policies on ``POOL_DEPLOYMENT``, with
    the paper's Llama-13B-on-L40S calibration (``LLAMA13B_L40S``): host
    arithmetic, not a measurement of this card. The 2-active run again with
    its telemetry spilled every ``POOL_DRAIN_S`` into a store, held to the
    monolithic run (the same rows, energy and latencies) and priced on the
    card (:func:`price_store`)."""
    from repro_torch.core.imbalance import PoolConfig, PoolPolicy
    from repro_torch.core.power_model import get_platform
    from repro_torch.serving.des import simulate_pool
    from repro_torch.serving.perf_model import LLAMA13B_L40S
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.traces import TRACES, generate_trace

    dep = POOL_DEPLOYMENT
    base = TRACES["azure_code"]
    spec = dataclasses.replace(base, gap_median_s=base.gap_median_s * dep["gap_scale"])
    trace = generate_trace(spec, dep["duration_s"], n_devices=dep["n_devices"],
                           seed=dep["seed"])
    perf = dataclasses.replace(LLAMA13B_L40S, busy_util=spec.busy_util)
    plat = get_platform("l40s")

    def run(policy: str, n_active: int, **kw):
        cfg = PoolConfig(n_devices=dep["n_devices"], policy=PoolPolicy(policy),
                         n_active=n_active, park_inactive=False,
                         spill_every=dep["spill_every"])
        return simulate_pool([dataclasses.replace(r) for r in trace], plat, perf, cfg,
                             dep["duration_s"], tick_s=dep["tick_s"], **kw)

    t0 = time.perf_counter()
    runs = {label: run(policy, n) for label, policy, n in POOL_POLICIES}
    host_s = time.perf_counter() - t0
    ref = runs["8active"]
    summary = {label: {"energy_j": r.energy_j, "energy_ratio": r.energy_j / ref.energy_j,
                       "p95_s": r.latency.p95_s,
                       "p95_increase": r.latency.p95_s / ref.latency.p95_s - 1.0,
                       "completed": r.latency.n, "avg_power_w": r.avg_power_w}
               for label, r in runs.items()}
    if any(r.latency.n < 0.99 * len(trace) for r in runs.values()):
        raise AssertionError(f"pool: requests left unserved: {summary}")
    log(f"pool DES {dep} ({len(trace)} requests; L40S-calibrated: the paper's "
        f"Llama-13B-on-L40S operating point, host arithmetic, not this card), 3 policies "
        f"in {host_s:.2f} s on the host: " + "; ".join(
            f"{label} energy x{v['energy_ratio']:.4f}, p95 {v['p95_s']:.3f} s "
            f"({v['p95_increase']:+.1%}), {v['completed']} served"
            for label, v in summary.items()))

    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        store = TelemetryStore(d)
        spilled = run("consolidated", 2, store=store, drain_every_s=POOL_DRAIN_S)
        mono = runs["2active"]
        back = store.read_all()
        if len(spilled.telemetry) or len(back) != len(mono.telemetry):
            raise AssertionError(f"pool spill: {len(back)} rows, monolithic "
                                 f"{len(mono.telemetry)}")
        for col in mono.telemetry.columns:
            a, b = back[col], mono.telemetry[col]
            if a.dtype != b.dtype or not np_equal(a, b):
                raise AssertionError(f"pool spill: column {col} differs from the monolithic run")
        if (spilled.energy_j, spilled.latency) != (mono.energy_j, mono.latency):
            raise AssertionError("pool spill: energy or latencies differ from the monolithic run")
        shards = len(store.manifest["shards"])
        log(f"pool spill 2active: {len(back)} rows in {shards} shards (every "
            f"{POOL_DRAIN_S:.0f} s of simulated time) == the monolithic run's telemetry, "
            f"energy and latencies")
        priced = price_store(store, dev, "pool 2-active store")
    return {"deployment": dep, "requests": len(trace), "host_s": host_s,
            "policies": summary, "spill_shards": shards, "spill_rows": len(back),
            "priced": priced, "launches": priced["launches"]}


def np_equal(a, b) -> bool:
    import numpy as np
    return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))


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


def after_read_ms(fn, flush, pattern: str, iters: int = 20, attempts: int = 3) -> float:
    """Card ms a launch of the kernels matching ``pattern`` that ``fn``
    runs, each call after a read of ``flush`` (past the L2, so ``fn``'s
    inputs come from HBM, as in ``evaluate``): profiled over ``iters``
    calls after as many under the profiler's warm-up step, the mean over
    the launches the profile kept. The profiler can lose records, a few or
    most of them: a profile that kept half of the calls' launches or fewer
    is taken again, up to ``attempts`` profiles in all, and each retry is
    logged; more launches than calls is a fault at once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    kept = []
    for _ in range(attempts):
        steps = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
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
        if n > iters:
            raise AssertionError(f"after_read_ms: {n} launches matching {pattern!r} in the "
                                 f"profile of {iters} calls")
        if n > iters // 2:
            return sum(e.self_device_time_total for e in hits) / 1e3 / n
        kept.append(n)
        log(f"after_read_ms: the profile of {iters} calls kept {n} launches matching "
            f"{pattern!r}; profiling again")
    raise AssertionError(f"after_read_ms: {kept} launches matching {pattern!r} in "
                         f"{attempts} profiles of {iters} calls each")


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


def pareto_flags_broadcast(saved, penalty, rows: int = 1024) -> list[bool]:
    """The pairwise loop's flags by NumPy broadcasting, ``rows`` outcomes
    against all at a time: j dominates i where s_j >= s_i and p_j <= p_i,
    one of them strictly (never i itself). The yardstick of ``pareto_flags``
    on a whole grid, which the Python loop takes too long for."""
    import numpy as np

    s, p = np.asarray(saved, dtype=float), np.asarray(penalty, dtype=float)
    flags = []
    for i in range(0, len(s), rows):
        si, pi = s[i:i + rows, None], p[i:i + rows, None]
        dominated = ((s >= si) & (p <= pi) & ((s > si) | (p < pi))).any(axis=1)
        flags += [not d for d in dominated.tolist()]
    return flags


#: outcomes of the 10^4 grid the pairwise Python loop is timed on (it is
#: O(n²): 13.8 s for all 10^4 on a slow host of an H100 machine)
PARETO_LOOP_POINTS = 2000


def pareto_times(outcomes) -> dict:
    """``pareto_flags`` on the 10^4 grid's outcomes, timed, against the
    pairwise comparison by broadcasting over all of them: the same flags.
    The pairwise Python loop it replaced, timed on the first
    :data:`PARETO_LOOP_POINTS` outcomes beside ``pareto_flags`` on the same
    ones: the same flags there too."""
    from repro_torch.whatif import pareto_flags

    saved = [o.energy_saved_j for o in outcomes]
    penalty = [o.penalty_s for o in outcomes]
    t0 = time.perf_counter()
    new = pareto_flags(saved, penalty)
    new_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = pareto_flags_broadcast(saved, penalty)
    whole_s = time.perf_counter() - t0
    if new != whole:
        raise AssertionError("10^4 grid: pareto_flags differs from the pairwise comparison")
    n = PARETO_LOOP_POINTS
    t0 = time.perf_counter()
    sub = pareto_flags(saved[:n], penalty[:n])
    sub_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    old = pareto_flags_pairwise(saved[:n], penalty[:n])
    old_s = time.perf_counter() - t0
    if sub != old:
        raise AssertionError(f"the 10^4 grid's first {n}: pareto_flags differs from the "
                             "pairwise loop")
    result = {"points": len(saved), "pareto": sum(new), "sort_s": new_s,
              "broadcast_s": whole_s, "loop_points": n, "loop_pareto": sum(sub),
              "sort_loop_points_s": sub_s, "loop_s": old_s}
    log(f"what-if pareto_flags on the 10^4 grid ({len(saved)} points, {sum(new)} on the "
        f"front): O(n log n) {new_s * 1e3:.3f} ms, the pairwise comparison by broadcasting "
        f"{whole_s * 1e3:.1f} ms, the same flags; on its first {n} ({sum(sub)} on their "
        f"front) {sub_s * 1e3:.3f} ms against the pairwise Python loop's {old_s * 1e3:.1f} "
        f"ms, the same flags (host time)")
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
    t_whatif = time.perf_counter()
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
        dist_check = whatif_dist(dev, store, dense, kw)

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
        parts = {"fleet, the dense and 10^4 grids": time.perf_counter() - t_whatif}
        t0 = time.perf_counter()
        pareto = pareto_times(outs)
        parts["pareto_flags"], t0 = time.perf_counter() - t0, time.perf_counter()
        searched = search(dev, store, kw)
        parts["search"], t0 = time.perf_counter() - t0, time.perf_counter()
        idle = profile_evaluate(grid, store, kw)
        parts["profiled evaluate"], t0 = time.perf_counter() - t0, time.perf_counter()

        packed = B.pack_ir(get_ir(store, ir_config_for(grid)), 5, **kw)
        krows = replay_kernels(dev, grid, packed)
        parts["K4 and K7 by bucket"], t0 = time.perf_counter() - t0, time.perf_counter()
        hosted = host_paths(Path(d), store, dense, front, kw)
        parts["host paths"] = time.perf_counter() - t0
        log("what-if parts, s: " + json.dumps({k: round(v, 1) for k, v in parts.items()}))

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
        "pareto_flags": pareto, "search": searched, "host_paths": hosted,
        "dist": dist_check,
    }
    log("what-if " + json.dumps(result))
    log(f"what-if 10^4 grid: {result['configs_per_s_card']:.1f} configs/s on the card "
        f"(torch backend, {torch.cuda.get_device_name(0)}, evaluate, min of 3; the "
        f"counted run_sweep took {counted_s:.2f} s, {result['frontier_s']:.2f} s of "
        f"it the host's Pareto frontier); "
        f"{result['configs_per_s_host_numpy_sample']:.1f} configs/s on the host "
        f"(numpy backend, this machine's CPU, the {len(idx)}-config sample)")
    return result, krows


def whatif_dist(dev, store, dense, kw) -> dict:
    """``evaluate`` on the dense grid with ``dist=config_mesh(1)`` (an NCCL
    group of one rank) against the same call without it, under
    :func:`compare_outcomes`' contract; K4's and K7's launches counted from 0."""
    import torch
    from repro_torch import kernels
    from repro_torch.whatif import evaluate
    from repro_torch.whatif.backend import config_mesh

    plain = evaluate(dense, store, **kw)
    with world_of_one(dev):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = evaluate(dense, store, dist=config_mesh(1), **kw)
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    worst = compare_outcomes(plain, out, "dense grid, config_mesh(1)")
    if launches["cap_bucket_scan"] <= 0 or launches["downscale_replay"] <= 0:
        raise AssertionError(f"evaluate over config_mesh(1) did not launch K4 and K7: "
                             f"{launches}")
    log(f"distributed what-if: evaluate(dense grid, {len(dense)} configs, "
        f"dist=config_mesh(1)) over NCCL == evaluate without dist (time and count fields "
        f"exact; worst relative error per float field: {json.dumps(worst)}); {dist_s:.3f} s; "
        f"launches {launches}")
    return {"launches": launches, "s": dist_s, "worst_limit_share": worst["limit_share"]}


# --------------------------------------------------------------------------- #
# the row path and the process pool on the what-if fleet (host NumPy)
# --------------------------------------------------------------------------- #
#: the sparse grid's five row routes (``default_policy_grid(dense=False)``)
#: on the numpy backend, as the reference bench calls them; its contract
#: holds them equal bit for bit (benchmarks/whatif_bench.py:22-23)
ROW_ROUTES = (("serial", dict(batched=False)),
              ("batched", dict(compact=False)),
              ("workers2", dict(compact=False, workers=2)),
              ("workers4", dict(compact=False, workers=4)),
              ("mmap", dict(compact=False, mmap=True)))
POOL_WORKERS = 4


def pool_probe() -> dict:
    """A pool worker's view (module-level, so it pickles): its pid, the
    time to import the worker bodies' modules, whether torch is imported
    there, and whether CUDA is initialised, which it must never be: the
    workers are host NumPy and never touch the card."""
    import os
    t0 = time.perf_counter()
    import repro_torch.telemetry.pipeline  # noqa: F401
    import repro_torch.whatif.ir  # noqa: F401
    import repro_torch.whatif.sweep  # noqa: F401
    torch = sys.modules.get("torch")
    return {"pid": os.getpid(), "import_s": time.perf_counter() - t0,
            "torch_imported": torch is not None,
            "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized())}


def host_cpus() -> dict:
    import os
    return {"cpu_count": os.cpu_count(), "usable": len(os.sched_getaffinity(0))}


def counter_values(name: str, label: str | None = None) -> dict:
    """A counter family of the port's registry, by one label's value (or
    under ``None`` for an unlabelled counter)."""
    from repro_torch import obs
    fam = obs.REGISTRY.family(name)
    if fam is None:
        return {}
    out: dict = {}
    for key, m in fam.metrics.items():
        labels = dict(key)
        if name == "repro_fallbacks_total":
            if "from" not in labels:        # the zero-valued preregistration
                continue
            k = f"{labels['from']}->{labels['to']}"
        else:
            k = labels.get(label) if label else None
        out[k] = out.get(k, 0.0) + m.value
    return out


def routes_of(fn):
    """Run ``fn`` with obs on and the kernel counts at 0; return its value,
    its host-clock seconds, the kernel launches, configs by replay path,
    row-fallback configs and degradation-ladder transitions."""
    import torch
    from repro_torch import kernels, obs
    obs.reset()
    obs.enable()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        paths = counter_values("repro_replay_configs_total", "path")
        fallback_configs = counter_values("repro_replay_row_fallback_configs_total").get(None, 0.0)
        ladder = counter_values("repro_fallbacks_total")
        retries = counter_values("repro_partition_retries_total", "stage")
    finally:
        obs.disable()
        obs.reset()
    return value, {"s": wall_s, "launches": launches, "paths": paths,
                   "row_fallback_configs": fallback_configs, "fallbacks": ladder,
                   "partition_retries": retries}


#: the float fields the row path is held to the run-level replay by: the
#: reference bench's (``_frontiers_equivalent``, benchmarks/whatif_bench.py:
#: 116-137) and the two execution-idle fractions. ``energy_saved_j``, a
#: difference of two ~9e7-J fleet totals, is held through them (the bench
#: leaves it out); its gap beside the baseline energy is reported
ROWS_VS_IR_CLOSE = ("baseline_energy_j", "counterfactual_energy_j", "penalty_s",
                    "saved_fraction", "penalty_fraction",
                    "exec_idle_energy_fraction_baseline", "exec_idle_energy_fraction_cf")


def compare_rows_to_ir(rows, ir, label: str) -> dict:
    """The reference bench's contract between the row path and the run-level
    replay: time, count and Pareto fields exact, the float fields of
    :data:`ROWS_VS_IR_CLOSE` and the per-job CDFs within rtol = atol = 1e-9. Returns the worst element's
    share of its limit and the largest ``energy_saved_j`` gap beside the
    fleet's baseline energy."""
    import numpy as np
    if len(rows.outcomes) != len(ir.outcomes) or rows.n_rows != ir.n_rows:
        raise AssertionError(f"{label}: {len(rows.outcomes)} outcomes over "
                             f"{rows.n_rows} rows, want {len(ir.outcomes)} over {ir.n_rows}")
    share, saved_gap = 0.0, 0.0
    for a, b in zip(rows.outcomes, ir.outcomes):
        for f in WHATIF_EXACT + ("pareto",):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{label}: {a.name} {a.params} {f}: "
                                     f"{getattr(b, f)} != {getattr(a, f)}")
        for f in ROWS_VS_IR_CLOSE + ("per_job_saved_fraction", "per_job_penalty_s"):
            x = np.atleast_1d(np.asarray(getattr(a, f), dtype=np.float64))
            y = np.atleast_1d(np.asarray(getattr(b, f), dtype=np.float64))
            s = np.abs(y - x) / (WHATIF_RTOL + WHATIF_RTOL * np.abs(x))
            if x.shape != y.shape or not (s <= 1.0).all():
                raise AssertionError(f"{label}: {a.name} {a.params} {f} beyond 1e-9")
            share = max(share, float(s.max(initial=0.0)))
        saved_gap = max(saved_gap, abs(a.energy_saved_j - b.energy_saved_j)
                        / a.baseline_energy_j)
    return {"limit_share": share, "energy_saved_gap_of_baseline": saved_gap}


def row_routes(store, dense, front, kw) -> dict:
    """The sparse grid five ways on rows, equal bit for bit; the dense grid
    on rows against the torch replay of the main phase."""
    from repro_torch.whatif import default_policy_grid, frontier_to_dict, run_sweep

    sparse = default_policy_grid(dense=False)
    out, want = {}, None
    for name, args in ROW_ROUTES:
        frontier, info = routes_of(lambda a=args: run_sweep(store, sparse, backend="numpy",
                                                            **a, **kw))
        path = "row_batched" if args.get("batched", True) else "row_serial"
        if info["paths"] != {path: float(len(sparse))} or any(info["launches"].values()):
            raise AssertionError(f"rows {name}: paths {info['paths']}, launches "
                                 f"{info['launches']}")
        got = frontier_to_dict(frontier)
        if want is None:
            want, witness = got, frontier
        elif got != want:
            raise AssertionError(f"rows {name}: frontier differs from the serial route's")
        out[name] = {"s": info["s"], "configs_per_s": len(sparse) / info["s"]}
    dense_rows, info = routes_of(lambda: run_sweep(store, dense, compact=False, **kw))
    if dense_rows.n_rows != front.n_rows or any(info["launches"].values()):
        raise AssertionError(f"rows dense: {dense_rows.n_rows} rows, launches "
                             f"{info['launches']}")
    worst = compare_rows_to_ir(dense_rows, front, "dense grid rows vs card")
    out["dense_rows"] = {"s": info["s"], "configs_per_s": len(dense) / info["s"],
                         "worst_vs_card": worst}
    cpus = host_cpus()
    log("rows sparse grid (48 configs, numpy backend): serial, batched, workers 2 and 4, "
        "mmap equal bit for bit; configs/s by host clock " + ", ".join(
            f"{k} {v['configs_per_s']:.2f} ({v['s']:.2f} s)" for k, v in out.items()
            if k != "dense_rows") + f"; dense grid on rows {out['dense_rows']['configs_per_s']:.2f}"
        f" configs/s ({out['dense_rows']['s']:.2f} s) == the card's replay under the "
        f"reference bench's contract (times, counts and Pareto flags exact, its floats "
        f"within 1e-9, worst {worst['limit_share']:.3g} of the limit; energy_saved_j within "
        f"{worst['energy_saved_gap_of_baseline']:.3g} of the baseline energy); host {cpus}")
    return {"routes": out, "host": cpus, "witness": witness}


def non_ir_configs():
    """Configs the run-level IR cannot carry: a downscale-then-parking
    composite (tests/test_torch_whatif.py:231) and a downscale at a
    low-activity threshold other than the grid's."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.imbalance import PoolConfig, PoolPolicy
    from repro_torch.whatif import CompositePolicy, DownscalePolicy, ParkingPolicy
    park = ParkingPolicy(pool=PoolConfig(n_devices=2, policy=PoolPolicy.CONSOLIDATED,
                                         n_active=1))
    return [CompositePolicy((DownscalePolicy(), park)),
            DownscalePolicy(config=ControllerConfig(activity_threshold=0.03,
                                                    threshold_x_s=3.0))]


def mixed_grid(store, dense, kw) -> dict:
    """The dense grid plus two configs the IR cannot carry under
    ``backend="torch"``: the IR-capable configs on the card (K4, K7), the
    two on rows, counted; every outcome the numpy backend's."""
    import dataclasses as dc
    from repro_torch.whatif import evaluate, ir_config_for, ir_supported

    grid = dense + non_ir_configs()
    n_ir = sum(ir_supported(p, ir_config_for(grid)) for p in grid)
    out, info = routes_of(lambda: evaluate(grid, store, **kw))
    if info["paths"] != {"torch": float(n_ir), "row_batched": float(len(grid) - n_ir)} \
            or info["row_fallback_configs"] != len(grid) - n_ir or n_ir != len(dense):
        raise AssertionError(f"mixed grid: paths {info['paths']}, row fallback "
                             f"{info['row_fallback_configs']}, IR-capable {n_ir}")
    if info["launches"]["cap_bucket_scan"] <= 0 or info["launches"]["downscale_replay"] <= 0:
        raise AssertionError(f"mixed grid: launches {info['launches']}")
    t0 = time.perf_counter()
    ref = evaluate(grid, store, backend="numpy", **kw)
    host_s = time.perf_counter() - t0
    worst = compare_outcomes(ref, out, "mixed grid")
    if [dc.asdict(o) for o in out[n_ir:]] != [dc.asdict(o) for o in ref[n_ir:]]:
        raise AssertionError("mixed grid: the row configs differ from the numpy backend's")
    log(f"mixed grid ({len(grid)} configs, {n_ir} on the card, {len(grid) - n_ir} on rows, "
        f"as counted): {info['s']:.2f} s by host clock, K4 "
        f"{info['launches']['cap_bucket_scan']} and K7 {info['launches']['downscale_replay']} "
        f"launches; == the numpy backend ({host_s:.2f} s; the row configs bit for bit, "
        f"worst {worst['limit_share']:.3g} of the limit)")
    return {"configs": len(grid), "ir_capable": n_ir, **info, "numpy_s": host_s,
            "worst_limit_share": worst["limit_share"]}


def irregular_store(root: Path, dense, kw) -> dict:
    """A fleet with one job-attributed sample dropped: the IR cannot compact
    it, so the torch backend replays it on rows, with one ``compact -> row``
    fallback and no kernel launch, to the numpy backend's answer."""
    import numpy as np
    from repro_torch.cluster import generate_cluster
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.telemetry.records import TelemetryFrame
    from repro_torch.whatif import frontier_to_dict, run_sweep
    from repro_torch.whatif import ir as ir_mod

    frame = generate_cluster(n_devices=8, horizon_s=3600, seed=3).frame
    keep = np.ones(len(frame), dtype=bool)
    keep[int(np.flatnonzero(frame["job_id"] >= 0)[100])] = False
    store = TelemetryStore(root / "irregular")
    store.write_shard(TelemetryFrame({k: v[keep] for k, v in frame.columns.items()}),
                      host="h0")
    ir_mod._IR_UNSUPPORTED.clear()
    out, info = routes_of(lambda: run_sweep(store, dense, **kw))
    if info["fallbacks"] != {"compact->row": 1.0} or any(info["launches"].values()) \
            or info["paths"] != {"row_batched": float(len(dense))}:
        raise AssertionError(f"irregular store: {info}")
    ref = run_sweep(store, dense, backend="numpy", **kw)
    if frontier_to_dict(out) != frontier_to_dict(ref):
        raise AssertionError("irregular store: frontier differs from the numpy backend's")
    log(f"irregular store ({store.total_rows} rows, one sample dropped): one compact -> row "
        f"fallback, {len(dense)} configs on rows, no kernel launch, == the numpy backend bit "
        f"for bit ({info['s']:.2f} s)")
    return {"rows": store.total_rows, **info}


def ir_differences(a, b) -> list[str]:
    """What differs between two run-level IRs of one store: counts, stream
    keys, each stream's scalars and run tables, and the per-chunk
    unattributed pairs as a multiset (their order follows the partitions;
    every consumer sums them with ``math.fsum``, which is exact)."""
    import numpy as np
    out = [f for f in ("source_rows", "source_shards", "n_runs", "n_rows")
           if getattr(a, f) != getattr(b, f)]
    if list(a.streams) != list(b.streams):
        return out + ["stream keys"]
    for k in a.streams:
        x, y = a.streams[k], b.streams[k]
        out += [f"{k} {f}" for f in ("host_label", "platform_id", "ts_first", "dt_s")
                if getattr(x, f) != getattr(y, f)]
        out += [f"{k} {f}" for f in ("state", "low", "length", "power_sum", "power")
                if not np.array_equal(getattr(x, f), getattr(y, f))]
    if sorted(a.unattributed) != sorted(b.unattributed):
        out.append("unattributed pairs")
    return out


def analysis_key(a) -> tuple:
    return (a.fleet, a.unattributed_energy_j, a.n_intervals,
            [(j.job_id, j.duration_s, j.breakdown, tuple(j.intervals)) for j in a.jobs])


def process_pool(root: Path, store, dense, front, rows_witness, kw) -> dict:
    """The pool on the what-if fleet: its start-up (workers import no
    torch), ``build_ir`` and ``analyze_store`` at 4 workers against 1, the
    torch sweep on the pool-built IR against the main phase's, and a sweep
    whose first worker a fault plan crashes, retried to the answer."""
    from repro_torch.telemetry import FaultTolerance, analyze_store
    from repro_torch.telemetry.pipeline import run_supervised
    from repro_torch.testing import faults
    from repro_torch.whatif import (build_ir, default_policy_grid, frontier_to_dict,
                                    ir_config_for, run_sweep)

    starts = []
    for _ in range(2):
        t0 = time.perf_counter()
        probes = run_supervised(pool_probe, [()] * POOL_WORKERS, stage="probe")
        starts.append(time.perf_counter() - t0)
        if any(p["cuda_initialized"] for p in probes):
            raise AssertionError(f"pool probe: a worker initialised CUDA: {probes}")
    cfg = ir_config_for(dense)
    t0 = time.perf_counter()
    ir1 = build_ir(store, cfg, workers=1)
    build1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ir4 = build_ir(store, cfg, workers=POOL_WORKERS)
    build4_s = time.perf_counter() - t0
    diff = ir_differences(ir1, ir4)
    if diff:
        raise AssertionError(f"pool: build_ir(workers=4) differs from workers=1: {diff[:8]}")
    t0 = time.perf_counter()
    a1 = analyze_store(store, compact=False, **kw)
    analyze1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    a4 = analyze_store(store, compact=False, workers=POOL_WORKERS, **kw)
    analyze4_s = time.perf_counter() - t0
    if analysis_key(a1) != analysis_key(a4):
        raise AssertionError("pool: analyze_store(workers=4) differs from workers=1")
    swept, info = routes_of(lambda: run_sweep(store, dense, ir=ir4, **kw))
    if frontier_to_dict(swept) != frontier_to_dict(front) or \
            info["launches"]["cap_bucket_scan"] <= 0 or info["launches"]["downscale_replay"] <= 0:
        raise AssertionError(f"pool: the torch sweep on the pool-built IR differs from the "
                             f"main phase's, or launched {info['launches']}")
    sparse = default_policy_grid(dense=False)
    with faults.plan(root / "plan", crash=("sweep",)):
        crashed, crash_info = routes_of(lambda: run_sweep(
            store, sparse, compact=False, workers=POOL_WORKERS,
            fault=FaultTolerance(max_retries=2, backoff_s=0.01), **kw))
    retries = crash_info["partition_retries"].get("sweep", 0.0)
    if frontier_to_dict(crashed) != frontier_to_dict(rows_witness) or retries < 1 \
            or "pool->in_process" in crash_info["fallbacks"]:
        raise AssertionError(f"pool crash: retries {retries}, fallbacks "
                             f"{crash_info['fallbacks']}")
    result = {"workers": POOL_WORKERS, "start_s": starts,
              "worker_import_s": max(p["import_s"] for p in probes),
              "worker_torch_imported": any(p["torch_imported"] for p in probes),
              "build_ir_s": {"1": build1_s, "4": build4_s},
              "analyze_store_rows_s": {"1": analyze1_s, "4": analyze4_s},
              "sweep_on_pool_ir": info, "crash": {"retries": retries, "s": crash_info["s"]},
              "host": host_cpus()}
    log(f"pool ({POOL_WORKERS} workers, forkserver): start {starts[0]:.2f} s the first, "
        f"{starts[1]:.2f} s the next (workers import the host modules in "
        f"{result['worker_import_s']:.3f} s; torch imported there: "
        f"{result['worker_torch_imported']}; CUDA initialised: no); build_ir {build1_s:.2f} s at 1 "
        f"worker, {build4_s:.2f} s at 4, the same IR; analyze_store on rows {analyze1_s:.2f}"
        f" / {analyze4_s:.2f} s, the same analysis; the torch sweep on the pool-built IR == "
        f"the main phase's bit for bit; a crashed worker retried {retries:.0f} time(s) to the "
        f"same frontier ({crash_info['s']:.2f} s); host {result['host']}")
    return result


def host_paths(root: Path, store, dense, front, kw) -> dict:
    """The row path, the torch backend's routing and the process pool, on
    the what-if fleet's store."""
    t0 = time.perf_counter()
    rows = row_routes(store, dense, front, kw)
    mixed = mixed_grid(store, dense, kw)
    irregular = irregular_store(root, dense, kw)
    pool_ = process_pool(root, store, dense, front, rows.pop("witness"), kw)
    phase_s = time.perf_counter() - t0
    log(f"rows, routing and pool phases: {phase_s:.1f} s")
    launches: dict[str, int] = {}
    for counts in (mixed["launches"], pool_["sweep_on_pool_ir"]["launches"]):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    return {"rows": rows, "mixed": mixed, "irregular": irregular, "pool": pool_,
            "launches": launches, "phase_s": phase_s}


# --------------------------------------------------------------------------- #
# live phase: the controller's tick loop on the card
# --------------------------------------------------------------------------- #
#: the reference benchmark's live deployment (benchmarks/live_bench.py:59-69),
#: 10^4 streams, 120,000 rows a shard
LIVE_DEPLOYMENT = dict(n_streams=10_000, window_s=60, dt_s=5.0)
LIVE_WINDOWS = 2                   # one tick each, then a backlog of 2 in one tick
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
    """The reference benchmark's live deployment on the card: 2 windows of
    10^4 streams, one tick each, then a 2-window backlog in one tick, each
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
            != {"StreamOrderError"}:
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


#: the reference bench's own settings (benchmarks/live_bench.py:40-44,
#: :59-69): no dt_s or job-filter override, so the IR refuses the 5-second
#: samples at the default dt_s = 1 and every config replays on rows; the
#: first window and one steady one (a third tick on rows, which re-read the
#: whole store each round, would take the phase past a minute)
LIVE_BENCH_WINDOWS = 2


def live_bench(dev, root: Path) -> dict:
    """The reference live bench at its own settings on the card's
    controller: 10^4 streams, ``LiveConfig(max_evals=24)``, one round over
    the downscale family, the replay's defaults. Each tick refreshes on
    ``warm_torch`` with its configs on rows, as counted, and no kernel
    launch; staleness first and steady."""
    import torch
    from repro_torch import kernels
    from repro_torch.live import LiveConfig, LiveController, SyntheticProducer
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif.search import default_families

    fams = [f for f in default_families(composites=False) if f.name == "downscale"]
    cfg = LiveConfig(max_evals=LIVE_EVALS, search_kwargs={"max_rounds": 1, "families": fams})
    store = TelemetryStore(root / "bench")
    prod = SyntheticProducer(store, **LIVE_DEPLOYMENT)
    ctrl = LiveController(store, root / "bench_ckpt.json", cfg)
    ticks = []
    for w in range(LIVE_BENCH_WINDOWS):
        prod.step()
        before = (counter_values("repro_replay_configs_total", "path"),
                  counter_values("repro_fallbacks_total"), kernels.launch_counts())
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = ctrl.tick()
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
        after = (counter_values("repro_replay_configs_total", "path"),
                 counter_values("repro_fallbacks_total"), kernels.launch_counts())
        paths, ladder, launches = ({k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
                                   for b, a in zip(before, after))
        if r.result != "refreshed" or r.rung != "warm_torch" or \
                set(paths) != {"row_batched"} or set(ladder) != {"compact->row"} or launches:
            raise AssertionError(f"live bench window {w}: {r.result} on {r.rung} ({r.error}); "
                                 f"paths {paths}, fallbacks {ladder}, launches {launches}")
        if ctrl.frontier.n_rows != store.total_rows:
            raise AssertionError(f"live bench window {w}: {ctrl.frontier.n_rows} rows "
                                 f"replayed of {store.total_rows}")
        ticks.append({"tick": r.tick, "staleness_s": r.staleness_s, "tick_s": wall_s,
                      "configs_on_rows": paths["row_batched"],
                      "compact_to_row": ladder["compact->row"],
                      "rows": store.total_rows, "n_jobs": ctrl.frontier.n_jobs})
    result = {"deployment": LIVE_DEPLOYMENT, "max_evals": LIVE_EVALS, "ticks": ticks,
              "staleness_s_first": ticks[0]["staleness_s"],
              "staleness_s_steady": ticks[-1]["staleness_s"]}
    log("live bench " + json.dumps(result))
    log(f"live bench settings ({LIVE_DEPLOYMENT['n_streams']} streams, dt_s 1, 2-hour job "
        f"filter, {LIVE_EVALS} evaluations): {len(ticks)} ticks refreshed on warm_torch, "
        f"configs on rows {[t['configs_on_rows'] for t in ticks]} (compact -> row "
        f"{[t['compact_to_row'] for t in ticks]}), no kernel launch; staleness first "
        f"{ticks[0]['staleness_s']:.3f} s, steady {ticks[-1]['staleness_s']:.3f} s")
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
            parts, t0 = {}, time.perf_counter()
            fleet = live_fleet(dev, root)
            parts["fleet"], t0 = time.perf_counter() - t0, time.perf_counter()
            simulated = live_simulated(dev, root)
            parts["simulated"], t0 = time.perf_counter() - t0, time.perf_counter()
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
            bench = live_bench(dev, root)
            parts["bench"], t0 = time.perf_counter() - t0, time.perf_counter()
            crash = live_crash_resume(dev, root)
            parts["crash/resume"], t0 = time.perf_counter() - t0, time.perf_counter()
            degradation = live_degradation(dev, root)
            parts["degradation"] = time.perf_counter() - t0
            log("live parts, s: " + json.dumps({k: round(v, 1) for k, v in parts.items()}))
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
    return {"fleet": fleet, "simulated": simulated, "bench": bench, "crash_resume": crash,
            "degradation": degradation, "launches": launches, "phase_s": phase_s}


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
#: the trained model and run: the reference launcher's own example
#: (src/repro/launch/train.py:4-5) without --smoke, AdamW as for_arch picks
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_RUN = dict(steps=20, checkpoint_every=10, lr=3e-4)
TRAIN_BATCH = (8, 128)
#: K2's training cases: (B, Sq, Sk, H, KV, d, causal, window): qwen1.5-0.5b's
#: self-attention, whisper-tiny's and the VLM's cross-attention (no mask,
#: Sq != Sk), and windows with and without the causal mask (no query row
#: masked whole: there K2 and its plain version differ, and no model asks)
TRAIN_ATTN_CASES = ((8, 128, 128, 16, 16, 64, True, 0), (8, 128, 1500, 6, 6, 64, False, 0),
                    (1, 128, 1601, 64, 8, 128, False, 0), (2, 256, 256, 8, 2, 64, True, 64),
                    (2, 130, 70, 8, 2, 64, False, 64))
#: the families whose loss trains on the card, checked kernel path against
#: plain path in f32 at F32_DEPTH's depth (two layers elsewhere)
TRAIN_F32_MODELS = ("qwen1.5-0.5b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                    "whisper-tiny", "llama-3.2-vision-90b", "hymba-1.5b", "rwkv6-3b")
#: cuts memory forces on that check beyond F32_DEPTH: deepseek-v3's MoE layer
#: holds 11.3 B routed-expert parameters, 90 GB with their f32 gradients
TRAIN_F32_CUTS = {"deepseek-v3-671b": dict(n_experts=64)}
TRAIN_F32_BATCH = (1, 32)
LOSS_F32_TOL = 1e-5                # relative, the f32 loss
GRAD_F32_TOL = 1e-4                # normwise per leaf, as LOGITS_F32_TOL
#: a leaf's gradient is held against the larger of its own norm and this
#: share of the whole gradient's: qwen's key bias has a zero gradient in
#: exact arithmetic (it shifts a query's scores alike), so both paths' are
#: rounding noise
GRAD_FLOOR = 1e-4
#: leaves left out of step 0's bf16 gradient gate: qwen's key bias, whose
#: gradient is zero in exact arithmetic (as GRAD_FLOOR says), so that both
#: paths' readings there are rounding noise
ZERO_GRAD_LEAVES = ("['bk']",)
#: step 0's bf16 gradients, kernel path against plain path, at the worst
#: leaf (normwise, as GRAD_FLOOR says; ZERO_GRAD_LEAVES left out): twice the
#: chaos floor (the plain path against itself with attention in float64) at
#: the kernel path's worst leaf, ['layers']['wq'], 2.472e-2 (the kernel path
#: 3.078e-2 there; NVIDIA H100 80GB HBM3, 700 W)
TRAIN_BF16_GRAD_TOL = 4.944e-2
#: step 0's bf16 loss, kernel path against plain path, relative: five times
#: the chaos floor 4.243e-6 (the kernel path 1.076e-5, an unmasked attention
#: 1.011e-3; same card). Wider than the gradients' twice: the loss is one
#: scalar, so its floor is a single draw of the rounding, where a leaf's
#: norm sums over up to 10^8 elements
TRAIN_BF16_LOSS_TOL = 2.1e-5
#: losses of steps 11-20 restarted from the step-10 checkpoint, relative
RESUME_RTOL = 1e-3
#: the families trained after qwen, through ``Trainer`` at full width without
#: checkpoints (a save of hymba's 26 GB or rwkv's 50 GB of state would take
#: ~35 / ~65 s at qwen's 8.5-10.3 s for 7.4 GB): batch x tokens, steps, and the
#: tokens of each row step 0's check holds (hymba's plain path walks its scan
#: step by step in Python: at 2,048 tokens ~1.6 M eager ops, at 256 ~0.2 M).
#: hymba-1.5b at the length its serve run prefills, past the 1,024-token
#: window in 29 of 32 layers; rwkv6-3b and whisper-tiny at the reference
#: launcher's example (src/repro/launch/train.py:4-5), whisper with the
#: dataset's 1,500 random frames a row
#: rwkv6-3b's random-weight bf16 model is chaotic: a rounding flip in a group
#: norm of the WKV output grows through the layers, so two correct
#: computations' step-0 gradients fall 0.46 (f64 WKV) to 1.7 (the kernel path)
#: apart normwise at 32 layers and 0.03 to 0.15 at 4, though K6 is nearer
#: float64 than the plain version on the model's own inputs
#: (:func:`wkv_on_model_inputs`; NVIDIA H100 80GB HBM3, 700 W). No gate on
#: those gradients tells a right kernel from a wrong one, as none on its serve
#: logits does. Its step 0 is held instead by the loss over the trainer's first
#: ``step0_layers`` layers (at 32 a time-reversed WKV moves the loss less than
#: the floor's five times) and by the backward kernel inside the full model
#: (:func:`backward_in_model`); the full kernel path is read, not gated
TRAIN_MODELS = {"hymba-1.5b": dict(batch=2, seq=2048, steps=6, step0_tokens=256),
                "rwkv6-3b": dict(batch=8, seq=128, steps=6, step0_tokens=128, step0_layers=4),
                "whisper-tiny": dict(batch=8, seq=128, steps=10, step0_tokens=128)}
#: the models whose eager step is also profiled and split at its seams beside
#: the replayed one (qwen1.5-0.5b's too); hymba-1.5b's and rwkv6-3b's eager
#: steps, each near a second and tens of thousands of device operations, are
#: timed only, to keep the script inside its limit
EAGER_PROFILED = ("whisper-tiny",)
#: step 0's gates for those runs, from the chaos floor measured in the same
#: call, as qwen's were set from its readings: the kernel path's worst leaf
#: within this many times the floor's worst leaf (where the sequence mixer
#: runs in f32 on both paths, kernel and floor differ by rounding flips of
#: the same size, leaf by leaf at random), the loss within this many times
#: its floor; and at least qwen's TRAIN_BF16_GRAD_TOL and TRAIN_BF16_LOSS_TOL.
#: A floor can come out far below the kernel path's own rounding: the loss's
#: is one draw, and K2's Function keeps its bf16 output O for the backward's
#: rowsum(dO * O), a rounding the plain path's autograd does not make, which
#: in a shallow model (whisper-tiny's 4 + 4 layers) few roundings elsewhere
#: hide
STEP0_GRAD_FLOORS = 2.0
STEP0_LOSS_FLOORS = 5.0


def loss_and_grads(params, batch, cfg, plain: bool) -> tuple:
    """(loss, metrics as floats, gradient of every leaf in the tree's
    flattening order) of the family's loss; ``plain`` runs the plain
    versions under autograd."""
    import torch
    from repro_torch.models import api
    from repro_torch.train.tree import leaves as tree_leaves

    flat = tree_leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = api.loss_fn(params, batch, cfg, plain=plain)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return loss.item(), {k: torch.as_tensor(v).item() for k, v in metrics.items()}, list(grads)


def grad_errors(got: list, want: list, paths: list[str], skip: tuple = ()) -> dict:
    """Per leaf ||got - want|| / max(||want||, GRAD_FLOOR * ||want as a
    whole||), on the card (``got`` may lie on the host); the worst leaf
    among those whose path ends in none of ``skip``, every leaf's error,
    and the whole gradient's normwise error."""
    import torch
    total = float(torch.stack([w.float().norm() for w in want]).norm())
    worst, worst_path, diff2, leaves = 0.0, None, 0.0, {}
    for path, g, w in zip(paths, got, want):
        d = float((g.to(w.device).float() - w.float()).norm())
        diff2 += d * d
        err = leaves[path] = d / max(float(w.float().norm()), GRAD_FLOOR * total, 1e-30)
        if not err <= worst and not path.endswith(skip):
            worst, worst_path = err, path
    return {"worst_leaf": worst, "worst_path": worst_path, "leaves": leaves,
            "whole": diff2 ** 0.5 / max(total, 1e-30), "grad_norm": total}


def check_train_functions(dev) -> dict:
    """K1's and K2's autograd Functions (the training path) against autograd
    through their plain versions on the same inputs and output gradients:
    outputs and every input's gradient, bf16 per element at BF16_TOL and f32
    at F32_TOL; qwen1.5-0.5b's training shapes and :data:`TRAIN_ATTN_CASES`.
    Then the Functions' forward and backward timed eagerly at qwen's shapes in
    bf16 beside the plain version's backward."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(shape, dtype, grad=True):
        return torch.randn(shape, generator=g, device=dev).to(dtype).requires_grad_(grad)

    def check(label, fn, ins, tol):
        out = fn(*ins, plain=False)
        ref = fn(*ins, plain=True)
        dy = rnd(out.shape, out.dtype, grad=False)
        worst = check_close(f"{label} out", out.detach(), ref.detach(), tol)
        for i, (a, b) in enumerate(zip(torch.autograd.grad(out, ins, dy),
                                       torch.autograd.grad(ref, ins, dy))):
            worst = max(worst, check_close(f"{label} grad {i}", a, b, tol))
        return worst

    def norm(x, w, plain):
        return ops.rmsnorm(x, w, 1e-6, plain=plain)

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        tag = str(dtype).removeprefix("torch.")
        errs[f"rmsnorm {tag}"] = check(f"train rmsnorm {tag}", norm,
                                       (rnd((8, 128, 1024), dtype), rnd((1024,), dtype)), tol)
        for (b, sq, sk, h, kv, d, causal, window) in TRAIN_ATTN_CASES:
            def attn(q, k, v, plain, causal=causal, window=window):
                return ops.flash_attention(q, k, v, causal=causal, window=window, plain=plain)
            label = f"train flash_attention {tag} {(b, sq, sk, h, kv, d, causal, window)}"
            errs[label.removeprefix("train ")] = check(
                label, attn, (rnd((b, sq, h, d), dtype), rnd((b, sk, kv, d), dtype),
                              rnd((b, sk, kv, d), dtype)), tol)
    log(f"train functions vs plain under autograd (bf16 per element |err| <= {BF16_TOL} * "
        f"(1 + |plain|), f32 {F32_TOL}): output and input gradients, max abs err {errs}")

    times = {}
    bf = torch.bfloat16
    x, w = rnd((8, 128, 1024), bf), rnd((1024,), bf)
    q, k, v = (rnd((8, 128, 16, 64), bf) for _ in range(3))
    for name, fn, ins in (("rmsnorm", norm, (x, w)),
                          ("flash_attention", lambda q, k, v, plain: ops.flash_attention(
                              q, k, v, plain=plain), (q, k, v))):
        out, ref = fn(*ins, plain=False), fn(*ins, plain=True)
        dy = rnd(out.shape, bf, grad=False)
        times[name] = {
            "shape": [list(t.shape) for t in ins],
            "forward_ms": cuda_ms(lambda: fn(*ins, plain=False)),
            "backward_ms": cuda_ms(lambda: torch.autograd.grad(out, ins, dy, retain_graph=True)),
            "plain_forward_ms": cuda_ms(lambda: fn(*ins, plain=True)),
            "plain_backward_ms": cuda_ms(
                lambda: torch.autograd.grad(ref, ins, dy, retain_graph=True)),
        }
    log(f"time train functions (eager, CUDA events, bf16 at qwen1.5-0.5b's shapes; forward = "
        f"the kernel inside the Function, backward = RMSNorm's analytic gradient in PyTorch "
        f"ops, attention's K2′ kernels): {json.dumps(times)}")
    return {"errors": errs, "times": times, "attention_backward": time_attention_backward(dev)}


#: K2′ checked and timed at qwen1.5-0.5b's training shape and hymba-1.5b's
#: layer at its train cell's 2 x 2,048 tokens, in a 1,024-token window layer
#: and a global one: (B, S, H, KV, d, window), causal. The last is the main
#: path's shape of the kernels' summary rows
BWD_TIME_CASES = ((8, 128, 16, 16, 64, 0), (2, 2048, 25, 5, 64, 1024), (2, 2048, 25, 5, 64, 0))
#: normwise gates of K2′'s gradients, as tests/test_torch_attention_kernels.py
#: sets them: against the ops backward (f32 P and dS; the kernels round both
#: to bf16 as operands), and against their own arithmetic in PyTorch
#: (``flash_attention_backward_plain``: sums in another order)
BWD_VS_OPS_TOL = 1e-2
BWD_VS_PLAIN_TOL = 2e-3
#: the products each K2′ kernel does over the kept pairs: dQ S, dP and dS K;
#: dK/dV Sᵀ, dPᵀ, Pᵀ dO and dSᵀ Q
BWD_KERNEL_PRODUCTS = {"flash_attention_bwd_dq": 3, "flash_attention_bwd_dkv": 4}
#: each K2′ kernel's name in a profile (``repro::<name>``)
BWD_PROFILE_NAMES = {"flash_attention_bwd_dq": "flash_bwd_dq_kernel",
                     "flash_attention_bwd_dkv": "flash_bwd_dkv_kernel"}


def time_attention_backward(dev) -> dict:
    """K2′ (``flash_attention.flash_attention_backward``: the dQ kernel, then
    the dK/dV kernel) at :data:`BWD_TIME_CASES`: its gradients against the
    ops backward and its own arithmetic in PyTorch, normwise
    (:data:`BWD_VS_OPS_TOL`, :data:`BWD_VS_PLAIN_TOL`), and a second call's
    bits; the pair timed eagerly (CUDA events) and each kernel under the
    profiler, beside the bound at 989 TFLOP/s bf16 of the five products
    over the pairs the mask keeps (S, dV, dP, dQ, dK) and of the seven the
    two kernels do (S and dP in each); beside the ops backward on the same
    inputs (``ops.attention_backward_ops``, f32, every pair); and the
    launches one backward makes. Returns the cases, and at the last case
    each kernel's row for the kernels' summary (``kernels``) and its max
    abs error against the plain arithmetic (``errors``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    def normwise(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    g = torch.Generator(device=dev).manual_seed(23)
    out, rows, errors = {}, {}, {}
    for (b, s, h, kv, d, window) in BWD_TIME_CASES:
        q, do = (torch.randn((b, s, h, d), generator=g, device=dev).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=g, device=dev).bfloat16() for _ in range(2))
        hq, hk, hv, hdo = (t.transpose(1, 2) for t in (q, k, v, do))
        o, lse = fa.flash_attention_lse(hq, hk, hv, causal=True, window=window)

        def kernel():
            return fa.flash_attention_backward(hq, hk, hv, o, lse, hdo, causal=True,
                                               window=window)

        label = str((b, s, h, kv, d, window))
        before = kernels.launch_counts()
        grads = kernel()
        after = kernels.launch_counts()
        same = all(map(torch.equal, grads, kernel()))
        opsb = ops.attention_backward_ops(q, k, v, o.transpose(1, 2), do, True, window)
        vs_ops = [normwise(a.transpose(1, 2), w) for a, w in zip(grads, opsb)]
        del opsb
        plain = fa.flash_attention_backward_plain(hq, hk, hv, o, lse, hdo, causal=True,
                                                  window=window)
        vs_plain = [normwise(a, p) for a, p in zip(grads, plain)]
        abs_err = [float((a.float() - p.float()).abs().max()) for a, p in zip(grads, plain)]
        del plain
        if not (same and max(vs_ops) <= BWD_VS_OPS_TOL and max(vs_plain) <= BWD_VS_PLAIN_TOL):
            raise AssertionError(f"attention backward {label}: same bits {same}, normwise "
                                 f"(dq, dk, dv) vs ops {vs_ops}, vs plain {vs_plain}")
        pairs = attention_pairs(s, s, True, window)
        product_ms = 2 * b * h * pairs * d / BF16_FLOPS_PER_S * 1e3
        prof = profile_steps(kernel, steps=5)["repro_kernels_ms_per_step"]
        per_kernel = {n: prof.get(p) for n, p in BWD_PROFILE_NAMES.items()}
        ops_ms = cuda_ms(lambda: ops.attention_backward_ops(
            q, k, v, o.transpose(1, 2), do, True, window), iters=5, warmup=1)
        pair = timed(kernel, 20)
        out[label] = {
            "kernels_ms": pair["call_ms"], "kernels_graph_ms": pair["ms"],
            "profiled_ms": per_kernel,
            "bound_5_products_ms": 5 * product_ms, "bound_7_products_ms": 7 * product_ms,
            "ops_ms": ops_ms, "vs_ops": vs_ops, "vs_plain": vs_plain,
            "launches": {n: after[n] - before[n] for n in after if after[n] != before[n]}}
        if (b, s, h, kv, d, window) == BWD_TIME_CASES[-1]:
            n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, do, o, *grads))
            shape = f"q, dO, O {tuple(q.shape)}, k, v {tuple(k.shape)} bf16, causal"
            for name, products in BWD_KERNEL_PRODUCTS.items():
                rows[name] = dict(
                    shape=shape, kernel={"ms": per_kernel[name], "call_ms": pair["call_ms"]},
                    plain={"ms": ops_ms, "call_ms": ops_ms}, library=None,
                    bound=bound_ms(n_bytes, products * product_ms * BF16_FLOPS_PER_S / 1e3))
            errors["flash_attention_bwd_dq"] = abs_err[0]
            errors["flash_attention_bwd_dkv"] = max(abs_err[1:])
        del q, k, v, do, o, lse, grads
    torch.cuda.empty_cache()
    log(f"time attention backward (K2′ kernels vs the ops backward, bf16, causal; the pair "
        f"eager and replayed, each kernel profiled; bounds at 989 TFLOP/s over the kept "
        f"pairs; gradients normwise (dq, dk, dv) vs ops (tol {BWD_VS_OPS_TOL}) and vs plain "
        f"(tol {BWD_VS_PLAIN_TOL}), a second call the same bits; card {nvidia_smi_line()}): "
        f"{json.dumps(out)}")
    return {"cases": out, "kernels": rows, "errors": errors}


def train_family_f32(name: str, dev) -> dict:
    """One family's loss and every gradient, kernel path against plain path,
    in f32 at full width (F32_DEPTH's depth, or two layers; the cuts of
    :data:`TRAIN_F32_CUTS`), on a seeded batch; the VLM's gates opened and
    its vision random, whisper's frames random. The kernel path's gradients
    wait on the host while the plain path's are taken."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.train.tree import flatten

    cfg = dataclasses.replace(get_config(name), dtype="float32",
                              **F32_DEPTH.get(name, dict(n_layers=2)),
                              **TRAIN_F32_CUTS.get(name, {}))
    torch.cuda.reset_peak_memory_stats(dev)
    params = api.init_params(torch.Generator(device=dev).manual_seed(4), cfg)
    open_gates(cfg, params, dev)
    batch = api.make_batch(cfg, *TRAIN_F32_BATCH, torch.Generator(device=dev).manual_seed(5))
    kloss, kmetrics, kgrads = loss_and_grads(params, batch, cfg, plain=False)
    for i, grad in enumerate(kgrads):
        kgrads[i] = grad.cpu()
    ploss, pmetrics, pgrads = loss_and_grads(params, batch, cfg, plain=True)
    peak = torch.cuda.max_memory_allocated(dev)
    err = grad_errors(kgrads, pgrads, [path for path, _ in flatten(params)])
    loss_err = abs(kloss - ploss) / abs(ploss)
    metric_err = {k: abs(kmetrics[k] - v) / max(abs(v), 1e-30) for k, v in pmetrics.items()}
    n = count_params(params)
    del params, kgrads, pgrads, batch
    gc.collect()
    torch.cuda.empty_cache()
    if not (loss_err <= LOSS_F32_TOL and err["worst_leaf"] <= GRAD_F32_TOL
            and max(metric_err.values()) <= LOSS_F32_TOL):
        raise AssertionError(f"train {name} f32: kernel vs plain loss {loss_err}, metrics "
                             f"{metric_err}, gradient {err}")
    log(f"train {name} f32 ({cfg.n_layers} layers, {n / 1e9:.3f} B parameters"
        + (f", cut {TRAIN_F32_CUTS[name]}" if name in TRAIN_F32_CUTS else "")
        + f", batch {TRAIN_F32_BATCH}): loss {kloss:.6f} vs plain {ploss:.6f} (rel "
          f"{loss_err:.2e}, tol {LOSS_F32_TOL}), metrics rel {metric_err}; gradients worst "
          f"leaf {err['worst_leaf']:.3e} at {err['worst_path']} (tol {GRAD_F32_TOL}), whole "
          f"{err['whole']:.3e}; peak {peak / 2**30:.1f} GiB")
    return {"loss_rel_err": loss_err, "metrics_rel_err": metric_err, **err,
            "params": n, "peak_gib": peak / 2**30}


def train_refusals(dev) -> dict:
    """Every training-path kernel wrapper given a CUDA tensor that requires
    grad, in grad mode, raises instead of cutting the gradient: K1, K2, K5
    and K6 naming the Function that runs them with a backward
    (``RuntimeError``), K3 and the two backward kernels saying they have
    none (``NotImplementedError``)."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).requires_grad_(True)

    q = rnd(1, 2, 16, 64)
    ssm_in = (rnd(1, 3, 8), torch.rand((1, 3, 8), device=dev),
              -torch.rand((8, 16), device=dev), rnd(1, 3, 16), rnd(1, 3, 16))
    wkv_in = (q, q, q, torch.rand((1, 2, 16, 64), device=dev), rnd(2, 64))
    cases = (("rmsnorm", RuntimeError, "RMSNormFunction", lambda: rms.rmsnorm(q, rnd(64))),
             ("flash_attention", RuntimeError, "FlashAttentionFunction",
              lambda: fa.flash_attention(q, q, q)),
             ("ssm_scan", RuntimeError, "SsmScanFunction", lambda: k5.ssm_scan(*ssm_in)),
             ("wkv6", RuntimeError, "Wkv6Function", lambda: k6.wkv6(*wkv_in)),
             ("decode_attention", NotImplementedError, "decode_attention",
              lambda: da.decode_attention(q[:, :, 0], q, q, 8)),
             ("ssm_scan_bwd", NotImplementedError, "ssm_scan_backward",
              lambda: k5.ssm_scan_backward(*ssm_in, None, rnd(1, 3, 8), None)),
             ("wkv6_bwd", NotImplementedError, "wkv6_backward",
              lambda: k6.wkv6_backward(*wkv_in, None, q, None)))
    out = {}
    for name, error, names, call in cases:
        try:
            call()
        except error as e:
            if names not in str(e):
                raise AssertionError(f"{name}: the error does not name {names}: {e}")
            out[name] = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError(f"{name}: a CUDA tensor that requires grad was accepted")
    log(f"train refusals (a wrapper given a CUDA tensor that requires grad): {out}")
    return out


def attention_pairs(seq: int, keys: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head scores: all of them, the causal half, or
    the ones within ``window`` as well."""
    if not causal:
        return seq * keys
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def train_flops(cfg, batch: int, seq: int) -> dict:
    """Model FLOPs of one training step with per-layer remat: the layers'
    matrix products (2 a parameter a token) and attention (QKᵀ and PV over
    the pairs its mask keeps) run forward, again in the backward's
    recompute, and twice in the backward; the head forward and twice in the
    backward. The recompute stops at the last product whose output the
    backward needs (``torch.utils.checkpoint``'s early stop), so a layer
    whose last product is its MLP's down projection (every family but rwkv,
    whose channel mix multiplies it by a gate) does that one three times. hymba adds its Mamba projections and a window on all but its
    global layers; rwkv6 has no attention; whisper's encoder (1,500 frames,
    no mask, not rematerialised) runs forward and twice in the backward, its
    decoder adds cross-attention over the frames. ``recurrence_ops``: the
    selective scan's and the WKV recurrence's float32 work on the CUDA cores,
    per state entry and step the forward's (K5 8, K6 7) twice (the forward
    and the recompute) and the backward kernel's (K5′ 26, K6′ 15)."""
    hd = cfg.resolved_head_dim
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    tokens = batch * seq
    attn_proj = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    score = 2 * 2 * batch * cfg.n_heads * hd           # QKᵀ and PV, a pair
    recurrence = 0
    if cfg.family == "rwkv":
        ml, dl = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
        layer_params = 6 * d * d + 2 * d * f + 10 * d * ml + 2 * d * dl
        attn = 0
        recurrence = (2 * 7 + 15) * tokens * d * cfg.rwkv_head_size * L
    elif cfg.family == "hybrid":
        di, n = cfg.d_inner, cfg.ssm_state
        rank = math.ceil(d / 16)
        layer_params = (attn_proj + 3 * d * f + 2 * d * di + di * (rank + 2 * n) + rank * di
                        + di * d + cfg.conv_kernel * di)
        attn = score * sum(attention_pairs(seq, seq, True, 0 if i in cfg.global_layers
                                           else cfg.window) for i in range(L))
        recurrence = (2 * 8 + 26) * tokens * di * n * L
    elif cfg.family == "encdec":
        frames = batch * cfg.n_frames
        enc = 2 * frames * cfg.n_enc_layers * (attn_proj + 2 * d * f) + \
            score * cfg.n_enc_layers * attention_pairs(cfg.n_frames, cfg.n_frames, False, 0)
        # self-attention, the cross-attention's q and o, the MLP a token;
        # the cross-attention's k and v a frame, in every layer's recompute too
        layer_params = attn_proj + attn_proj // 2 + 2 * d * f
        attn = score * L * attention_pairs(seq, seq, True, 0) + \
            score * L * attention_pairs(seq, cfg.n_frames, False, 0) + \
            2 * frames * L * (attn_proj // 2)
    else:
        layer_params = attn_proj + 3 * d * f
        attn = score * attention_pairs(seq, seq, True, 0) * L
    layers = 2 * tokens * L * layer_params
    head = 2 * tokens * d * cfg.vocab_size
    # whisper's MLP is 4 d wide (d_ff), as the others' down projections are d_ff
    not_recomputed = 0 if cfg.family == "rwkv" else 2 * tokens * L * d * f
    flops = 4 * (layers + attn) - not_recomputed + 3 * head + \
        (3 * enc if cfg.family == "encdec" else 0)
    return {"flops": flops, "layer_matmul_params": L * layer_params,
            "recompute_flops": layers + attn - not_recomputed, "tokens": tokens,
            "recurrence_ops": recurrence}


def ssm_scan_f64(u, dt, a, b, c, h0=None, h_out=None):
    """The plain selective scan in float64, cast back to float32: a second
    correct computation of the same function, for the chaos floor."""
    from repro_torch.kernels import ref
    y, h = ref.ssm_scan_reference(u.double(), dt.double(), a.double(), b.double(),
                                  c.double(), None if h0 is None else h0.double())
    return y.float(), (h.float() if h_out is None else h_out.copy_(h))


def wkv6_reversed(r, k, v, w, u, state0=None, state_out=None):
    """The plain WKV recurrence in float32 with each y summed over k in the
    reverse order: a second correct computation in the kernel's precision,
    for the chaos floor."""
    import torch
    b, h, s, kd = r.shape
    st = (torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float())
    ys = []
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append((r[:, :, t, :, None] * (st + u[None, :, :, None] * kv)).flip(2).sum(2))
        st = w[:, :, t, :, None] * st + kv
    y = torch.stack(ys, dim=2)
    return y, (st if state_out is None else state_out.copy_(st))


def floor_mixers(cfg) -> dict[str, list]:
    """Second correct computations of the plain path's sequence mixers, by
    name, each a list of (module, attribute, replacement): all in float64
    (attention for dense, hybrid and encdec, the selective scan for hybrid,
    the WKV recurrence for rwkv); for rwkv also the WKV recurrence in float32
    summed in another order. Its y feeds a group norm over each head, where
    a sum near 0 that rounds to the other sign flips the head's output: the
    flips grow with the rounding's size, so a float64 sum, nearer exact than
    either float32 one, sees fewer than a reordering in the kernel's
    precision (rwkv6-3b's step 0, 4 layers: 2.6e-2 against the kernel path's
    0.13; NVIDIA H100 80GB HBM3)."""
    from repro_torch.kernels import flash_attention, rwkv6_scan, ssm_scan
    if cfg.family == "rwkv":
        return {"f64 WKV": [(rwkv6_scan, "wkv6_plain", wkv6_f64)],
                "f32 WKV reordered": [(rwkv6_scan, "wkv6_plain", wkv6_reversed)]}
    out = [(flash_attention, "flash_attention_plain", mha_f64)]
    if cfg.family == "hybrid":
        out.append((ssm_scan, "ssm_scan_plain", ssm_scan_f64))
    return {"f64 mixers": out}


def wrong_forward(cfg) -> tuple[list, str]:
    """A plain path that computes a wrong forward, which step 0's loss gate
    must see: attention unmasked (causal=False), or, for RWKV-6, the WKV
    recurrence run from the last token to the first (each y sees the
    future: RWKV's unmasked attention)."""
    import torch
    from repro_torch.kernels import flash_attention, rwkv6_scan
    if cfg.family == "rwkv":
        saved = rwkv6_scan.wkv6_plain

        def reversed_wkv(r, k, v, w, u, state0=None, state_out=None):
            y, state = saved(*(t.flip(2) for t in (r, k, v, w)), u, state0, state_out)
            return y.flip(2), state

        return [(rwkv6_scan, "wkv6_plain", reversed_wkv)], "time-reversed WKV"
    saved = flash_attention.flash_attention_plain
    return [(flash_attention, "flash_attention_plain",
             lambda q, k, v, causal=True, window=0, knobs=None: saved(
                 q, k, v, causal=False, window=window))], "unmasked attention"


def patched_call(patches: list, fn):
    """``fn()`` with each (module, attribute, value) of ``patches`` set,
    restored after."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, value in patches:
        setattr(mod, attr, value)
    try:
        return fn()
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def first_layers(params: dict, n: int) -> dict:
    """``params`` with only its first ``n`` layers: a hybrid's list cut, a
    stack's leading axis sliced (views of the same weights)."""
    layers = params["layers"]
    cut = layers[:n] if isinstance(layers, list) else {k: v[:n] for k, v in layers.items()}
    return dict(params, layers=cut)


def step0_readings(params, batch, cfg) -> dict:
    """Step 0's bf16 loss and gradients, kernel path against plain path, and
    the chaos floors (:func:`floor_mixers`) and a wrong forward
    (:func:`wrong_forward`) against the plain path, leaf by leaf."""
    import torch
    from repro_torch.models import api
    from repro_torch.train.tree import flatten

    paths = [path for path, _ in flatten(params)]
    kloss, _, kgrads = loss_and_grads(params, batch, cfg, plain=False)
    ploss, _, pgrads = loss_and_grads(params, batch, cfg, plain=True)
    err = grad_errors(kgrads, pgrads, paths, ZERO_GRAD_LEAVES)
    del kgrads
    floors = {}
    for name, patches in floor_mixers(cfg).items():
        floss, _, fgrads = patched_call(patches, lambda: loss_and_grads(
            params, batch, cfg, plain=True))
        floors[name] = (abs(floss - ploss) / abs(ploss),
                        grad_errors(fgrads, pgrads, paths, ZERO_GRAD_LEAVES))
        del fgrads
    del pgrads
    # the floor: the second computation farthest from the plain path
    floor_name = max(floors, key=lambda n: floors[n][1]["worst_leaf"])
    floor = floors[floor_name][1]
    patches, wrong = wrong_forward(cfg)

    def wrong_loss():
        with torch.no_grad():
            return api.loss_fn(params, batch, cfg, plain=True)[0].item()

    uloss = patched_call(patches, wrong_loss)
    return {"loss": kloss, "plain_loss": ploss, "loss_rel_err": abs(kloss - ploss) / abs(ploss),
            "floor_loss_rel_err": max(loss for loss, _ in floors.values()),
            "floor": floor_name, "floors": {n: {"loss_rel_err": loss, "whole": f["whole"],
                                                "worst_leaf": f["worst_leaf"]}
                                            for n, (loss, f) in floors.items()},
            "wrong_forward": wrong,
            "wrong_loss_rel_err": abs(uloss - ploss) / abs(ploss), "grads": err,
            "floor_grads": floor, "floor_at_worst_leaf": floor["leaves"][err["worst_path"]],
            "left_out": [p for p in paths if p.endswith(ZERO_GRAD_LEAVES)]}


def step0_line(r: dict, label: str) -> str:
    err, floor, at = r["grads"], r["floor_grads"], r["grads"]["worst_path"]
    top = sorted(err["leaves"], key=err["leaves"].get, reverse=True)[:6]
    return (f"{label}, kernel vs plain: loss {r['loss']:.6f} vs {r['plain_loss']:.6f} (rel "
            f"{r['loss_rel_err']:.3e}, tol {r.get('loss_tol', float('nan')):.3e}; chaos floor "
            f"{r['floor_loss_rel_err']:.3e}; {r['wrong_forward']} {r['wrong_loss_rel_err']:.3e}), "
            f"gradients worst leaf {err['worst_leaf']:.3e} at {at} (tol "
            f"{r.get('grad_tol', float('nan')):.3e}; chaos floor there "
            f"{r['floor_at_worst_leaf']:.3e}, its worst leaf {floor['worst_leaf']:.3e}), whole "
            f"{err['whole']:.3e} (floor {floor['whole']:.3e}); floors {json.dumps(r['floors'])}, "
            f"the farthest {r['floor']}; left out {r['left_out']}; leaves "
            f"kernel / floor " + ", ".join(f"{p} {err['leaves'][p]:.3e} / "
                                           f"{floor['leaves'][p]:.3e}" for p in top))


def wkv_on_model_inputs(params, batch, cfg) -> dict:
    """K6's forward on the WKV inputs of the model's first layer (the
    trainer's weights and batch, bf16), against the recurrence in float64,
    beside the plain version's and the reordered one's (:func:`wkv6_reversed`):
    normwise error of y, and how many outputs of the head group norm, in
    bf16 as the model rounds them, differ from float64's."""
    import torch
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.models import api
    from repro_torch.models import common as cm

    seen = []
    kernel = rwkv6_scan.wkv6

    def grab(r, k, v, w, u, state0=None, state_out=None):
        seen.append(tuple(t.detach().clone() for t in (r, k, v, w, u)))
        return kernel(r, k, v, w, u, state0, state_out)

    one = dataclasses.replace(cfg, n_layers=1)
    with torch.no_grad():
        patched_call([(rwkv6_scan, "wkv6", grab)],
                     lambda: api.loss_fn(first_layers(params, 1), batch, one))
    r, k, v, w, u = seen[0]
    y64, _ = rwkv6_scan.wkv6_plain(*(t.double() for t in (r, k, v, w, u)))
    b, h, s, kd = r.shape

    def normed(y):
        ones = torch.ones(h * kd, dtype=torch.bfloat16, device=y.device)
        return cm.groupnorm_heads(y.transpose(1, 2).reshape(b, s, h * kd).to(torch.bfloat16),
                                  ones, torch.zeros_like(ones), h)

    n64 = normed(y64.float())
    out = {}
    for name, fn in (("kernel", kernel), ("plain", rwkv6_scan.wkv6_plain),
                     ("reordered", wkv6_reversed)):
        y = fn(r, k, v, w, u)[0]
        out[name] = {"y_rel_err": float((y.double() - y64).norm() / y64.norm()),
                     "group_norm_flips": int((normed(y) != n64).sum())}
    log(f"train {cfg.name} K6 on its first layer's inputs ({tuple(r.shape)}), against float64: "
        + "; ".join(f"{n} y {x['y_rel_err']:.3e} normwise, {x['group_norm_flips']} of "
                    f"{n64.numel()} bf16 group-norm outputs differ" for n, x in out.items()))
    return out


def backward_in_model(params, batch, cfg) -> dict:
    """The recurrence's backward kernel inside the whole model in bf16: the
    loss's gradients with the forward kernel swapped for its plain version
    (so both paths run one forward), the backward the kernel, against
    autograd through the plain path; beside its floor, the same with the
    plain reverse recurrence for the backward, and a wrong backward (the
    kernel's dk, or dB, zeroed), which the gate must see."""
    import torch
    from repro_torch.kernels import rwkv6_scan, ssm_scan
    from repro_torch.train.tree import flatten

    mod, fwd, bwd, plain_fwd, plain_bwd = (
        (rwkv6_scan, "wkv6", "wkv6_backward", rwkv6_scan.wkv6_plain,
         rwkv6_scan.wkv6_backward_plain) if cfg.family == "rwkv" else
        (ssm_scan, "ssm_scan", "ssm_scan_backward", ssm_scan.ssm_scan_plain,
         ssm_scan.ssm_scan_backward_plain))
    kernel_bwd = getattr(mod, bwd)

    def zeroed(*args):
        grads = list(kernel_bwd(*args))
        grads[1 if cfg.family == "rwkv" else 3] = torch.zeros_like(grads[1])
        return tuple(grads)

    paths = [path for path, _ in flatten(params)]
    _, _, pgrads = loss_and_grads(params, batch, cfg, plain=True)
    out = {}
    for name, patches in (("kernel", []), ("floor", [(mod, bwd, plain_bwd)]),
                          ("wrong", [(mod, bwd, zeroed)])):
        _, _, grads = patched_call([(mod, fwd, plain_fwd)] + patches,
                                   lambda: loss_and_grads(params, batch, cfg, plain=False))
        out[name] = grad_errors(grads, pgrads, paths)
        del grads
    out["tol"] = STEP0_GRAD_FLOORS * out["floor"]["worst_leaf"]
    log(f"train {cfg.name} step 0 bf16 backward kernel in the model (forward plain on both "
        f"paths): gradients worst leaf {out['kernel']['worst_leaf']:.3e} at "
        f"{out['kernel']['worst_path']}, whole {out['kernel']['whole']:.3e} (tol {out['tol']:.3e}; "
        f"floor, the plain reverse recurrence: worst {out['floor']['worst_leaf']:.3e}, whole "
        f"{out['floor']['whole']:.3e}; a {'dk' if cfg.family == 'rwkv' else 'dB'}-zeroed "
        f"backward: worst {out['wrong']['worst_leaf']:.3e})")
    if not out["kernel"]["worst_leaf"] <= out["tol"] < out["wrong"]["worst_leaf"]:
        raise AssertionError(f"train {cfg.name} backward kernel in the model: {out}")
    return out


def step0_check(trainer, cfg, dev, tokens: int | None = None,
                layers: int | None = None) -> dict:
    """Step 0's bf16 loss and gradients, kernel path against plain path, on
    the trainer's parameters and batch (its first ``tokens`` tokens a row
    and its first ``layers`` layers when given, with the backward kernel
    checked inside the whole model), beside the chaos floor: the plain path against itself
    with its sequence mixers computed another correct way
    (:func:`floor_mixers`: in float64, as the bf16 logit checks measure
    theirs; the farthest of them), leaf by leaf. The loss gate is shown to see
    a wrong forward (:func:`wrong_forward`): it must fail it. qwen's gates are
    the constants set from its readings; the other runs' are set from the
    floor measured here (STEP0_GRAD_FLOORS, STEP0_LOSS_FLOORS)."""
    batch = trainer.dataset.device_batch_at(0, dev)
    if tokens is not None:
        batch = {k: v[:, :tokens] if k in ("tokens", "labels") else v for k, v in batch.items()}
    shape = tuple(batch["tokens"].shape)
    in_model = None
    if layers is not None:     # chaotic at full depth: the backward kernel in the model
        in_model = backward_in_model(trainer.params, batch, cfg)
        in_model["wkv_on_model_inputs"] = wkv_on_model_inputs(trainer.params, batch, cfg)
        out = step0_readings(first_layers(trainer.params, layers), batch,
                             dataclasses.replace(cfg, n_layers=layers))
    else:
        out = step0_readings(trainer.params, batch, cfg)
    if cfg.name == TRAIN_ARCH:
        out["loss_tol"], out["grad_tol"] = TRAIN_BF16_LOSS_TOL, TRAIN_BF16_GRAD_TOL
    else:
        out["loss_tol"] = max(STEP0_LOSS_FLOORS * out["floor_loss_rel_err"],
                              TRAIN_BF16_LOSS_TOL)
        out["grad_tol"] = (float("inf") if layers is not None else
                           max(STEP0_GRAD_FLOORS * out["floor_grads"]["worst_leaf"],
                               TRAIN_BF16_GRAD_TOL))
    out.update(tokens=shape[1], layers=layers or cfg.n_layers, backward_in_model=in_model)
    log(step0_line(out, f"train {cfg.name} step 0 bf16 ({shape} tokens"
                        + (f", the first {layers} layers; gradients not gated: chaotic)"
                           if layers else ")")))
    if not (out["loss_rel_err"] <= out["loss_tol"]
            and out["grads"]["worst_leaf"] <= out["grad_tol"]):
        raise AssertionError(f"train {cfg.name} step 0 bf16 kernel vs plain: {out}")
    if not out["wrong_loss_rel_err"] > out["loss_tol"]:
        raise AssertionError(f"train {cfg.name} step 0: the loss gate {out['loss_tol']} passes "
                             f"a wrong forward, {out['wrong_forward']} "
                             f"({out['wrong_loss_rel_err']:.3e})")
    return out


def step_parts(trainer, batches) -> dict:
    """Mean card time of the step's forward, backward and optimizer update by
    CUDA events over ``batches`` (one step each, the trainer's own step
    split at its seams)."""
    import torch
    from repro_torch.models import api
    from repro_torch.train.tree import leaves as tree_leaves, unflatten

    parts = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for batch in batches:
        flat = tree_leaves(trainer.params)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = api.loss_fn(trainer.params, batch, trainer.cfg)
        ev[1].record()
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        ev[2].record()
        trainer.params, trainer.opt_state, _ = trainer.optimizer.step(
            trainer.params, unflatten(trainer.params, grads), trainer.opt_state)
        ev[3].record()
        ev[3].synchronize()
        for key, (a, b) in zip(parts, zip(ev, ev[1:])):
            parts[key] += a.elapsed_time(b) / len(batches)
    return parts


def train_launches(cfg, steps: int) -> dict[str, int]:
    """Each kernel's launches in ``steps`` training steps of ``cfg``'s family
    with per-layer remat: a kernel of a rematerialised layer runs in the
    forward and again in the backward's recompute, a backward kernel once;
    whisper's encoder is not rematerialised. K1 per RMSNorm (dense 2 a
    layer, hybrid 4, + the final norm, forward only), K2 per attention
    (whisper's decoder self and cross), K5/K6 and their backwards per layer;
    K2′'s dQ and dK/dV kernels once an attention's backward where
    ``backward_route`` gives the kernels (bf16 at d ≤ 128)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import backward_route
    n = cfg.n_layers
    per_step = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    attn_bwd = 0
    if cfg.family in ("dense", "hybrid"):
        norms = 4 if cfg.family == "hybrid" else 2
        per_step.update(rmsnorm=2 * norms * n + 1, flash_attention=2 * n)
        attn_bwd = n
    if cfg.family == "hybrid":
        per_step.update(ssm_scan=2 * n, ssm_scan_bwd=n)
    if cfg.family == "rwkv":
        per_step.update(wkv6=2 * n, wkv6_bwd=n)
    if cfg.family == "encdec":
        per_step["flash_attention"] = cfg.n_enc_layers + 2 * 2 * n
        attn_bwd = cfg.n_enc_layers + 2 * n
    if backward_route("cuda", getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "kernels":
        per_step.update(flash_attention_bwd_dq=attn_bwd, flash_attention_bwd_dkv=attn_bwd)
    return {k: steps * v for k, v in per_step.items()}


def median_ms(step_s: list[float]) -> float:
    """The median of host-clock step times (s), in ms."""
    xs = sorted(step_s)
    mid = len(xs) // 2
    return 1e3 * (xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2)


def checksum(trainer) -> list[float]:
    """Each leaf of the trainer's parameters and optimizer state summed in
    float64, in the trees' order (a DTensor leaf whole): what a step leaves
    behind, readable after the trees are freed."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.train.tree import leaves as tree_leaves
    with torch.no_grad():
        return torch.stack([(t.full_tensor() if isinstance(t, DTensor) else t).double().sum()
                            for t in tree_leaves({"p": trainer.params,
                                                  "o": trainer.opt_state})]).tolist()


def replayed_steps(trainer, report, dev, steps: int, per_step: dict[str, int]) -> dict:
    """The graphed run's step: every step after the warm-up replayed and a
    replay launching ``per_step`` (one eager step's launches); the replays'
    median (steps WARMUP + 2 to the last: the step before them also
    captured the graph), the capturing step's time, and 3 replays profiled
    (:func:`profile_steps`) on batches past the run's, each ending in
    ``float(loss)`` as a step of ``Trainer.run`` does."""
    import torch
    from repro_torch import kernels
    from repro_torch.train.trainer import WARMUP

    graph = trainer.graph
    if not (graph is not None and graph.eager_steps == WARMUP
            and report.replayed_steps == graph.replays == steps - WARMUP):
        raise AssertionError(f"train {trainer.cfg.name}: {report.replayed_steps} of {steps} "
                             f"steps replayed, {graph and graph.eager_steps} eager")
    if {k: n for k, n in graph.launches.items() if n and k != kernels.WGMMA} != per_step:
        raise AssertionError(f"train {trainer.cfg.name}: a replay launches {graph.launches}, "
                             f"an eager step {per_step}")
    batches = [trainer.dataset.device_batch_at(steps + i, dev) for i in range(3)]
    it = itertools.cycle(batches)
    prof = profile_steps(
        lambda: float(graph(trainer.params, trainer.opt_state, next(it))[2]["loss"]), steps=3)
    torch.cuda.synchronize()
    return {"median_ms": median_ms(report.step_s[WARMUP + 1:]),
            "capture_step_ms": 1e3 * report.step_s[WARMUP], "profile": prof,
            "replays": graph.replays}


def eager_run(cfg, dev, batch: int, seq: int, steps: int, measure: bool = True,
              dist=None) -> dict:
    """``make_train_step``'s function run eagerly from the graphed run's seed
    on a trainer of its own (under ``dist``'s mesh where given), over the
    same steps and batches, timed as
    ``Trainer.run`` times a step (host clock around the step ending in
    ``float(loss)``): its losses, median (steps 3 to the last), peak memory
    and :func:`checksum`; with ``measure``, then a step profiled (ending in
    ``float(loss)``) and one split at its seams (:func:`step_parts`) past
    the run's batches."""
    import torch
    from repro_torch.launch import train as launch_train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tc = launch_train.TrainerConfig(steps=steps, checkpoint_dir=None, lr=TRAIN_RUN["lr"])
    trainer = launch_train.Trainer(cfg, tc, global_batch=batch, seq_len=seq, controller=True,
                                   device=dev, **({} if dist is None else {"dist": dist}))
    losses, step_s = [], []
    for step in range(steps):
        data = trainer.dataset.device_batch_at(step, dev)
        t0 = time.monotonic()
        trainer.params, trainer.opt_state, metrics = trainer.step_fn(
            trainer.params, trainer.opt_state, data)
        losses.append(float(metrics["loss"]))
        step_s.append(time.monotonic() - t0)
    out = {"losses": losses, "step_s": step_s, "median_ms": median_ms(step_s[2:]),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "checksum": checksum(trainer)}
    if measure:
        batches = [trainer.dataset.device_batch_at(steps + i, dev) for i in range(3)]
        it = itertools.cycle(batches)

        def one_step():
            trainer.params, trainer.opt_state, m = trainer.step_fn(
                trainer.params, trainer.opt_state, next(it))
            float(m["loss"])

        out["profile"] = profile_steps(one_step, steps=1)
        out["parts"] = step_parts(trainer, batches[:1])
    del trainer, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hold_to_eager(name: str, graphed: dict, eager: dict, rerun: Callable[[], list]) -> dict:
    """The graphed run's losses and checksum against the eager run's: equal
    bit for bit, or, where a second eager run (``rerun()``, its losses) shows
    that two eager runs differ, the losses within the eager runs' spread
    (the largest relative difference of a step)."""
    def spread(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    out = {"bitwise": graphed["losses"] == eager["losses"]
           and graphed["checksum"] == eager["checksum"]}
    if out["bitwise"]:
        out.update(graphed_vs_eager=0.0, eager_vs_eager=None)
        return out
    again = rerun()
    out.update(graphed_vs_eager=spread(graphed["losses"], eager["losses"]),
               eager_vs_eager=spread(again, eager["losses"]), eager_rerun=again)
    if again == eager["losses"] or not out["graphed_vs_eager"] <= out["eager_vs_eager"]:
        raise AssertionError(f"train {name}: the graphed losses {graphed['losses']} against "
                             f"the eager {eager['losses']} (a second eager run {again}; "
                             f"checksums equal: {graphed['checksum'] == eager['checksum']})")
    return out


def held_line(held: dict) -> str:
    if held["bitwise"]:
        return ("losses and the final trees' checksums equal to the eager run's bit for bit "
                "(no second eager run needed)")
    return (f"losses within {held['graphed_vs_eager']:.3e} relative of the eager run's, inside "
            f"the eager-versus-eager spread {held['eager_vs_eager']:.3e} (a second eager run)")


def step_line(name: str, batch: int, seq: int, steps: int, graphed: dict, eager: dict,
              flops: dict, bound: tuple, peak_gib: float) -> str:
    """The train step's line: the replayed step beside the eager step of the
    same call, each with its tokens/s and peak memory, and, where it was
    profiled, its card-active time, device ops and the card's idle share of
    the profiled steps' span on the host clock."""
    from repro_torch.train.trainer import WARMUP

    def card(p):
        return (f"card active {p['card_active_ms_per_step']:.3f} ms a step (busy "
                f"{p['card_busy_ms_per_step']:.3f}, {p['device_ops_per_step']:.0f} device ops) "
                f"of {p['wall_ms_per_step']:.3f} ms profiled (host clock to the card's end), "
                f"idle share {p['idle_share']:.3f}")

    rp = graphed["profile"]
    eager_card = (f"{card(eager['profile'])}; parts (CUDA events, one eager step) "
                  f"{eager['parts']}" if "profile" in eager else "not profiled")
    return (
        f"train step {name}: replayed {graphed['median_ms']:.3f} ms (median of steps "
        f"{WARMUP + 2}-{steps}, host clock around the step and float(loss); the "
        f"capturing step {graphed['capture_step_ms']:.3f} ms), "
        f"{batch * seq / graphed['median_ms'] * 1e3:.0f} tokens/s; {card(rp)}; peak "
        f"{peak_gib:.2f} GiB | eager {eager['median_ms']:.3f} ms (steps 3-{steps}), "
        f"{batch * seq / eager['median_ms'] * 1e3:.0f} tokens/s; peak "
        f"{eager['peak_gib']:.2f} GiB; {eager_card} | "
        f"replayed / eager {graphed['median_ms'] / eager['median_ms']:.3f}; model FLOPs "
        f"{flops['flops'] / 1e12:.3f} T a step ({flops['recompute_flops'] / 1e12:.3f} T of it "
        f"the remat recompute) = {flops['flops'] / graphed['median_ms'] / 1e9:.1f} TFLOP/s "
        f"replayed, {flops['flops'] / graphed['median_ms'] / 1e9 / 989:.3f} of 989; "
        f"recurrence {flops['recurrence_ops'] / 1e9:.1f} GFLOP f32; bound {bound[0]:.3f} ms by "
        f"{bound[1]}; top kernels (replayed) {json.dumps(rp['top_kernels_ms_per_step'])}; "
        f"ours {json.dumps(rp['repro_kernels_ms_per_step'])}")


def train_model(name: str, dev) -> dict:
    """One of :data:`TRAIN_MODELS` at full width through
    ``repro_torch.launch.train``'s ``Trainer`` (bf16, ``for_arch``'s
    optimizer, the controller on, no checkpoints), which replays its step
    from a CUDA graph after ``trainer.WARMUP`` eager steps: step 0 held to the plain
    path beside its chaos floor, the run's losses finite, its launches
    exact (:func:`train_launches`), its replayed step timed (host clock) and
    profiled; then, with that trainer freed (rwkv6-3b's state fits once),
    an eager run from the same seed (:func:`eager_run`), which the graphed
    run is held to (:func:`hold_to_eager`) and timed beside; the step
    bounded by :func:`train_flops` (the bf16 FLOPs at 989 TFLOP/s, the
    recurrences' float32 work at 67 TFLOP/s, the optimizer's 30 B a
    parameter at 3.35 TB/s; the largest of the three)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    t_model = time.perf_counter()
    cfg, run = get_config(name), TRAIN_MODELS[name]
    batch, seq, steps = run["batch"], run["seq"], run["steps"]
    tc = launch_train.TrainerConfig(steps=steps, checkpoint_dir=None, lr=TRAIN_RUN["lr"])
    trainer = launch_train.Trainer(cfg, tc, global_batch=batch, seq_len=seq,
                                   controller=True, device=dev)
    n_params = count_params(trainer.params)
    t0 = time.perf_counter()
    result = {"step0": step0_check(trainer, cfg, dev, run["step0_tokens"],
                                   run.get("step0_layers"))}
    log(f"train {name} step 0 checks: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    report = trainer.run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    wgmma = kernels.flash_attention.WGMMA_LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    summary = launch_train.summarize(trainer, report)
    want = train_launches(cfg, steps)
    if launches != want or wgmma != launches["flash_attention"]:
        raise AssertionError(f"train {name} launches {launches} (tensor cores {wgmma}) != {want}")
    if not (report.steps_run == steps and all(map(math.isfinite, report.losses))):
        raise AssertionError(f"train {name} run: {report}")
    per_step = {k: n // steps for k, n in launches.items() if n}
    log(f"train {name} full width ({n_params / 1e9:.3f} B parameters, bf16, batch {batch} x "
        f"{seq}, for_arch's AdamW lr {TRAIN_RUN['lr']}, "
        f"controller on, no checkpoints): {steps} steps, {report.replayed_steps} of them "
        f"replayed from the CUDA graph, losses {[round(x, 4) for x in report.losses]}; "
        f"launches {launches} = {steps} x {per_step} (the capture none), all {wgmma} K2 "
        f"launches on the tensor cores; peak {peak / 2**30:.2f} GiB; summary "
        f"{json.dumps(summary)}")
    graphed = {"losses": report.losses, "checksum": checksum(trainer),
               **replayed_steps(trainer, report, dev, steps, per_step)}
    if name == TUNED_BWD_ARCH:
        result["tuned_backward"] = tuned_backward(trainer, cfg, dev)
    del trainer
    eager = eager_run(cfg, dev, batch, seq, steps, measure=name in EAGER_PROFILED)
    held = hold_to_eager(name, graphed, eager,
                         lambda: eager_run(cfg, dev, batch, seq, steps, measure=False)["losses"])
    log(f"train {name} graphed vs eager ({steps} steps from seed 0, one after the other): "
        f"{held_line(held)}")
    flops = train_flops(cfg, batch, seq)
    opt_bytes = 30 * n_params
    bound = max((flops["flops"] / BF16_FLOPS_PER_S * 1e3, "operations (bf16)"),
                (flops["recurrence_ops"] / F32_OPS_PER_S * 1e3, "operations (f32)"),
                (opt_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    prof = graphed["profile"]
    med = graphed["median_ms"]
    result["run"] = {
        "losses": report.losses, "launches": launches, "wgmma": wgmma,
        "median_step_ms": med, "tokens_per_s": batch * seq / (med / 1e3),
        "peak_gib": peak / 2**30, "card_idle_share": prof["idle_share"],
        "profile": prof, "capture_step_ms": graphed["capture_step_ms"],
        "replayed_steps": report.replayed_steps, "held_to_eager": held,
        "eager": {k: v for k, v in eager.items() if k != "checksum"},
        "flops": flops, "flop_rate_tflops": flops["flops"] / med / 1e9,
        "mfu": flops["flops"] / (med / 1e3) / BF16_FLOPS_PER_S,
        "optimizer_bytes": opt_bytes, "bound_ms": bound[0], "bound_by": bound[1],
        "summary": summary, "params": n_params}
    log(step_line(name, batch, seq, steps, graphed, eager, flops, bound, peak / 2**30)
        + f"; the optimizer's 30 B a parameter {opt_bytes / 1e9:.2f} GB "
          f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {name}: {time.perf_counter() - t_model:.1f} s")
    return result


#: steps of the sharded train step on a mesh of one rank (the LOCAL run's
#: first): trainer.WARMUP eager, then a capture and a replay a step
DIST_STEPS = 6
#: what one card leaves unchecked of distribution (tests/test_torch_distributed.py
#: holds each on gloo groups of 2 and 4 CPU processes, eagerly)
DIST_UNCHECKED = ("collectives across two or more ranks on NCCL", "a model axis above 1",
                  "the expert-parallel all-to-alls and capacity drops across ranks",
                  "the 16 x 16 and 2 x 16 x 16 meshes",
                  "the sharded step's CUDA graph across two or more ranks (gloo has no graphs)",
                  "every collective a world of one does not launch inside the graph")


@contextlib.contextmanager
def world_of_one(dev):
    """An NCCL process group of this process alone, started from a FileStore in
    a temporary directory (no network: NCCL bootstraps on the loopback device),
    destroyed on the way out."""
    import os
    import shutil
    import torch.distributed as tdist
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    d = tempfile.mkdtemp(prefix="repro_nccl_")
    tdist.init_process_group("nccl", init_method=f"file://{d}/store", rank=0, world_size=1,
                             device_id=dev)
    try:
        yield
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def captured_psum(group, g, e) -> dict:
    """``compressed_psum({"g": g}, group, {"g": e})`` eagerly, then, after an
    eager call on the capture stream, captured into a CUDA graph
    (``StepGraph``, as the trainer's) and replayed twice on the same inputs:
    the eager call's sum and error buffer, each replay's (copies), and the
    graph."""
    import torch
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.kernels.graphs import StepGraph

    def fn(x):
        summed, err = compressed_psum({"g": x["g"]}, group, {"g": x["e"]})
        return summed["g"], err["g"]

    inputs = {"g": g, "e": e}
    eager = fn(inputs)
    current, stream = torch.cuda.current_stream(g.device), torch.cuda.Stream(g.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn(inputs)
    current.wait_stream(stream)
    graph = StepGraph(fn, {k: torch.empty_like(v) for k, v in inputs.items()}, stream)
    replays = [tuple(t.clone() for t in graph(inputs)) for _ in range(2)]
    return {"eager": eager, "replays": replays, "graph": graph}


def distributed_step(cfg, dev, local: dict, ckpt_dir: Path) -> dict:
    """The sharded train step on a 1 x 1 (data, model) mesh over an NCCL group
    of one rank: (a) ``Trainer`` with that mesh's ``DistContext`` (same seed,
    batch and settings as the LOCAL run, no checkpoints) for DIST_STEPS
    steps, the last DIST_STEPS - WARMUP replayed from its CUDA graph, its
    losses the LOCAL eager run's first ones bit for bit, every leaf's local
    tensor where it was, its K1/K2 launches DIST_STEPS x the LOCAL per-step
    counts (a replay's one step's), its replayed step timed and profiled
    (:func:`replayed_steps`: device ops and NCCL kernels a replay); then an
    eager sharded run from the same seed (:func:`eager_run`), which the
    graphed run is held to (:func:`hold_to_eager`) and timed beside, with
    the LOCAL replayed step of the same call; (b) the LOCAL run's checkpoint
    at ``ckpt_dir`` restored onto the mesh by ``param_shardings`` and
    ``opt_shardings``, every leaf byte for byte; (c) ``compressed_psum`` over
    the world of one exactly ``dequantize(quantize(g + e))`` with the error
    buffer exactly the rest, and captured in a CUDA graph whose two replays
    equal the eager call bit for bit (:func:`captured_psum`). ``local``: the
    LOCAL eager run's ``losses`` and ``step_s`` (:func:`eager_run`), the
    LOCAL ``per_step`` launches, and its replayed step's ``replayed_ms``
    median and ``replayed_ops`` device ops."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.distributed.compression import (compressed_psum, dequantize_int8,
                                                     quantize_int8)
    from repro_torch.distributed.context import DistContext, make_mesh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import WARMUP, train_shardings
    from repro_torch.train.tree import flatten, leaves as tree_leaves

    t_step = time.perf_counter()
    batch, seq = TRAIN_BATCH
    out = {}
    with world_of_one(dev):
        dist = DistContext(mesh=make_mesh((1, 1), ("data", "model")))
        tc = launch_train.TrainerConfig(steps=DIST_STEPS, checkpoint_dir=None,
                                        lr=TRAIN_RUN["lr"])
        trainer = launch_train.Trainer(cfg, tc, dist=dist, global_batch=batch, seq_len=seq,
                                       controller=True, device=dev)
        optimizer = trainer.optimizer

        def local_tensors():      # views, which keep their storage from being reused
            return [t.to_local() for t in tree_leaves({"p": trainer.params,
                                                       "o": trainer.opt_state})]

        before = local_tensors()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        report = trainer.run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = {k: DIST_STEPS * local["per_step"].get(k, 0) for k in launches}
        if report.losses != local["losses"][:DIST_STEPS]:
            raise AssertionError(f"distributed losses {report.losses} != the LOCAL eager "
                                 f"run's {local['losses'][:DIST_STEPS]}")
        if launches != want:
            raise AssertionError(f"distributed launches {launches} != {want}")
        moved = [i for i, (a, b) in enumerate(zip(before, local_tensors()))
                 if a.data_ptr() != b.data_ptr()]
        if moved:
            raise AssertionError(f"distributed: {len(moved)} leaves' local tensors moved: "
                                 f"{moved[:5]}")
        graphed = {"losses": report.losses, "checksum": checksum(trainer),
                   **replayed_steps(trainer, report, dev, DIST_STEPS, local["per_step"])}
        n_leaves = len(before)
        del trainer, before
        gc.collect()
        torch.cuda.empty_cache()
        log(f"distributed train {cfg.name} on a 1 x 1 (data, model) mesh over NCCL (world "
            f"of one): {DIST_STEPS} steps, {report.replayed_steps} of them replayed from the "
            f"sharded step's CUDA graph, losses {report.losses} == the LOCAL eager run's "
            f"first {DIST_STEPS} bit for bit; all {n_leaves} leaves' local tensors at their "
            f"addresses after the run; launches {launches} = {DIST_STEPS} x LOCAL per step "
            f"(the capture none, a replay {local['per_step']}); steps "
            f"{[round(x * 1e3, 3) for x in report.step_s]} ms")
        eager = eager_run(cfg, dev, batch, seq, DIST_STEPS, measure=False, dist=dist)
        held = hold_to_eager(f"{cfg.name} sharded", graphed, eager, lambda: eager_run(
            cfg, dev, batch, seq, DIST_STEPS, measure=False, dist=dist)["losses"])
        log(f"distributed train graphed vs eager sharded ({DIST_STEPS} steps from seed 0, "
            f"one after the other): {held_line(held)}")
        prof = graphed["profile"]
        nccl = prof["nccl_ops_per_step"]
        out["train"] = {"losses": report.losses, "launches": launches,
                        "step_s": report.step_s, "replayed_steps": report.replayed_steps,
                        "median_ms": graphed["median_ms"],
                        "capture_step_ms": graphed["capture_step_ms"], "profile": prof,
                        "held_to_eager": held, "eager_median_ms": eager["median_ms"],
                        "eager_step_s": eager["step_s"],
                        "local_replayed_ms": local["replayed_ms"],
                        "local_replayed_ops": local["replayed_ops"]}
        log(f"distributed step {cfg.name}: replayed {graphed['median_ms']:.3f} ms (median of "
            f"steps {WARMUP + 2}-{DIST_STEPS}, host clock around the step and float(loss); the "
            f"capturing step {graphed['capture_step_ms']:.3f} ms) | eager sharded "
            f"{eager['median_ms']:.3f} ms (steps 3-{DIST_STEPS}) | LOCAL replayed "
            f"{local['replayed_ms']:.3f} ms, {local['replayed_ops']:.0f} device ops a replay "
            f"(the train phase of this call) | replayed / eager "
            f"{graphed['median_ms'] / eager['median_ms']:.3f}; a replay profiled: "
            f"{prof['device_ops_per_step']:.0f} device ops, {nccl:.0f} of them NCCL kernels "
            f"{prof['nccl_kernels']}, card active {prof['card_active_ms_per_step']:.3f} of "
            f"{prof['wall_ms_per_step']:.3f} ms (idle share {prof['idle_share']:.3f})"
            + ("" if nccl else "; the card ran no collective inside the graph (NCCL over one "
               "rank launched no kernel), so this step checks no captured collective kernel"))

        sh = train_shardings(cfg, optimizer, dist)
        like_p = api.abstract_params(cfg)
        like_o = optimizer.init(like_p)
        t0 = time.perf_counter()
        got_p, got_o, step = ckpt.restore(ckpt_dir, like_p, like_o, dist=dist,
                                          param_shardings=sh["params"],
                                          opt_shardings=sh["opt_state"],
                                          step=TRAIN_RUN["checkpoint_every"])
        restore_s = time.perf_counter() - t0
        got = flatten({"params": got_p, "opt_state": got_o})
        with np.load(Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz") as z:
            bad = [k for i, (k, leaf) in enumerate(got)
                   if not torch.equal(leaf.full_tensor().to(torch.float32
                                      if z[f"a{i}"].dtype == np.float32 else leaf.dtype),
                                      torch.from_numpy(z[f"a{i}"]).to(dev))]
        if bad:
            raise AssertionError(f"distributed restore: {len(bad)} leaves differ: {bad[:5]}")
        out["restore"] = {"step": step, "leaves": len(got), "s": restore_s}
        log(f"distributed restore: the LOCAL run's step-{step} checkpoint onto the mesh by "
            f"param_shardings and opt_shardings, all {len(got)} leaves equal byte for byte "
            f"({restore_s:.2f} s)")
        del got_p, got_o, got
        gc.collect()
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(5)
        g = torch.randn((3, 1000), generator=gen, device=dev) * 1e-3
        e = torch.randn((3, 1000), generator=gen, device=dev) * 1e-6
        summed, err = compressed_psum({"g": g}, dist.mesh.get_group("data"), {"g": e})
        q, scale, shape = quantize_int8(g + e)
        exact = dequantize_int8(q, scale, shape)
        if not (torch.equal(summed["g"], exact) and torch.equal(err["g"], g + e - exact)):
            raise AssertionError("distributed compressed_psum over a world of one is not "
                                 "dequantize(quantize(g + e))")
        cap = captured_psum(dist.mesh.get_group("data"), g, e)
        if not all(torch.equal(a, b) for r in cap["replays"] for a, b in zip(r, cap["eager"])):
            raise AssertionError("distributed compressed_psum: a replay of its CUDA graph "
                                 "differs from the eager call")
        pprof = profile_steps(lambda: cap["graph"]({"g": g, "e": e}), steps=1)
        out["psum_graph"] = {"profile": pprof}
        log("distributed compressed_psum over the world of one: the sum is exactly "
            "dequantize(quantize(g + e)) and the error buffer exactly g + e less it "
            f"(3 x 1000 f32, {q.shape[0]} blocks of 256); captured in a CUDA graph and "
            f"replayed twice, sum and error buffer equal to the eager call's bit for bit; a "
            f"replay {pprof['device_ops_per_step']:.0f} device ops, "
            f"{pprof['nccl_ops_per_step']:.0f} NCCL kernels {pprof['nccl_kernels']}"
            + ("" if pprof["nccl_ops_per_step"] else " (its all-gathers over one rank "
               "launched no NCCL kernel in the graph)"))
        del cap
    out["s"] = time.perf_counter() - t_step
    log(f"distributed: what one card leaves unchecked, held on gloo groups of 2 and 4 CPU "
        f"processes by tests/test_torch_distributed.py instead: {'; '.join(DIST_UNCHECKED)}")
    log(f"distributed step: {out['s']:.1f} s")
    return out


#: the dry-run phase's cells: the runs the train and serve phases measure,
#: each traced on the meta device on a world of one rank
#: (``repro_torch.launch.dryrun --mesh local``)
DRYRUN_CELLS = {"qwen1.5-0.5b": "train:8x128", "hymba-1.5b": "train:2x2048",
                "rwkv6-3b": "train:8x128", "whisper-tiny": "train:8x128",
                "llama-13b": "decode:4x256"}
#: the tuned backward at full width: hymba-1.5b's train run, its parameters
#: and first batch, one forward and backward with these knobs and one without.
#: Since K2′ the card's bf16 backward reads no knob (it never builds P whole),
#: so the three passes give the same gradients there and the gates below
#: hold at 0 against 0; the ops backward that the knobs block runs on the CPU
#: and in f32
TUNED_BWD_ARCH = "hymba-1.5b"
TUNED_BWD_KNOBS = dict(attn_block_remat=True, q_block=512)
#: the floor the tuned backward's gradients are gated against: the same
#: knobs at two blocks of 1,024 rows
TUNED_BWD_FLOOR_KNOBS = dict(attn_block_remat=True, q_block=1024)
#: the tuned backward's gradients against the untuned ones (grad_errors),
#: gated against the floor measured in the same run: the same knobs at two
#: blocks of 1,024 rows against one. The forward is the same kernels, bit
#: for bit, so in both only the f32 sums of dK and dV over the query blocks,
#: and the bf16 roundings of the gradients they feed, differ; hymba-1.5b at
#: random weights carries such a difference back through its 32 layers as
#: its forward carries a rounding (its chaos floor, 2.9e-2 in the logits).
#: Runs on an NVIDIA H100 read, tuned against floor, at the worst leaf
#: 7.93e-2 / 3.03e-2 = 2.6 after 3 training steps (['layers'][10]
#: ['beta_ssm'], a scale whose gradient sums 4,096 tokens with cancellation)
#: and 2.14e-2 / 1.84e-2 = 1.16 after this run's 6; the whole gradient
#: 8.98e-3 / 7.32e-3 and 9.04e-3 / 7.32e-3 = 1.23. Gates: the worst leaf
#: within TUNED_BWD_LEAF_RATIO of the floor's, the whole gradient within
#: twice the floor's and within TUNED_BWD_WHOLE_TOL (about twice what it
#: read), so that a fault shared by both blocked passes, which moves every
#: leaf by a few percent, fails too
TUNED_BWD_LEAF_RATIO = 4.0
TUNED_BWD_WHOLE_TOL = 2e-2
#: K2's Function's backward at one hymba layer's shapes, blocked against
#: whole, normwise per gradient: bf16 outputs of f32 sums in another order;
#: ten times the worst an NVIDIA H100 read (9.7e-5, dv; dq 0)
TUNED_LAYER_TOL = 1e-3


def start_dryruns(root: Path) -> list:
    """The dry-run of each of :data:`DRYRUN_CELLS`, one CLI process each, all
    started at once with no CUDA device visible (the dry-run needs none).
    They run beside the train phase's checks, which time nothing, and are
    collected by :func:`collect_dryruns` before its first timed step."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [(arch, shape, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "local", "--out", str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for arch, shape in DRYRUN_CELLS.items()]


def collect_dryruns(procs: list) -> dict:
    """Wait for the processes of :func:`start_dryruns`; raise unless each
    ended ``ok``. Returns their output and the seconds waited."""
    t0 = time.perf_counter()
    texts = {arch: proc.communicate(timeout=300)[0] for arch, _, proc in procs}
    for arch, shape, proc in procs:
        if proc.returncode or "[ok     ]" not in texts[arch]:
            raise AssertionError(f"dryrun {arch} {shape}: exit {proc.returncode}: "
                                 f"{texts[arch][-2000:]}")
    return {"texts": texts, "wait_s": time.perf_counter() - t0}


def stop(procs: list) -> None:
    """Kill every process of ``procs`` still running and reap it."""
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def attention_calls(cfg, batch: int, seq: int) -> list[tuple]:
    """(query rows, keys, kept pairs a head, forward passes) of each of the
    train step's attention calls: the decoder's self-attention a layer
    (causal, hymba's window on all but its global layers), whisper's
    cross-attention over its frames a layer (both run twice forward, by the
    layer's remat) and its encoder's self-attention a layer (once)."""
    if cfg.family == "rwkv":
        return []
    calls = [(seq, seq, attention_pairs(seq, seq, True, cfg.window
                                        if cfg.family == "hybrid" and i not in cfg.global_layers
                                        else 0), 2) for i in range(cfg.n_layers)]
    if cfg.family == "encdec":
        f = cfg.n_frames
        calls += [(seq, f, seq * f, 2)] * cfg.n_layers + [(f, f, f * f, 1)] * cfg.n_enc_layers
    return calls


def dryrun_difference(cfg, batch: int, seq: int, dry_flops: float, model_flops: float) -> dict:
    """The dry-run's FLOPs beyond :func:`train_flops`'s, term by term. A
    unit is one attention product over (query, key) pairs, 2 B H Sq Sk hd
    over all of them. The plain path the dry-run traces runs every pair,
    masked or not: 2 products a forward pass and 5 in the backward
    (``ops.FlashAttentionFunction``: QKᵀ again, dV, dP, dQ, dK), where
    train_flops counts 2 a forward pass and 4 in the backward over the
    pairs the mask keeps. So: ``masked_pairs`` = (2 x forward passes + 4)
    units over the masked pairs, ``recompute_p`` = 1 unit over all pairs
    (the backward's QKᵀ), ``recurrence_dots`` = the selective scan's and the
    WKV recurrence's products in their plain versions (forward twice,
    backward once), which train_flops counts as float32 work apart;
    ``conv_elementwise`` (hymba) the Mamba branch's depthwise convolution,
    which train_flops counts as products (2 a weight a token, 4 passes) and
    the port computes elementwise; ``other`` what is left."""
    unit = 2 * batch * cfg.n_heads * cfg.resolved_head_dim
    masked = recompute = 0
    for sq, sk, kept, passes in attention_calls(cfg, batch, seq):
        masked += (2 * passes + 4) * unit * (sq * sk - kept)
        recompute += unit * sq * sk
    recurrence = conv = 0
    if cfg.family == "hybrid":
        recurrence = (2 * 2 + 6) * batch * seq * cfg.d_inner * cfg.ssm_state * cfg.n_layers
        conv = -4 * 2 * batch * seq * cfg.conv_kernel * cfg.d_inner * cfg.n_layers
    if cfg.family == "rwkv":
        recurrence = (2 * 2 + 6) * batch * seq * cfg.d_model * cfg.rwkv_head_size * cfg.n_layers
    diff = dry_flops - model_flops
    return {"difference": diff, "masked_pairs": masked, "recompute_p": recompute,
            "recurrence_dots": recurrence, "conv_elementwise": conv,
            "other": diff - masked - recompute - recurrence - conv}


def tuned_layer_check(cfg, dev, batch: int, seq: int) -> dict:
    """``ops.FlashAttentionFunction``'s backward with :data:`TUNED_BWD_KNOBS`
    against without, at one layer's shapes of ``cfg`` (bf16, causal, the
    window and global), on random inputs: each gradient's normwise
    difference within :data:`TUNED_LAYER_TOL` (0 on the card, where K2′
    reads no knob). And with ``attn_probs_bf16`` on the card, where the
    knob acts on the plain path only: the output and the gradients equal
    the baseline's bit for bit."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import tuning

    g = torch.Generator(device=dev).manual_seed(11)
    hd = cfg.resolved_head_dim
    q, k, v, do = (torch.randn((batch, seq, n, hd), generator=g, device=dev).to(torch.bfloat16)
                   for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads, cfg.n_heads))
    out = {}
    for window in (cfg.window, 0):
        grads = {}
        passes = [("tuned", TUNED_BWD_KNOBS), ("baseline", {})]
        if dev.type == "cuda":
            passes.append(("probs_bf16", dict(attn_probs_bf16=True)))
        for label, knobs in passes:
            qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
            o = ops.FlashAttentionFunction.apply(qq, kk, vv, True, window,
                                                 tuning.attention_knobs(tuning.Tuning(**knobs)))
            grads[label] = (o.detach(), *torch.autograd.grad(o, (qq, kk, vv), do))
        errs = [float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(grads["tuned"][1:], grads["baseline"][1:])]
        out[f"window_{window}"] = dict(zip(("dq", "dk", "dv"), errs))
        if not max(errs) <= TUNED_LAYER_TOL:
            raise AssertionError(f"tuned layer backward (window {window}): {errs}")
        if "probs_bf16" in grads:
            same = all(map(torch.equal, grads["probs_bf16"], grads["baseline"]))
            out[f"window_{window}"]["probs_bf16_bit_for_bit"] = same
            if not same:
                raise AssertionError(f"attn_probs_bf16 moved K2's output or its gradients on "
                                     f"the card (window {window})")
    return out


def tuned_backward(trainer, cfg, dev) -> dict:
    """One forward and backward of ``trainer``'s model on its parameters and
    first batch with :data:`TUNED_BWD_KNOBS`, with two blocks of 1,024 (the
    floor) and with no knob: the loss bit for bit, the gradients within the
    bounds of :data:`TUNED_BWD_LEAF_RATIO` and :data:`TUNED_BWD_WHOLE_TOL`,
    and each pass's peak memory above what was allocated before it; then
    :func:`tuned_layer_check`."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import tuning
    from repro_torch.train.tree import flatten

    t0 = time.perf_counter()
    batch = trainer.dataset.device_batch_at(0, dev)
    out = {}
    for label, knobs in (("tuned", TUNED_BWD_KNOBS),
                         ("floor", TUNED_BWD_FLOOR_KNOBS), ("baseline", {})):
        # each pass builds its own masks (the training steps left the
        # unblocked ones cached), so that the peaks compare alike
        ops._backward_masks.cache_clear()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tuning.set_tuning(**knobs)
        try:
            t1 = time.perf_counter()
            loss, _, grads = loss_and_grads(trainer.params, batch, cfg, plain=False)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev)
            out[label] = {"loss": loss, "grads": grads, "s": time.perf_counter() - t1,
                          "peak_gib": peak / 2**30, "peak_above_gib": (peak - before) / 2**30}
        finally:
            tuning.reset()
    paths = [path for path, _ in flatten(trainer.params)]
    base = out["baseline"].pop("grads")
    errs = grad_errors(out["tuned"].pop("grads"), base, paths)
    floor = grad_errors(out["floor"].pop("grads"), base, paths)
    del base
    b, s = batch["tokens"].shape
    p_bytes = b * cfg.n_heads * s * s * 4
    layer = tuned_layer_check(cfg, dev, b, s)
    result = {**out, "worst_leaf": errs["worst_leaf"], "worst_path": errs["worst_path"],
              "whole": errs["whole"], "floor_worst_leaf": floor["worst_leaf"],
              "floor_whole": floor["whole"], "layer": layer, "p_bytes_a_layer": p_bytes,
              "s": time.perf_counter() - t0}
    log(f"dryrun tuned backward {cfg.name} (its train run's parameters and first batch, "
        f"{b} x {s}): {json.dumps(TUNED_BWD_KNOBS)} against no knob: loss "
        f"{out['tuned']['loss']!r} vs {out['baseline']['loss']!r}; gradients worst leaf "
        f"{errs['worst_leaf']:.3e} ({errs['worst_path']}; tol {TUNED_BWD_LEAF_RATIO} x the "
        f"floor's), whole {errs['whole']:.3e} (tol 2 x the floor's and "
        f"{TUNED_BWD_WHOLE_TOL}); two blocks of 1,024 against none (floor): worst leaf "
        f"{floor['worst_leaf']:.3e} ({floor['worst_path']}), whole {floor['whole']:.3e}; one "
        f"layer's attention backward on random bf16 inputs, normwise (tol {TUNED_LAYER_TOL}): "
        f"{json.dumps(layer)}; max_memory_allocated tuned {out['tuned']['peak_gib']:.3f} / "
        f"two blocks {out['floor']['peak_gib']:.3f} / baseline "
        f"{out['baseline']['peak_gib']:.3f} GiB, above the parameters and state: tuned "
        f"{out['tuned']['peak_above_gib']:.3f} GiB, two blocks "
        f"{out['floor']['peak_above_gib']:.3f} GiB, baseline "
        f"{out['baseline']['peak_above_gib']:.3f} GiB (P alone {p_bytes / 1e6:.0f} MB a "
        f"layer, f32); {out['tuned']['s']:.2f} / {out['floor']['s']:.2f} / "
        f"{out['baseline']['s']:.2f} s; {result['s']:.1f} s; card {nvidia_smi_line()}")
    if not out["tuned"]["loss"] == out["floor"]["loss"] == out["baseline"]["loss"]:
        raise AssertionError("tuned backward: the forward moved with the knobs")
    if not (errs["worst_leaf"] <= TUNED_BWD_LEAF_RATIO * floor["worst_leaf"]
            and errs["whole"] <= min(2 * floor["whole"], TUNED_BWD_WHOLE_TOL)):
        raise AssertionError(f"tuned backward: gradients {errs['worst_leaf']:.3e} apart at "
                             f"{errs['worst_path']}, {errs['whole']:.3e} whole; the floor "
                             f"{floor['worst_leaf']:.3e} and {floor['whole']:.3e}")
    return result


def decode_attention_flops(cfg, batch: int, cache: int) -> float:
    """The decode step's attention products over a whole cache of ``cache``
    slots, as the plain decode attention computes them (QKᵀ and PV, 2 B H S
    hd each, every layer); K3 takes only the valid slots."""
    return 4 * batch * cfg.n_heads * cache * cfg.resolved_head_dim * cfg.n_layers


def dryrun(root: Path, tresult: dict, serve_runs: dict, t_tuned: float) -> dict:
    """The dry-run phase: each of :data:`DRYRUN_CELLS` traced on ``meta``
    (:func:`start_dryruns`, collected in the train phase before its first
    timed step) under the H100's constants; its three terms and bound, the
    plain path's (which
    computes every masked pair and writes P), beside the card-active time
    the train and serve phases measured in this run. Gate 1: the measured
    time is not below the compute term of the card's own program: a train
    step's :func:`train_flops` (the pairs the mask keeps), the decode step's
    dry-run FLOPs less the attention over the whole cache
    (:func:`decode_attention_flops`), each at 989 TFLOP/s. Gate 2: a train
    step's dry-run FLOPs are at least :func:`train_flops`'s, the difference
    named by :func:`dryrun_difference`."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _cell_file

    t0 = time.perf_counter()
    measured = {TRAIN_ARCH: tresult["run"]["profile"]["card_active_ms_per_step"],
                **{n: m["run"]["profile"]["card_active_ms_per_step"]
                   for n, m in tresult["models"].items()},
                "llama-13b": serve_runs["llama-13b"]["decode_step"]["replayed"][
                    "card_active_ms_per_step"]}
    out = {}
    for arch, shape in DRYRUN_CELLS.items():
        r = json.loads(_cell_file(root, arch, shape, "local", ".json").read_text())
        rf = r["roofline"]
        ms = measured[arch]
        cfg = get_config(arch)
        kind, dims = shape.split(":")
        b, s = map(int, dims.split("x"))
        if kind == "train":
            model = train_flops(cfg, b, s)["flops"]
            card_flops, card_source = model, "train_flops"
        else:
            card_flops = rf["flops"] - decode_attention_flops(cfg, b, s)
            card_source = "the dry-run's less the attention over the whole cache"
        card_compute_ms = card_flops / BF16_FLOPS_PER_S * 1e3
        cell = {"compute_ms": 1e3 * rf["compute_s"], "memory_ms": 1e3 * rf["memory_s"],
                "collective_ms": 1e3 * rf["collective_s"], "bound_ms": 1e3 * rf["roofline_bound_s"],
                "bottleneck": rf["bottleneck"], "flops": rf["flops"], "hbm_bytes": rf["hbm_bytes"],
                "card_flops": card_flops, "card_compute_ms": card_compute_ms,
                "card_active_ms": ms, "trace_s": r["lower_s"]}
        line = (f"dryrun {arch} {shape} (meta, a world of one, H100 constants), the plain "
                f"path's terms: compute {cell['compute_ms']:.4f} ms ({rf['flops'] / 1e12:.4f} "
                f"TFLOP), memory {cell['memory_ms']:.4f} ms ({rf['hbm_bytes'] / 1e9:.3f} GB "
                f"materialised), collective {cell['collective_ms']:.4f} ms, bound "
                f"{cell['bound_ms']:.4f} ms by {rf['bottleneck']}; the card's compute term "
                f"{card_compute_ms:.4f} ms ({card_flops / 1e12:.4f} TFLOP, {card_source}); card "
                f"active {ms:.4f} ms measured in this run ({ms / card_compute_ms:.2f}x the "
                f"card's compute term, {ms / cell['bound_ms']:.2f}x the plain path's bound); "
                f"traced in {r['lower_s']} s")
        if ms < card_compute_ms:
            raise AssertionError(f"dryrun {arch}: the card's {ms} ms beat its compute term "
                                 f"{card_compute_ms} ms")
        if kind == "train":
            cell["difference"] = dryrun_difference(cfg, b, s, rf["flops"], model)
            line += (f"; FLOPs {rf['flops'] / 1e12:.4f} T >= train_flops' "
                     f"{model / 1e12:.4f} T by " + ", ".join(
                         f"{k} {v / 1e12:.4f} T" for k, v in cell["difference"].items()))
            if rf["flops"] < model:
                raise AssertionError(f"dryrun {arch}: {rf['flops']} FLOPs below train_flops' "
                                     f"{model}")
        log(line)
        out[arch] = cell
    t_wait = tresult["dryrun_traces"]["wait_s"]
    wall = time.perf_counter() - t0 + t_tuned + t_wait
    log(f"dryrun phase: {wall:.1f} s (the traces' wait after the train phase's checks, "
        f"which they ran beside, {t_wait:.1f} s; the tuned backward {t_tuned:.1f} s)")
    return {"cells": out, "s": wall}


def train(dev, before_timed: Callable[[], dict]) -> dict:
    """Training on the card: K1's and K2's Functions alone, the f32 family
    checks and the refusals; ``before_timed()`` (kept as
    ``result["dryrun_traces"]``); then qwen1.5-0.5b at full width through
    ``repro_torch.launch.train``'s ``Trainer`` (bf16, AdamW, the controller,
    a checkpoint every 10 steps into a temporary directory; its step replayed
    from a CUDA graph after ``trainer.WARMUP`` eager steps), its step 0 held
    to the plain path, its launches counted, both resumes checked, its
    replayed step timed and profiled; then an eager run from the same seed,
    which the graphed run is held to and timed beside (:func:`eager_run`,
    :func:`hold_to_eager`), the step bounded, and the distributed step held
    to the eager run; then :func:`train_model` for each of TRAIN_MODELS."""
    import shutil
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import WARMUP
    from repro_torch.train.tree import leaves as tree_leaves

    t_phase = time.perf_counter()
    result = {"functions": check_train_functions(dev)}
    result["f32"] = {name: train_family_f32(name, dev) for name in TRAIN_F32_MODELS}
    result["refusals"] = train_refusals(dev)
    result["models"] = {}
    log(f"train functions, f32 families and refusals: {time.perf_counter() - t_phase:.1f} s")
    result["dryrun_traces"] = before_timed()

    t_qwen = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    batch, seq = TRAIN_BATCH
    root = Path(tempfile.mkdtemp(prefix="repro_train_"))
    timings = {"save": [], "restore": []}
    originals = (ckpt.save, ckpt.restore)

    def timed_call(kind, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            timings[kind].append(time.perf_counter() - t0)
            return out
        return wrapper

    ckpt.save, ckpt.restore = timed_call("save", ckpt.save), timed_call("restore", ckpt.restore)
    try:
        def trainer_at(directory, every=TRAIN_RUN["checkpoint_every"]):
            tc = launch_train.TrainerConfig(steps=TRAIN_RUN["steps"], checkpoint_every=every,
                                            checkpoint_dir=str(directory), lr=TRAIN_RUN["lr"])
            return launch_train.Trainer(cfg, tc, global_batch=batch, seq_len=seq,
                                        controller=True, device=dev)

        trainer = trainer_at(root / "run")
        n_params = count_params(trainer.params)
        t0 = time.perf_counter()
        result["step0"] = step0_check(trainer, cfg, dev)
        log(f"train {cfg.name} step 0 checks: {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        report = trainer.run()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        wgmma = kernels.flash_attention.WGMMA_LAUNCHES
        peak = torch.cuda.max_memory_allocated(dev)
        summary = launch_train.summarize(trainer, report)
        steps = TRAIN_RUN["steps"]
        want = train_launches(cfg, steps)
        per_step = {k: n // steps for k, n in want.items() if n}
        if launches != want or wgmma != launches["flash_attention"]:
            raise AssertionError(f"train launches {launches} (tensor cores {wgmma}) != {want}")
        if not (report.steps_run == steps and all(map(math.isfinite, report.losses))):
            raise AssertionError(f"train run: {report}")
        log(f"train {cfg.name} full width ({n_params / 1e9:.3f} B parameters, bf16, batch "
            f"{batch} x {seq}, AdamW lr {TRAIN_RUN['lr']}, controller on): {steps} steps, "
            f"{report.replayed_steps} of them replayed from the CUDA graph, losses "
            f"{[round(x, 4) for x in report.losses]}; launches {launches} = {steps} x "
            f"{per_step} (forward 2 x {cfg.n_layers} + 1 norms and {cfg.n_layers} attentions, "
            f"the backward's per-layer recompute 2 x {cfg.n_layers} and {cfg.n_layers} more, "
            f"K2′'s two kernels once an attention; the capture none), all {wgmma} K2 launches on the tensor cores; summary "
            f"{json.dumps(summary)}")
        graphed = {"losses": report.losses, "checksum": checksum(trainer)}

        # resume 1: the finished directory
        fresh = trainer_at(root / "run")
        rep = fresh.run()
        same = all(a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
                   for a, b in zip(tree_leaves({"p": trainer.params, "o": trainer.opt_state}),
                                   tree_leaves({"p": fresh.params, "o": fresh.opt_state})))
        if not (rep.resumed_from == steps and rep.steps_run == 0 and same):
            raise AssertionError(f"resume from step {steps}: {rep}, state equal: {same}")
        del fresh
        # resume 2: restarted from the step-10 checkpoint (the run's own files)
        mid = TRAIN_RUN["checkpoint_every"]
        from10 = root / "from10"
        from10.mkdir()
        (from10 / f"step_{mid:08d}").symlink_to(root / "run" / f"step_{mid:08d}")
        (from10 / "LATEST").write_text(f"step_{mid:08d}")
        again = trainer_at(from10, every=10 ** 9)
        rep2 = again.run()
        diffs = [abs(a - b) / abs(b) for a, b in zip(rep2.losses, report.losses[mid:])]
        bitwise = all(torch.equal(a.detach(), b.detach())
                      for a, b in zip(tree_leaves(trainer.params), tree_leaves(again.params)))
        if not (rep2.resumed_from == mid and len(diffs) == steps - mid
                and rep2.replayed_steps == steps - mid - WARMUP
                and max(diffs) <= RESUME_RTOL):
            raise AssertionError(f"resume from step {mid}: {rep2.losses} vs "
                                 f"{report.losses[mid:]}")
        del again
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train resume: from step {steps}, steps_run 0 and parameters and optimizer state "
            f"equal byte for byte; from step {mid} ({rep2.replayed_steps} steps replayed from "
            f"the restart's own graph), steps {mid + 1}-{steps} losses within "
            f"{max(diffs):.2e} relative (tol {RESUME_RTOL}), final parameters "
            f"{'equal' if bitwise else 'not equal'} bit for bit; save "
            f"{[round(t, 3) for t in timings['save']]} s, restore "
            f"{[round(t, 3) for t in timings['restore']]} s")

        # the step: replayed beside eager, the card's share of each, the parts
        # and the bound
        graphed.update(replayed_steps(trainer, report, dev, steps, per_step))
        del trainer
        eager = eager_run(cfg, dev, batch, seq, steps)
        held = hold_to_eager(cfg.name, graphed, eager, lambda: eager_run(
            cfg, dev, batch, seq, steps, measure=False)["losses"])
        log(f"train {cfg.name} graphed vs eager ({steps} steps from seed 0, one after the "
            f"other): {held_line(held)}")
        prof, med = graphed["profile"], graphed["median_ms"]
        flops = train_flops(cfg, batch, seq)
        opt_bytes = 30 * n_params
        bound = max((flops["flops"] / BF16_FLOPS_PER_S * 1e3, "operations"),
                    (opt_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
        result["run"] = {
            "losses": report.losses, "launches": launches, "wgmma": wgmma,
            "median_step_ms": med, "tokens_per_s": batch * seq / (med / 1e3),
            "peak_gib": peak / 2**30,
            "card_idle_share": prof["idle_share"], "profile": prof,
            "capture_step_ms": graphed["capture_step_ms"],
            "replayed_steps": report.replayed_steps, "held_to_eager": held,
            "eager": {k: v for k, v in eager.items() if k != "checksum"},
            "flops": flops, "flop_rate_tflops": flops["flops"] / med / 1e9,
            "mfu": flops["flops"] / (med / 1e3) / BF16_FLOPS_PER_S,
            "optimizer_bytes": opt_bytes, "bound_ms": bound[0], "bound_by": bound[1],
            "save_s": timings["save"], "restore_s": timings["restore"], "summary": summary,
            "resume_max_rel": max(diffs), "resume_bitwise": bitwise,
        }
        log(step_line(cfg.name, batch, seq, steps, graphed, eager, flops, bound, peak / 2**30)
            + f" ({flops['layer_matmul_params'] / 1e6:.1f} M layer matmul parameters + the "
              f"tied head; FLOPs {flops['flops'] / BF16_FLOPS_PER_S * 1e3:.3f} ms, the "
              f"optimizer's 30 B a parameter {opt_bytes / 1e9:.2f} GB "
              f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train {cfg.name}: {time.perf_counter() - t_qwen:.1f} s")
        # the sharded step, graphed, is held to the LOCAL eager run and to an
        # eager sharded run, and timed beside the LOCAL replayed step
        result["dist"] = distributed_step(
            cfg, dev, {"losses": eager["losses"], "per_step": per_step,
                       "step_s": eager["step_s"], "replayed_ms": med,
                       "replayed_ops": prof["device_ops_per_step"]}, root / "run")
    finally:
        ckpt.save, ckpt.restore = originals
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    for name in TRAIN_MODELS:
        result["models"][name] = train_model(name, dev)
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    return result


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

    t_phase = time.perf_counter()
    errs = check_kernels(dev)
    log(f"kernels vs plain (bf16 per element, |err| <= {BF16_TOL} * (1 + |plain|)): "
        f"max abs err at the main shapes {errs}")
    errs.update(check_recurrent_kernels(dev))
    log(f"recurrent kernels vs plain (f32 per element, |err| <= tol * (1 + |plain|), "
        f"tol {SSM_TOL} for ssm_scan, {WKV_TOL} for wkv6): max abs err at the decode "
        f"step's shape {{'ssm_scan': {errs['ssm_scan']}, 'wkv6': {errs['wkv6']}}}")
    bwd = check_recurrent_backward(dev)
    errs.update(bwd)
    log(f"recurrent backward kernels vs plain backwards (f32 per element, |err| <= tol * "
        f"(1 + |plain|), tol {SSM_BWD_TOL} for ssm_scan_bwd, {WKV_BWD_TOL} for wkv6_bwd; "
        f"every case twice, the same bits): max abs err at the training shapes {bwd}")
    for name, used in LIMIT_USED.items():
        log(f"  {name}: {used:.4f} of the limit at the worst element")
    times = time_kernels(dev)
    times.update(time_recurrent_kernels(dev))
    times.update(time_recurrent_backward(dev))
    log_times(times)
    log(f"kernel checks and timings phase: {time.perf_counter() - t_phase:.1f} s")

    # full width, bf16, random weights drawn on the card; each model is
    # freed before the next is made
    t_phase = time.perf_counter()
    runs = [serve_model(name, dev) for name in SERVE_MAX_SEQ]
    for name in DENSE_LOGIT_MODELS:
        dense_logits(name, dev)
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    presult = pool(dev)
    log(f"pool phase: {time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory(prefix="repro_dryrun_") as dry_root:
        procs = start_dryruns(Path(dry_root))
        try:
            tresult = train(dev, lambda: collect_dryruns(procs))
        finally:
            stop(procs)
        dryrun(Path(dry_root), tresult, dict(zip(SERVE_MAX_SEQ, runs)),
               tresult["models"][TUNED_BWD_ARCH]["tuned_backward"]["s"])

    t_phase = time.perf_counter()
    wresult, wtimes = whatif(dev)
    log(f"what-if phase: {time.perf_counter() - t_phase:.1f} s")
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
    abwd = tresult["functions"]["attention_backward"]
    times.update(abwd["kernels"])
    errs.update(abwd["errors"])
    # each main path ran with the counts set to 0 just before it
    launches = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    train_runs = [tresult["run"]] + [m["run"] for m in tresult["models"].values()]
    wgmma_launches = sum(r["flash_wgmma_launches"] for r in runs) + sum(
        r["wgmma"] for r in train_runs)
    train_launches_sum = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    for r in train_runs:
        for name, n in r["launches"].items():
            train_launches_sum[name] += n
    for counts in [r["launches"] for r in runs] + [r["spill"]["launches"] for r in runs] + [
            presult["launches"], train_launches_sum, tresult["dist"]["train"]["launches"],
            wresult["launches"], wresult["search"]["launches"], wresult["dist"]["launches"],
            wresult["host_paths"]["launches"], lresult["launches"]]:
        for name, n in counts.items():
            launches[name] += n
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"a kernel was launched no time on its main path: {launches}")
    rows = []
    for name, t in {**times, **wtimes}.items():
        lib = t["library"]
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES.get(name, name)}.cu",
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
        if train_launches_sum[name]:
            row["launches_train"] = train_launches_sum[name]
        if name in tresult["functions"]["times"]:
            row["train"] = tresult["functions"]["times"][name]
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
