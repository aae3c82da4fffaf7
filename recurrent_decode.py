#!/usr/bin/env python3
"""Card time of the port's recurrent kernels (K5, K6) where a decode step
runs them, on one NVIDIA GPU (an H100):

    python3 recurrent_decode.py [--src PATH] [--label NAME]

* rwkv6-3b and hymba-1.5b at full width and depth, random bf16 weights
  from seed 0: decode steps of 4 slots under ``torch.profiler``, the card
  time per step of K5 and K6 (as ``chip_smoke.profile_decode`` reads it),
  twice;
* rwkv6-3b's decode step captured in a CUDA graph and replayed, as the
  serving engine runs it: three replays under ``torch.profiler`` after a
  warm-up, the card time per step of K6 and the card's busy time beside the
  replay's time, twice (the capture is made here on the models' interface,
  so an earlier commit whose engine does not capture is measured the same
  way);
* K6 alone at rwkv6-3b's decode shape (4, 1, 40, 64) on 32 layers' states
  (84 MB, past the 50 MB L2), each carried in place, in four settings,
  each profiled over 3 passes of the 32 layers: back to back; after a read
  of 64 MB (``sum``), which leaves the state, the inputs and the kernel's
  code out of the L2 as the decode step's weight stream does; after that
  read and a copy of r, k, v and w, which the decode step's time-mix
  writes just before the kernel; and after all that and a wait on the host
  of 50 us, so that the kernel starts on an idle card, as the decode
  step's kernels do (the host sets its pace).

``--src`` runs another checkout's ``src`` (an earlier commit unpacked with
``git archive``), so two commits' kernels can be compared in one call; it
calls only the wrappers' and the models' interfaces, which both share.
Prints one line per reading and, last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

import chip_smoke as cs

MODELS = ("rwkv6-3b", "hymba-1.5b")
SLOTS = 4
LAYERS = 32
FLUSH_BYTES = 64 << 20


def kernel_ms(prof, pattern: str) -> tuple[float, int]:
    """Card ms and launches of the kernels whose name matches ``pattern``."""
    from torch.autograd import DeviceType

    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and re.search(pattern, e.key)]
    return (sum(e.self_device_time_total for e in hits) / 1e3,
            sum(e.count for e in hits))


def decode_steps(name: str, dev, label: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(name)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    cache = api.init_cache(cfg, SLOTS, cs.SERVE_MAX_SEQ[name], dev)
    tokens = torch.full((SLOTS, 1), 7, dtype=torch.long, device=dev)
    for _ in range(3):
        cache, _ = api.decode_step(params, cache, tokens, cfg)
    torch.cuda.synchronize()
    steps = 3
    for _ in range(2):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                cache, _ = api.decode_step(params, cache, tokens, cfg)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        busy, _ = kernel_ms(prof, ".")
        parts = []
        for kernel in ("ssm_scan_kernel", "wkv6_kernel"):
            ms, n = kernel_ms(prof, rf"repro::{kernel}")
            if n:
                parts.append(f"{kernel} {ms / steps:.5f} ms per step over {n // steps} launches "
                             f"({ms / n * 1e3:.3f} us a launch)")
        cs.log(f"{label} {name} decode step (profiled): " + "; ".join(parts)
               + f"; card busy {busy / steps:.4f} ms; wall {wall:.2f} ms")
    del params, cache
    torch.cuda.empty_cache()


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def replayed_steps(name: str, dev, label: str) -> None:
    """``name``'s decode step of 4 slots captured in one CUDA graph (after
    two eager steps on a clone of the cache, on the capture stream) and
    replayed: per step, the card time of the port's recurrent kernels and
    of all the card's work, under torch.profiler over 3 replays, and the
    replay's time by CUDA events (``chip_smoke.step_ms``); twice."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config(name)
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    cache = api.init_cache(cfg, SLOTS, cs.SERVE_MAX_SEQ[name], dev)
    tokens = torch.full((SLOTS, 1), 7, dtype=torch.long, device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        scratch = clone(cache)
        for _ in range(2):
            api.decode_step(params, scratch, tokens, cfg)
        del scratch
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        api.decode_step(params, cache, tokens, cfg)
    steps = 3
    for _ in range(2):
        replay_ms = cs.step_ms(graph.replay)
        prof = cs.profile_steps(graph.replay, steps)
        parts = [f"{kernel} {prof['repro_kernels_ms_per_step'][kernel]:.5f} ms per step over "
                 f"{prof['repro_launches_per_step'][kernel]:.0f} launches "
                 f"({prof['repro_kernels_ms_per_step'][kernel] / prof['repro_launches_per_step'][kernel] * 1e3:.3f} us a launch)"
                 for kernel in ("ssm_scan_kernel", "wkv6_kernel")
                 if kernel in prof["repro_kernels_ms_per_step"]]
        cs.log(f"{label} {name} decode step replayed from a CUDA graph (profiled): "
               + "; ".join(parts) + f"; card busy {prof['card_busy_ms_per_step']:.4f} ms; "
               f"replay {replay_ms:.4f} ms (CUDA events)")
    del graph, params, cache
    torch.cuda.empty_cache()


def wkv_settings(dev, label: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import rwkv6_scan as k6

    g = torch.Generator(device=dev).manual_seed(12)
    r0, k0, v0, w0, u = cs.wkv_args(g, dev, SLOTS, 1)
    heads = [x.transpose(1, 2) for x in (r0, k0, v0, w0)]
    fresh = [torch.empty_like(x) for x in (r0, k0, v0, w0)]
    fresh_heads = [x.transpose(1, 2) for x in fresh]
    states = torch.randn(LAYERS, SLOTS, 40, 64, 64, generator=g, device=dev)
    flush = torch.randn(FLUSH_BYTES // 4, generator=g, device=dev)

    def back_to_back(i):
        k6.wkv6(*heads, u, states[i], states[i])

    def after_read(i):
        flush.sum()
        k6.wkv6(*heads, u, states[i], states[i])

    def after_read_fresh(i, idle=False):
        flush.sum()
        for x, x0 in zip(fresh, (r0, k0, v0, w0)):
            x.copy_(x0)
        if idle:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 50e-6:
                pass
        k6.wkv6(*fresh_heads, u, states[i], states[i])

    for setting, fn in (("back to back", back_to_back), ("after a 64 MB read", after_read),
                        ("after a 64 MB read and fresh r, k, v, w", after_read_fresh),
                        ("after a 64 MB read, fresh r, k, v, w and an idle card",
                         lambda i: after_read_fresh(i, idle=True))):
        for i in range(LAYERS):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                for i in range(LAYERS):
                    fn(i)
            torch.cuda.synchronize()
        ms, n = kernel_ms(prof, r"repro::wkv6_kernel")
        cs.log(f"{label} wkv6 decode shape, {setting}: {ms / n * 1e3:.3f} us a launch "
               f"(profiled, {n} launches)")
    graph = cs.graph_ms(lambda it=iter(range(1 << 62)): back_to_back(next(it) % LAYERS))
    cs.log(f"{label} wkv6 decode shape, back to back in a 100-call graph: "
           f"{graph * 1e3:.3f} us a call")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=cs.ROOT / "src",
                    help="the checkout's src directory whose kernels to measure")
    ap.add_argument("--label", default="this", help="prefix of every line")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this sweep runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.library()
    replayed_steps("rwkv6-3b", dev, args.label)
    wkv_settings(dev, args.label)
    for name in MODELS:
        decode_steps(name, dev, args.label)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
