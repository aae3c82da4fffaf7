"""Live serving engine on PyTorch: continuous batching + execution-idle
telemetry + the Algorithm-1 controller.

Runs a real model with fixed decode slots: prefill admits a request (padded
to a bucket), its KV cache is spliced into a free slot, and one batched
``decode_step`` advances every slot per tick — inactive slots are computed
and ignored. The engine drives the RuntimeSampler/Algorithm-1 controller
stack, so the paper's technique runs in the real serving path.

It follows the JAX package's engine tick for tick (the tests hold the greedy
tokens to it), including the shared cache ``len``: a prefill does not move
it, every tick with an active slot advances it, and it never resets.

On the card the engine captures its two step functions into CUDA graphs
when it is made, as the reference jit-compiles them: the decode step on the
engine's own cache and the prefill at its one bucket. Each tick copies its
tokens into the graph's input, replays it and reads the logits from its
output; the greedy argmax and its one copy to the host stay outside. A
capture that fails raises: there is no eager fallback on the card. On the
CPU both steps run eagerly.

On the card each prefill and decode phase ends with a synchronisation, so
the sampler's wall-clock phases — and hence the telemetry rows and the
controller's decisions — cover the card's time, not just the launches.

``submit`` and ``decode_tick`` open :func:`repro_torch.obs.span` spans, which
cost a check each unless obs is enabled or a profiler runs (then they land
in its trace, on the kernels' clock): ``engine.submit`` (attributes
``req_id``, ``slot``) over ``engine.stage`` (the prompt padded and copied to
the card), ``engine.prefill`` (the phase: its events, the graph's replay,
the synchronisation), ``engine.splice_cache`` and ``engine.first_token``
(the argmax and its copy to the host); ``engine.decode_tick`` over
``engine.stage``, ``engine.decode``, ``engine.read_tokens`` (the argmax and
its copy to the host) and ``engine.controller`` (the signals and Algorithm
1's step). ``decode_tick``'s own time outside them is the slots'
bookkeeping.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ExecutionIdleController
from repro_torch.core.power_model import SimulatedDevice, get_platform
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.graphs import StepGraph
from repro_torch.models import api
from repro_torch.serving.latency import LatencyStats, Request
from repro_torch.telemetry.sampler import RuntimeSampler


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 4
    max_seq_len: int = 256
    prefill_bucket: int = 32
    eos_token: int = 1
    max_new_tokens: int = 32
    controller: bool = False
    platform: str = "h100"
    device: str = "cuda"


#: eager runs of each step function on the capture stream before its capture
WARMUP_RUNS = 2


def clone_cache(cache):
    """A copy of a cache dict (nested dicts and lists of tensors) in new
    tensors."""
    if isinstance(cache, dict):
        return {k: clone_cache(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [clone_cache(v) for v in cache]
    return cache.clone()


@dataclasses.dataclass
class SlotState:
    active: bool = False
    request: Request | None = None
    generated: int = 0
    last_token: int = 0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, ec: EngineConfig):
        self.torch_device = resolve_device(ec.device)
        if self.torch_device.type == "cuda":
            # build or load the kernels now, not inside the first prefill's
            # telemetry phase
            _build.library()
        cfg.validate()
        self.cfg = cfg
        self.params = params
        self.ec = ec
        self.bucket = min(ec.prefill_bucket, ec.max_seq_len)
        self.slots = [SlotState() for _ in range(ec.n_slots)]
        #: the engine's cache; its tensors are never replaced, only written
        #: (the decode graph was captured on them)
        self.cache = api.init_cache(cfg, ec.n_slots, ec.max_seq_len,
                                    self.torch_device)
        self.graphs: dict[str, StepGraph] = {}
        if self.torch_device.type == "cuda":
            self._capture()
        self.device = SimulatedDevice(get_platform(ec.platform))
        self.sampler = RuntimeSampler(self.device, job_id=1)
        self.controller = (ExecutionIdleController(self.device)
                           if ec.controller else None)
        self.completed: list[Request] = []
        #: time of each prefill / decode phase in ms: CUDA events on the
        #: card, the host clock on the CPU
        self.phase_ms: dict[str, list[float]] = {"prefill": [], "decode": []}

    # ------------------------------------------------------------------ #
    def _decode_eager(self, tokens: torch.Tensor) -> torch.Tensor:
        _, logits = api.decode_step(self.params, self.cache, tokens, self.cfg)
        return logits

    def _prefill_eager(self, tokens: torch.Tensor):
        return api.prefill(self.params, tokens, self.cfg)

    def _capture(self) -> None:
        """Capture the decode step (on the engine's cache, ``(n_slots, 1)``
        tokens) and the prefill (``(1, bucket)`` tokens) into one CUDA graph
        each.

        Each first runs eagerly on the capture stream, so that cuBLAS's
        handle and workspace for that stream, decode attention's tickets, the
        kernel library and the launch plans exist before capture; the decode
        step runs on a clone of the cache, since an eager step writes keys,
        values, states and ``len``, and the clone is freed before capture.
        Capture itself launches nothing, so it leaves the real cache as it
        was. A failure raises and leaves the engine unusable."""
        dev = self.torch_device
        stream = torch.cuda.Stream(dev)
        decode_in = torch.zeros((self.ec.n_slots, 1), dtype=torch.long, device=dev)
        prefill_in = torch.zeros((1, self.bucket), dtype=torch.long, device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            scratch = clone_cache(self.cache)
            for _ in range(WARMUP_RUNS):
                api.decode_step(self.params, scratch, decode_in, self.cfg)
                self._prefill_eager(prefill_in)
            del scratch
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graphs["decode"] = StepGraph(lambda ins: self._decode_eager(ins["tokens"]),
                                          {"tokens": decode_in}, stream)
        self.graphs["prefill"] = StepGraph(lambda ins: self._prefill_eager(ins["tokens"]),
                                           {"tokens": prefill_in}, stream)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One batched decode step on the engine's cache: (n_slots, 1)
        tokens, logits (n_slots, 1, V). On the card a replay of the decode
        graph, whose logits tensor the next replay overwrites."""
        if "decode" in self.graphs:
            return self.graphs["decode"]({"tokens": tokens})
        return self._decode_eager(tokens)

    def prefill(self, tokens: torch.Tensor):
        """The prefill of (1, bucket) tokens: (a one-row cache, logits
        (1, 1, V)). On the card a replay of the prefill graph, whose outputs
        the next replay overwrites."""
        if "prefill" in self.graphs:
            return self.graphs["prefill"]({"tokens": tokens})
        return self._prefill_eager(tokens)

    @contextlib.contextmanager
    def _phase(self, name: str, compute_util: float,
               hbm_util: float) -> Iterator[None]:
        """A sampler phase that ends only when the card's work has ended,
        inside the span ``engine.<name>``."""
        with self.sampler.phase(name, compute_util=compute_util,
                                hbm_util=hbm_util), obs.span(f"engine.{name}"):
            if self.torch_device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                end.synchronize()
                self.phase_ms[name].append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                yield
                self.phase_ms[name].append((time.perf_counter() - t0) * 1e3)

    def _controller_signals(self) -> dict[str, float] | None:
        """Full scaled signal row for Algorithm 1 (§5.3), or None before the
        first telemetry row flushes.

        Activity percentages become fractions in [0, 1]; communication stays
        GB/s. NaN (signal unavailable on this platform) is dropped so the
        controller omits it rather than treating it as violated.
        """
        row = self.sampler.last_row()
        if row is None:
            return None
        signals: dict[str, float] = {}
        for k in ("sm", "tensor", "fp16", "fp32", "fp64", "dram"):
            v = float(row[k])
            if not np.isnan(v):
                signals[k] = v / 100.0
        for k in ("pcie_tx", "pcie_rx", "nvlink_tx", "nvlink_rx",
                  "ici_tx", "ici_rx"):
            v = float(row[k])
            if not np.isnan(v):
                signals[k] = v
        return signals

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if not s.active:
                return i
        return None

    def _splice_cache(self, slot: int, new_cache: dict) -> None:
        """Copy a single-sequence prefill cache into row ``slot`` of every
        per-sequence leaf, zeroing the rest of the row where the engine's
        leaf is longer, as the reference's zero-padded update does. The
        shared ``len`` is left alone, as in the reference."""
        rows = zip(api.cache_rows(self.cfg, self.cache),
                   api.cache_rows(self.cfg, new_cache))
        for (dst, axis), (src, _) in rows:
            row, part = dst.select(axis, slot), src.select(axis, 0)
            if part.shape != row.shape:
                row.zero_()
                row = row[tuple(slice(0, n) for n in part.shape)]
            row.copy_(part)

    def submit(self, request: Request, prompt_tokens: np.ndarray) -> bool:
        """Prefill + admit into a slot. Returns False if no slot free."""
        with obs.span("engine.submit", req_id=request.req_id) as sp:
            slot = self._free_slot()
            if slot is None:
                return False
            sp.set(slot=slot)
            with obs.span("engine.stage"):
                bucket = self.bucket
                toks = np.zeros((1, bucket), np.int64)
                n = min(len(prompt_tokens), bucket)
                toks[0, -n:] = prompt_tokens[-n:]
                tokens = torch.from_numpy(toks).to(self.torch_device)
            with self._phase("prefill", compute_util=0.9, hbm_util=0.4):
                new_cache, logits = self.prefill(tokens)
            with obs.span("engine.splice_cache"):
                self._splice_cache(slot, new_cache)
            with obs.span("engine.first_token"):
                first = int(torch.argmax(logits[0, -1]))
            s = self.slots[slot]
            s.active = True
            s.request = request
            s.generated = 0
            s.last_token = first
            request.start_s = self.sampler.now
            return True

    def decode_tick(self) -> int:
        """One batched decode step over all slots. Returns #active slots."""
        with obs.span("engine.decode_tick"):
            active = [i for i, s in enumerate(self.slots) if s.active]
            if active:
                self._decode_active(active)
            else:
                self.sampler.idle(1.0)
            self._control(idle=not active)
            return len(active)

    def _decode_active(self, active: list[int]) -> None:
        with obs.span("engine.stage"):
            toks = np.array([[s.last_token] for s in self.slots], np.int64)
            tokens = torch.from_numpy(toks).to(self.torch_device)
        with self._phase("decode", compute_util=0.5, hbm_util=0.9):
            logits = self.decode(tokens)
        with obs.span("engine.read_tokens"):
            next_tokens = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i in active:
            s = self.slots[i]
            s.last_token = int(next_tokens[i])
            s.generated += 1
            done = (s.generated >= min(s.request.output_tokens,
                                       self.ec.max_new_tokens)
                    or s.last_token == self.ec.eos_token)
            if done:
                s.request.finish_s = self.sampler.now
                self.completed.append(s.request)
                s.active = False
                s.request = None

    def _control(self, idle: bool) -> None:
        """Algorithm 1's step on the newest telemetry row. Before the first
        row flushes (sub-second warm decode ticks) a tick that decoded skips
        the step — fabricated zeros would read as low activity and downscale
        clocks mid-decode — and an idle tick steps on zero activity."""
        if self.controller is None:
            return
        with obs.span("engine.controller"):
            sig = self._controller_signals()
            if sig is None and idle:
                sig = {"sm": 0.0, "dram": 0.0}
            if sig is not None:
                self.controller.step(self.sampler.now, sig)

    # ------------------------------------------------------------------ #
    def run(self, requests: list[Request], prompts: dict[int, np.ndarray],
            max_ticks: int = 10_000, store=None, host: str = "host0",
            drain_every_s: float = 60.0) -> LatencyStats:
        """Replay: submit on arrival (engine time), decode until drained.

        With ``store`` (a :class:`~repro_torch.telemetry.storage.TelemetryStore`)
        the sampler drains its buffered 1 Hz rows into a shard every
        ``drain_every_s`` of engine time (plus once at the end), so long
        replays keep peak telemetry memory bounded by one drain window
        instead of materializing the full run — read it back with the
        streaming ``analyze_store`` / ``run_sweep`` paths.
        """
        self.sampler.load_program()
        pending = sorted(requests, key=lambda r: r.arrival_s)
        idx = 0
        next_drain = self.sampler.now + drain_every_s
        for _ in range(max_ticks):
            while idx < len(pending) and pending[idx].arrival_s <= self.sampler.now:
                if self.submit(pending[idx], prompts[pending[idx].req_id]):
                    idx += 1
                else:
                    break
            n_active = self.decode_tick()
            if store is not None and self.sampler.now >= next_drain:
                self.sampler.drain_to(store, host=host, flush_manifest=False)
                next_drain = self.sampler.now + drain_every_s
            if idx >= len(pending) and n_active == 0:
                break
        self.sampler.unload_program()
        if store is not None:
            self.sampler.drain_to(store, host=host, flush_manifest=False)
            store.save_manifest()
        return LatencyStats.of(self.completed)
