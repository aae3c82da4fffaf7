"""Serving in a closed loop: one general driver for every serving mix.

A mix (``traffic/<name>.json``, ``"kind": "serve"``) gives the engine's
settings, the number of clients and the lognormal lengths of prompts and
outputs. The lengths are a fixed pool, the lognormal's quantiles at
``(i + 0.5) / pool``, the same for every seed; the requests take the pool's
lengths in blocks, each block every length once in an order drawn from the
seed, and the seed draws the prompts' tokens. So two seeds send the same
work in another order, and a window, which goes through several blocks,
holds nearly the same lengths whatever the seed.
Each client sends its next request as soon as its last one has completed.

Set-up makes the weights on the card from the seed, builds the engine (which
captures its decode and prefill graphs), advances the engine's shared cache
position to ``max_seq_len`` (where a serving engine stays once it has
decoded that many ticks: every cache slot in use), sends every client a
first request whose output is cut to a share of its length (so completions
are spread as in a loop that has run a while), and runs ``warmup_ticks``
ticks. The window then drives ``ServingEngine.submit`` and
``ServingEngine.decode_tick`` on the wall clock, in the order
``ServingEngine.run`` calls them: every request waiting is admitted, then one
decode tick. Once the window has closed, a sample of the requests it
finished, drawn from the seed with the longest among them, is replayed
through the configuration's reference.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time

import numpy as np
import torch

from perfbench.lib import compare, weights
from perfbench.lib.trace import Tracer


@dataclasses.dataclass
class Sent:
    """One request as its client saw it, on the host clock."""
    index: int
    client: int
    prompt: np.ndarray
    sent: float
    first: float = math.nan          # the first token on the host
    last: float = math.nan           # the last token on the host
    tokens: list = dataclasses.field(default_factory=list)
    positions: list = dataclasses.field(default_factory=list)
    request: object = None


#: tokens of the seed's stream that prompts are cut from
STREAM = 1 << 16


def length_pool(spec: dict, n: int, floor: int) -> np.ndarray:
    """``n`` lengths at the lognormal's quantiles (i + 0.5) / n."""
    nd = statistics.NormalDist(math.log(spec["median"]), spec["sigma"])
    return np.array([max(floor, int(math.exp(nd.inv_cdf((i + 0.5) / n)))) for i in range(n)])


class Traffic:
    """The mix's requests in the order they are sent. The requests go in
    blocks of ``pool``: each block holds every length of the pool once, in
    an order of its own drawn from (seed, block); request ``j`` also takes a
    slice of the seed's token stream for its prompt."""

    def __init__(self, mix: dict, seed: int, vocab: int, bucket: int):
        self.n = mix["pool"]
        self.prompt_pool = length_pool(mix["prompt_tokens"], self.n, 8)
        self.output_pool = length_pool(mix["output_tokens"], self.n, 1)
        self.stream = np.random.default_rng(seed).integers(1, vocab, size=STREAM + bucket,
                                                           dtype=np.int64)
        self.seed = seed
        self.bucket = bucket
        self.orders: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _order(self, j: int) -> tuple[int, int]:
        b, i = divmod(j, self.n)
        if b not in self.orders:
            rng = np.random.default_rng([self.seed, b])
            self.orders[b] = (rng.permutation(self.n), rng.permutation(self.n))
        return self.orders[b][0][i], self.orders[b][1][i]

    def prompt(self, j: int) -> np.ndarray:
        k = min(int(self.prompt_pool[self._order(j)[0]]), self.bucket)
        at = (j * 7919) % (len(self.stream) - self.bucket)
        return self.stream[at:at + k]

    def output(self, j: int) -> int:
        return int(self.output_pool[self._order(j)[1]])


def bucket_tokens(prompt: np.ndarray, bucket: int) -> np.ndarray:
    """The prompt as the engine prefills it: its last ``bucket`` tokens,
    left-padded with 0."""
    toks = np.zeros(bucket, np.int64)
    n = min(len(prompt), bucket)
    toks[bucket - n:] = prompt[len(prompt) - n:]
    return toks


class Loop:
    """The closed loop around one engine."""

    def __init__(self, engine, traffic: Traffic, tracer: Tracer, clock=time.perf_counter):
        from repro_torch.serving.latency import Request
        self.Request = Request
        self.engine = engine
        self.traffic = traffic
        self.tracer = tracer
        self.clock = clock
        self.sent: list[Sent] = []
        self.waiting: list[Sent] = []
        self.pos = int(engine.cache["len"])      # the engine's shared position
        self.ticks: list[dict] = []
        self.refused: list[Sent] = []

    def send(self, client: int, now: float, output: int | None = None) -> None:
        j = len(self.sent)
        out = self.traffic.output(j) if output is None else output
        s = Sent(j, client, self.traffic.prompt(j), now)
        s.request = self.Request(req_id=j, arrival_s=0.0,
                                 prompt_tokens=len(s.prompt), output_tokens=out)
        self.sent.append(s)
        self.waiting.append(s)

    def tick(self) -> None:
        eng, clock, span = self.engine, self.clock, self.tracer.span
        n_pre, n_dec = len(eng.phase_ms["prefill"]), len(eng.phase_ms["decode"])
        t0 = clock()
        while self.waiting:
            s = self.waiting[0]
            with span("submit"):
                ok = eng.submit(s.request, s.prompt)
            if not ok:
                self.refused.append(s)
                break
            self.waiting.pop(0)
            s.first = clock()
            slot = next(i for i, x in enumerate(eng.slots) if x.request is s.request)
            s.tokens.append(eng.slots[slot].last_token)
        active = [(i, self._by_request(x.request)) for i, x in enumerate(eng.slots) if x.active]
        with span("decode_tick"):
            n = eng.decode_tick()
        t1 = clock()
        if n:
            for i, s in active:
                s.tokens.append(eng.slots[i].last_token)
                s.positions.append(self.pos)
                if eng.slots[i].request is not s.request:
                    s.last = t1
                    with span("client"):
                        self.send(s.client, t1)
            self.pos += 1
        phases = (sum(eng.phase_ms["prefill"][n_pre:]) + sum(eng.phase_ms["decode"][n_dec:]))
        self.ticks.append(dict(start=t0, end=t1, tokens=n,
                               host_ms=(t1 - t0) * 1e3 - phases,
                               prefill_ms=eng.phase_ms["prefill"][n_pre:],
                               decode_ms=eng.phase_ms["decode"][n_dec:]))

    def _by_request(self, request) -> Sent:
        return self.sent[request.req_id]


def make_engine(cfg: dict, ref, mix: dict, seed: int, device: str):
    from perfbench.lib.cell import model_config, same_layout
    from repro_torch.models import api
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    mcfg = model_config(cfg)
    params = ref.empty_params(cfg, device)
    same_layout(params, api.abstract_params(mcfg))
    weights.fill(ref.fills(cfg, params), seed)
    ec = EngineConfig(device=device, **mix["engine"])
    return ServingEngine(mcfg, params, ec)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        clock=time.perf_counter, fault=None) -> dict:
    """One run of a serving cell: the loop, then the check. Returns the
    context the metric readers read."""
    cfg, ref, mix = cell.config, cell.reference, cell.traffic
    engine = make_engine(cfg, ref, mix, seed, device)
    if fault is not None:
        fault(engine)
    ec = engine.ec
    bucket = engine.bucket
    traffic = Traffic(mix, seed, cfg["vocab_size"], bucket)
    tracer = Tracer(trace)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    engine.cache["len"].fill_(ec.max_seq_len)
    engine.sampler.load_program()
    loop = Loop(engine, traffic, tracer, clock)
    now = clock()
    for c in range(mix["clients"]):
        loop.send(c, now, output=max(1, math.ceil((c + 0.5) / mix["clients"]
                                                  * traffic.output(c))))
    for _ in range(mix["warmup_ticks"]):
        loop.tick()
    sync()

    start = clock()
    end = start + seconds
    first_tick = len(loop.ticks)
    traced = mix["trace_ticks"]
    trace_from = None
    while clock() < end:
        if trace and trace_from is None and clock() >= start + seconds / 4:
            trace_from = len(loop.ticks)
            trace_pos = loop.pos
            tracer.start()
        loop.tick()
        if trace_from is not None and len(loop.ticks) == trace_from + traced:
            tracer.stop(sync)
    tracer.stop(sync)
    engine.sampler.unload_program()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    engine_pos = int(engine.cache["len"])

    done = [s for s in loop.sent if s.last >= start]
    check = check_served(cell, engine, done, seed, device)
    ctx = dict(cell=cell, window=(start, end), check=check,
               sent=loop.sent, ticks=loop.ticks[first_tick:], trace=tracer.trace,
               trace_pos=trace_pos if trace_from is not None else loop.pos,
               ec=ec, memory_peak_bytes=peak)
    checks = {"served_gap": (check["gap"], cell.limits["served_gap"]),
              "position": (abs(engine_pos - loop.pos), 0)}
    notes = [f"checked {check['rows']} requests, {check['tokens']} served tokens; "
             f"shared position {loop.pos}"]
    in_window = [s for s in loop.sent if start <= s.sent < end]
    refused = {id(s) for s in loop.refused}
    ctx.update(checks=checks, notes=notes, attempted=len(in_window),
               failed=sum(1 for s in in_window if id(s) in refused))
    return ctx


def sample(done: list[Sent], n: int, seed: int) -> list[Sent]:
    """``n`` of the finished requests drawn from the seed, the longest among
    them."""
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.tokens), -s.index))
    rest = [s for s in done if s is not longest]
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_logits(cell, rows: list[Sent], bucket: int, max_seq_len: int, seed: int,
                     device: str, mm=None) -> list[torch.Tensor]:
    """The reference's logits at every served token of ``rows``, in float32
    from the run's weights drawn again."""
    cfg, ref = cell.config, cell.reference
    params = ref.empty_params(cfg, device)
    weights.fill(ref.fills(cfg, params), seed)
    p32 = _to_f32(params)
    del params
    prompts = torch.tensor(np.stack([bucket_tokens(s.prompt, bucket) for s in rows]),
                           device=device)
    kw = {} if mm is None else {"mm": mm}
    with torch.no_grad():
        return ref.serve_logits(p32, prompts, [s.tokens for s in rows],
                                [s.positions for s in rows], cfg, max_seq_len, **kw)


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def free(engine) -> None:
    """Drop the program's state from the card before the reference runs."""
    engine.graphs.clear()
    engine.cache = engine.params = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_served(cell, engine, done: list[Sent], seed: int, device: str) -> dict:
    """Free the engine, then replay a sample of ``done`` through the
    reference: the widest gap of a served token and the sample's logits."""
    bucket, msl = engine.bucket, engine.ec.max_seq_len
    free(engine)
    rows = sample(done, cell.traffic["check_requests"], seed)
    if not rows:
        return dict(gap=math.inf, rows=0, tokens=0)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        logits = reference_logits(cell, rows, bucket, msl, seed, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    gaps = compare.served_gaps(logits, [s.tokens for s in rows])
    return dict(gap=max(gaps), rows=len(rows), tokens=sum(len(s.tokens) for s in rows),
                logits=logits, sample=rows)
