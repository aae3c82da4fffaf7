#!/usr/bin/env python3
"""Card time of the port's recurrent backward kernels (K5′, the selective
scan's; K6′, the WKV recurrence's) at the training shapes, alone and inside
a train step, on one NVIDIA GPU (an H100):

    python3 recurrent_backward.py [--src PATH] [--label NAME]

* K5′ at hymba-1.5b's (B, S, I, N) = (2, 2048, 3200, 16) and K6′ at
  rwkv6-3b's (B, H, S, K) = (8, 40, 128, 64), from a zero initial state
  with no final-state gradient, as the losses call them: card time per call
  in a CUDA graph (``chip_smoke.graph_ms``), under the default plan and,
  where the checkout has ``backward_plan``, under every K5′ plan; beside
  chip_smoke.py's bound (each input read once, each output written once;
  26 / 15 operations per state entry and step at the float32 rate) and the
  plain backward's time. Then each kernel sustained for about a second (a
  replayed graph of 20 calls), its time a call beside the SM clock, power
  draw, power limit and temperature that ``nvidia-smi`` samples meanwhile.
* One hymba-1.5b train step (2 x 2,048 tokens) and one rwkv6-3b step
  (8 x 128) at full width, random bf16 weights from seed 0, through the
  trainer's step function (``for_arch``'s optimizer): after two warm-up
  steps, the step's time (CUDA events around each of 3 steps), and under
  ``torch.profiler`` (``chip_smoke.profile_steps``, 3 steps) the backward
  kernel's card time a launch and the card's busy time, with the same
  ``nvidia-smi`` samples beside.

``--src`` runs another checkout's ``src`` (an earlier commit unpacked with
``git archive``), so two commits' kernels can be compared in one call; it
calls only the wrappers' and the trainer's interfaces, which both share.
Prints one line per reading and, last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import threading
from pathlib import Path

import chip_smoke as cs

SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")
#: the training shapes: hymba-1.5b 2 x 2,048 tokens, rwkv6-3b 8 x 128
TRAIN = {"hymba-1.5b": dict(batch=2, seq=2048, kernel="ssm_scan_bwd_kernel"),
         "rwkv6-3b": dict(batch=8, seq=128, kernel="wkv6_bwd_kernel")}


class Smi:
    """``nvidia-smi`` sampling the card every 50 ms in a child process while
    the ``with`` block runs; ``summary()`` gives each field's median, min
    and max (MHz, W, W, degrees C) over the samples."""

    def __enter__(self):
        self.rows: list[list[float]] = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "50", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                pass

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False

    def summary(self) -> str:
        if not self.rows:
            return "nvidia-smi: no samples"
        cols = list(zip(*self.rows))
        return f"{len(self.rows)} nvidia-smi samples: " + ", ".join(
            f"{name} median {statistics.median(c):g} (min {min(c):g}, max {max(c):g})"
            for name, c in zip(SMI_FIELDS, cols))


def sustained_ms(fn, seconds: float = 1.0, calls: int = 20) -> tuple[float, str]:
    """``calls`` calls of ``fn`` captured in one CUDA graph and replayed for
    about ``seconds``: the card time a call by CUDA events over all the
    replays, and the nvidia-smi samples taken meanwhile."""
    import time

    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with Smi() as smi:
        t0 = time.perf_counter()
        start.record()
        replays = 0
        while time.perf_counter() - t0 < seconds:
            graph.replay()
            replays += 1
            if replays % 5 == 0:
                torch.cuda.synchronize()
        end.record()
        end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls), smi.summary()


def alone(dev, label: str) -> None:
    import torch
    from repro_torch.kernels import rwkv6_scan as k6
    from repro_torch.kernels import ssm_scan as k5

    g = torch.Generator(device=dev).manual_seed(14)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    for name, kernel, plain, args, ops_per in (
            ("ssm_scan_bwd", k5.ssm_scan_backward, k5.ssm_scan_backward_plain,
             cs.ssm_bwd_args(g, dev, 2, 2048, False, False), 26),
            ("wkv6_bwd", k6.wkv6_backward, k6.wkv6_backward_plain,
             cs.wkv_bwd_args(g, dev, 8, 128, False, False), 15)):
        grads = kernel(*args)
        want = plain(*args)
        err = max(float((x - w).abs().max()) for x, w in zip(grads, want))
        work = args[0].numel() * args[2].shape[-1]
        bound = cs.bound_ms(nbytes(*args, *grads), ops_per * work, cs.F32_OPS_PER_S)
        plain_ms = cs.cuda_ms(lambda: plain(*args), iters=2, warmup=1)
        ms = cs.graph_ms(lambda: kernel(*args), 10)
        cs.log(f"{label} time {name} [{', '.join(str(tuple(t.shape)) for t in args if t is not None)}"
               f" f32] card ms a call in a CUDA graph: kernel {ms:.5f}, bound {bound[0]:.5f} "
               f"({bound[1]}), plain {plain_ms:.3f}; max abs err vs plain {err:.3e}")
        if name == "ssm_scan_bwd" and hasattr(k5, "backward_plan"):
            for plan in cs.ssm_bwd_plans(2, 2048, 3200, 16):
                cs.log(f"{label} time {name} plan group={plan.group} segments={plan.segments}: "
                       f"{cs.graph_ms(lambda p=plan: kernel(*args, plan=p), 10):.5f} ms "
                       f"({cs.bwd_plan_str(plan)})")
        ms, smi = sustained_ms(lambda: kernel(*args))
        cs.log(f"{label} time {name} sustained (graph of 20 calls replayed ~1 s): {ms:.5f} ms "
               f"a call; {smi}")
        del grads, want, args
        gc.collect()
        torch.cuda.empty_cache()


def train_step(name: str, dev, label: str) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg, run = get_config(name), TRAIN[name]
    tc = launch_train.TrainerConfig(steps=5, checkpoint_dir=None, lr=cs.TRAIN_RUN["lr"])
    trainer = launch_train.Trainer(cfg, tc, global_batch=run["batch"], seq_len=run["seq"],
                                   controller=False, device=dev)
    batches = [trainer.dataset.device_batch_at(i, dev) for i in range(3)]
    step = iter(range(1 << 30))

    def one_step():
        trainer.params, trainer.opt_state, _ = trainer.step_fn(
            trainer.params, trainer.opt_state, batches[next(step) % len(batches)])

    with Smi() as smi:
        step_ms = cs.step_ms(one_step, steps=3, warmup=2)
        prof = cs.profile_steps(one_step, steps=3)
    kernel = run["kernel"]
    ms = prof["repro_kernels_ms_per_step"].get(kernel, 0.0)
    n = prof["repro_launches_per_step"].get(kernel, 0.0)
    cs.log(f"{label} train step {name} ({run['batch']} x {run['seq']} tokens, bf16, full width): "
           f"{step_ms:.2f} ms a step (CUDA events, 3 steps after 2); profiled: {kernel} "
           f"{ms:.3f} ms a step over {n:.0f} launches ({ms / max(n, 1):.4f} ms a launch), card busy "
           f"{prof['card_busy_ms_per_step']:.2f} ms, active {prof['card_active_ms_per_step']:.2f} "
           f"ms a step; {smi.summary()}")
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    alone(dev, args.label)
    for name in TRAIN:
        train_step(name, dev, args.label)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
