"""One step function captured into a CUDA graph, with the launch counts kept
true across its capture and replays: the serving engine's decode step and
prefill (:mod:`repro_torch.serving.engine`) and the trainer's step
(:mod:`repro_torch.train.trainer`)."""
from __future__ import annotations

import torch

from repro_torch.kernels import captured_launches, count_replay


class StepGraph:
    """``fn(inputs)`` captured into one CUDA graph on ``stream``, ``inputs`` a
    dict of tensors at fixed addresses that the graph reads at every replay.

    A call copies its dict's tensors into ``inputs`` (one of another shape
    or dtype raises, since ``copy_`` would broadcast or cast), replays the
    graph and returns ``out``, what the captured call returned, which the
    next replay overwrites. ``launches`` is what one replay launches of each
    kernel (:func:`repro_torch.kernels.captured_launches`), added to the
    counters at every replay. The caller runs ``fn`` eagerly on ``stream``
    before, so that what a first call sets up (cuBLAS's handle and
    workspace for that stream, the kernel library, the launch plans) exists
    before capture. A capture or replay that fails raises."""

    def __init__(self, fn, inputs: dict[str, torch.Tensor], stream: torch.cuda.Stream):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        with captured_launches() as launches, torch.cuda.graph(self.graph, stream=stream):
            self.out = fn(inputs)
        self.launches = launches

    def __call__(self, inputs: dict[str, torch.Tensor]):
        like = {k: (tuple(v.shape), v.dtype) for k, v in self.inputs.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in inputs.items()}
        if got != like:
            raise ValueError(f"inputs {got}; the graph was captured for {like}")
        for k, buf in self.inputs.items():
            buf.copy_(inputs[k])
        self.graph.replay()
        count_replay(self.launches)
        return self.out
