"""Marks on the card's timeline where each part of the train step begins
(``csrc/marks.cu``): one empty kernel a mark, launched on the current
stream, which a CUDA graph's capture records like any other launch.

``make_train_step``'s step and the sharded step call :func:`mark` with
``forward`` at their start, ``backward`` before ``torch.autograd.grad``,
``update`` before the optimizer's step and ``done`` before they return. In a
profiler's trace each is a kernel named ``repro::mark_<name>``; a reader
finds it by that substring, and the device operations between two marks
are that part of the step. Nothing marks the serving graphs: a mark a layer
would cost the decode step about 1%.

The marks are counted nowhere (``launch_counts`` holds the kernels that
compute), and on any device but CUDA (the CPU, ``meta``) :func:`mark` does
nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the marks, in the order a step launches them; the index is the C entry's code
MARKS = ("forward", "backward", "update", "done")


def mark(name: str, device: torch.device | str) -> None:
    """Launch the mark ``name`` on ``device``'s current stream (a CUDA
    device), or do nothing (any other)."""
    if name not in MARKS:
        raise ValueError(f"unknown mark {name!r}; the marks are {MARKS}")
    device = torch.device(device)
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_build.library().repro_mark(MARKS.index(name), stream), f"mark_{name}")
