"""Weights drawn on the device from the run's seed, in the served dtype.

A configuration's reference (``configs/<name>.py``) gives the parameter tree
(``empty_params``) and how each leaf is drawn, in blocks (``fills``). Each
block is drawn by its own generator, seeded from (seed, block index), with
one normal draw for all its random leaves, so any block can be drawn again
alone: the training check draws the first weights again a block at a time
to measure how far three steps moved them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def block_seed(seed: int, index: int) -> int:
    """A 63-bit seed for block ``index`` of the run seeded ``seed`` (any
    non-negative integer)."""
    words = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def draw_block(block: list[tuple], seed: int, index: int, device=None) -> list[torch.Tensor]:
    """The values of each leaf of ``block`` (``(leaf, init)`` pairs), new
    tensors of the leaves' shapes and dtypes on ``device`` (the leaves' by
    default; leaves on ``meta`` only give their shapes)."""
    dev = block[0][0].device if device is None else torch.device(device)
    counts = [math.prod(leaf.shape) if init[0] == "normal" else 0 for leaf, init in block]
    gen = torch.Generator(device=dev).manual_seed(block_seed(seed, index))
    draws = torch.randn(sum(counts), generator=gen, device=dev, dtype=torch.float32)
    out, at = [], 0
    for (leaf, init), n in zip(block, counts):
        if init[0] == "normal":
            out.append((draws[at:at + n].view(leaf.shape) * init[1]).to(leaf.dtype))
            at += n
        elif init[0] == "const":
            out.append(torch.full(leaf.shape, init[1], dtype=leaf.dtype, device=dev))
        elif init[0] == "log_arange":
            row = torch.log(torch.arange(1, init[1] + 1, dtype=torch.float32, device=dev))
            out.append(row.expand(leaf.shape).to(leaf.dtype).clone())
        else:
            raise ValueError(f"unknown init {init!r}")
    return out


def fill(blocks: list[list[tuple]], seed: int) -> None:
    """Draw every block of ``blocks`` into its leaves."""
    for i, block in enumerate(blocks):
        for (leaf, _), value in zip(block, draw_block(block, seed, i)):
            leaf.copy_(value)
