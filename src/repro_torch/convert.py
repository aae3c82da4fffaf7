"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (nested
dicts, the stacked ``(L, ...)`` layer layout) and returns the same tree of
torch tensors in ``cfg.dtype`` on ``device``, so tests can hand both packages
the same weights. It never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.dense import param_dtype


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device: torch.device | str = "cpu") -> dict:
    dt = param_dtype(cfg)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        # via f32: numpy has no bfloat16 of its own, and bf16 -> f32 -> bf16
        # is exact
        arr = np.array(node, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return convert(np_params)
