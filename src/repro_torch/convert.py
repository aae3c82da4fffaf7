"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (nested
dicts and lists: the stacked ``(L, ...)`` layer layout, or hymba's list of
layers) and returns the same tree of torch tensors on ``device``, so tests
can hand both packages the same weights. Float32 leaves stay float32, as the
JAX package keeps some parameters in f32 under a bf16 model (hymba's
``a_log``, ``dt_bias``, ``d_skip``, ``beta_*``; RWKV's ``decay_base``, ``u``);
every other leaf is cast to ``cfg.dtype``. ``opt_state_from_jax`` carries
an optimizer state across the same way: the f32 master weights, AdamW's
moments or Adafactor's factored statistics, and the int32 step count, each
leaf in its own dtype. It never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import param_dtype


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device: torch.device | str = "cpu") -> dict:
    dt = param_dtype(cfg)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        keep_f32 = np.asarray(node).dtype == np.float32
        # via f32: numpy has no bfloat16 of its own, and bf16 -> f32 -> bf16
        # is exact
        arr = np.array(node, dtype=np.float32)
        return torch.from_numpy(arr).to(device=device,
                                        dtype=torch.float32 if keep_f32 else dt)

    return convert(np_params)


def opt_state_from_jax(np_state: dict, device: torch.device | str = "cpu") -> dict:
    """The JAX package's optimizer state (``adamw`` or ``adafactor``), as
    numpy, as the same tree of torch tensors on ``device``, each leaf in its
    numpy dtype (f32 statistics, an int32 ``count``)."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return torch.from_numpy(np.array(node)).to(device)

    return convert(np_state)
