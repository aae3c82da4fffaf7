"""Uniform LM interface, dispatching on ``cfg.family``.

Only the dense family is ported; any other family raises.
"""
from __future__ import annotations

from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dense

_FAMILY_MODULES: dict[str, ModuleType] = {"dense": dense}


def family_module(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; ported: "
            f"{sorted(_FAMILY_MODULES)}") from None


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return family_module(cfg).init_params(gen, cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    return family_module(cfg).init_cache(cfg, batch, max_len, device)


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False):
    return family_module(cfg).prefill(params, tokens, cfg, plain=plain)


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    return family_module(cfg).decode_step(params, cache, tokens, cfg, plain=plain)
