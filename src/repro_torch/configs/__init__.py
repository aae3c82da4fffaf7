"""Architecture registry of the port: the dense, moe, hybrid and rwkv
families.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` returns a reduced same-family config for CPU
tests (small layers/width/experts/vocab), exactly as the JAX package reduces
it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import (gemma_2b, granite_3_8b, granite_moe_3b_a800m,
                                 hymba_1_5b, llama_13b, qwen1_5_0_5b, qwen1_5_4b,
                                 rwkv6_3b)

ARCHS: dict[str, ModelConfig] = {
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    # the paper's own serving model (trace replay, §2.3)
    "llama-13b": llama_13b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    try:
        cfg = ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}") from None
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: tiny width/depth/vocab/experts."""
    cfg = get_config(arch)
    n_kv = min(cfg.n_kv_heads, 2)
    n_heads = n_kv * min(cfg.q_per_kv, 2)
    d_model = 64
    updates: dict[str, object] = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads if cfg.head_dim is None else 32,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.is_moe:
        updates.update(n_experts=4, top_k=2, d_expert=32,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.family == "rwkv":
        updates.update(rwkv_head_size=16, rwkv_decay_lora=8, rwkv_mix_lora=8)
    if cfg.family == "hybrid":
        updates.update(ssm_state=8, d_inner=128, window=16, global_layers=(0,))
    return dataclasses.replace(cfg, **updates)
