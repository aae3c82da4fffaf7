"""Architecture registry of the port: every family of the JAX package
(dense, moe, mla_moe, rwkv, hybrid, encdec, vlm).

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` returns a reduced same-family config for CPU
tests (small layers/width/experts/vocab), exactly as the JAX package reduces
it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (LM_SHAPES, SUBQUADRATIC_ARCHS,  # noqa: F401
                                      ModelConfig, ShapeSpec, cell_is_applicable)
from repro_torch.configs import (deepseek_v3_671b, gemma_2b, granite_3_8b,
                                 granite_moe_3b_a800m, hymba_1_5b, llama_3_2_vision_90b,
                                 llama_13b, qwen1_5_0_5b, qwen1_5_4b, rwkv6_3b,
                                 whisper_tiny)

ARCHS: dict[str, ModelConfig] = {
    "whisper-tiny": whisper_tiny.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "granite-moe-3b-a800m": granite_moe_3b_a800m.CONFIG,
    "rwkv6-3b": rwkv6_3b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "granite-3-8b": granite_3_8b.CONFIG,
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "llama-3.2-vision-90b": llama_3_2_vision_90b.CONFIG,
    # the paper's own serving model (trace replay, §2.3)
    "llama-13b": llama_13b.CONFIG,
}

#: the architectures of the dry-run's cells (the serving model is not one)
ASSIGNED_ARCHS: tuple[str, ...] = tuple(a for a in ARCHS if a != "llama-13b")


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
    if cfg.is_mla:
        updates.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                       qk_rope_dim=8, v_head_dim=16, mtp_depth=min(cfg.mtp_depth, 1))
    if cfg.family == "rwkv":
        updates.update(rwkv_head_size=16, rwkv_decay_lora=8, rwkv_mix_lora=8)
    if cfg.family == "hybrid":
        updates.update(ssm_state=8, d_inner=128, window=16, global_layers=(0,))
    if cfg.family == "encdec":
        updates.update(n_enc_layers=2, n_frames=16)
    if cfg.family == "vlm":
        updates.update(cross_every=2, n_vision_tokens=8,
                       n_layers=4)  # needs a multiple of cross_every
    return dataclasses.replace(cfg, **updates)
