"""Model configuration dataclass: the fields of the JAX package's
``ModelConfig`` that the ported families (dense, moe, hybrid, rwkv) read.
Other families' fields come with the slice that ports the family."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "rwkv", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One decoder-only architecture; all attention is causal. Families
    reuse fields; family-specific fields are ignored elsewhere."""

    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // n_heads
    qkv_bias: bool = False               # qwen1.5
    act: Literal["silu", "gelu"] = "silu"  # gemma uses gelu (GeGLU)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    # --- MoE ---------------------------------------------------------- #
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0                    # per-expert FFN width
    first_k_dense: int = 0               # deepseek: first k layers dense
    router_aux_coef: float = 0.001

    # --- RWKV ----------------------------------------------------------- #
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # --- hybrid (hymba) -------------------------------------------------- #
    ssm_state: int = 0
    d_inner: int = 0                     # mamba inner width
    conv_kernel: int = 4
    window: int = 0                      # sliding-window size (0 = full attn)
    global_layers: tuple[int, ...] = ()  # layer indices with full attention

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.is_moe and not (0 < self.top_k <= self.n_experts):
            raise ValueError("bad top_k")
