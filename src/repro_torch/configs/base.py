"""Model configuration dataclass: the JAX package's ``ModelConfig``, with
the fields of every family the port serves (dense, moe, mla_moe, rwkv,
hybrid, encdec, vlm); and the assigned input-shape cells of the dry-run
(``ShapeSpec``, ``LM_SHAPES``, ``cell_is_applicable``)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "mla_moe", "rwkv", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Families reuse fields; family-specific fields are
    ignored elsewhere. All attention is causal unless ``family == encdec``
    (encoder side bidirectional)."""

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

    # --- MLA (deepseek) ------------------------------------------------ #
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0                   # multi-token-prediction modules

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

    # --- encoder-decoder (whisper) ---------------------------------------- #
    n_enc_layers: int = 0
    n_frames: int = 0                    # stubbed audio-frontend output length

    # --- vlm (llama-3.2-vision) -------------------------------------------- #
    cross_every: int = 0                 # a cross-attn block after every k self layers
    n_vision_tokens: int = 0             # stubbed patch-embedding length

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
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.is_moe and not (0 < self.top_k <= self.n_experts):
            raise ValueError("bad top_k")
        if self.family == "vlm" and self.cross_every <= 0:
            raise ValueError("vlm needs cross_every")
        if self.family == "encdec" and self.n_enc_layers <= 0:
            raise ValueError("encdec needs n_enc_layers")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic decoding state)
SUBQUADRATIC_ARCHS = frozenset({"rwkv6-3b", "hymba-1.5b"})


def cell_is_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC_ARCHS
    return True
