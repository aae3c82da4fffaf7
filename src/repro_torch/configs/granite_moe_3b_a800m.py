"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L, d_model=1536, 24H (GQA kv=8), per-expert d_ff=512, vocab=49155,
MoE 40 experts top-8 (assignment config line).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,              # == d_expert for pure-MoE granite
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    d_expert=512,
)
