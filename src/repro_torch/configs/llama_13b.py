"""llama-13b [arXiv:2302.13971] — the paper's trace-replay serving model (S2.3).

40L, d_model=5120, 40H MHA, d_ff=13824, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13824,
    vocab_size=32000,
    tie_embeddings=False,
)
