"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base; hf] — dense GQA.

40L, d_model=4096, 32H (kv=8), d_ff=12800, vocab=49155.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
)
