"""hymba-1.5b [arXiv:2411.13676; hf] — parallel attention + mamba heads.

32L, d_model=1600, 25H (GQA kv=5), d_ff=5504, vocab=32001, ssm_state=16.
Sliding-window attention (1k) everywhere except 3 global full-attention
layers {0, 15, 31}, per the Hymba paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    d_inner=3200,          # 2x d_model mamba expansion
    conv_kernel=4,
    window=1024,
    global_layers=(0, 15, 31),
)
