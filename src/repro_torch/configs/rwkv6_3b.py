"""rwkv6-3b (Finch) [arXiv:2404.05892; hf] — attention-free, data-dependent decay.

32L, d_model=2560, d_ff=8960, vocab=65536, head_size=64 (40 wkv heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # d_model // rwkv_head_size
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_size=64,
    rwkv_decay_lora=64,
    rwkv_mix_lora=32,
    tie_embeddings=False,  # rwkv uses separate head
)
