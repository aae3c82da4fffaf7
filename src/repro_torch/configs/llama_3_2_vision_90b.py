"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L total, d_model=8192, 64H (kv=8), d_ff=28672, vocab=128256.
Cross-attention image layers: one cross block after every 4 self layers
(20 cross + 80 self = 100). Vision frontend is a STUB: ``input_specs()``
supplies precomputed patch embeddings (B, n_vision_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,          # total = self + cross
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_every=5,         # every 5th layer is a cross-attn block
    n_vision_tokens=1601,  # 1 tile x (40x40 patches + 1 cls)
    rope_theta=500000.0,
    tie_embeddings=False,
)
