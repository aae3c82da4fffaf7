"""whisper-tiny [arXiv:2212.04356; unverified] — enc-dec, conv frontend (stub).

4L (enc+dec each), d_model=384, 6H (kv=6), d_ff=1536, vocab=51865.
The audio frontend (2x conv1d, stride 2 -> 1500 frames at 30 s) is a STUB:
``input_specs()`` supplies precomputed frame embeddings (B, n_frames, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,            # decoder layers
    n_enc_layers=4,        # encoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    n_frames=1500,
    rope_theta=0.0,        # whisper uses learned/sinusoidal positions, not RoPE
)
