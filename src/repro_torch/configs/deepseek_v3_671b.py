"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed top-8, MTP.

61L, d_model=7168, 128H, routed-expert d_ff=2048, vocab=129280.
First 3 layers dense (d_ff=18432 per the HF config). MLA dims: q_lora=1536,
kv_lora=512, qk_nope=128, qk_rope=64, v_head=128. One MTP module.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-layer FFN width (first_k_dense layers)
    vocab_size=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    d_expert=2048,
    first_k_dense=3,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    rope_theta=10000.0,
)
