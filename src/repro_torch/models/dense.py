"""Dense decoder-only transformer (gemma-2b, qwen1.5-*, llama-13b).

GQA/MQA attention with RoPE (optional QKV bias for qwen), SwiGLU/GeGLU MLP,
RMSNorm, tied embeddings optional. Layer weights are stacked on axis 0, as in
the JAX package, and the stack is walked with a Python loop. The training
loss shares the prefill's layer and splits the stack once
(``common.unstack``).

The serving functions follow the JAX package exactly, including what its
engine relies on: the cache's ``len`` is one position shared by all rows,
a decode step writes every row's new key at that position (clamped to the
last slot once ``len`` reaches the cache length, as
``lax.dynamic_update_slice`` clamps) and rotates every row by it. The port
writes the cache, its ``len`` included, in place instead of returning a new
one.

``plain=True`` runs the plain PyTorch versions of the kernels, to hold the
kernel path against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm

# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on ``gen.device``, drawn one layer at a time (f32 for one
    matrix, then cast), so a full-width model is made on the card without a
    full f32 copy anywhere."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    hd = cfg.resolved_head_dim
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def stack(d_in: int, d_out: int) -> torch.Tensor:
        out = torch.empty((l, d_in, d_out), dtype=dt, device=dev)
        for i in range(l):
            out[i] = cm.dense_init(gen, d_in, d_out, dt)
        return out

    layers = {
        "attn_norm": torch.ones((l, d), dtype=dt, device=dev),
        "wq": stack(d, cfg.n_heads * hd),
        "wk": stack(d, cfg.n_kv_heads * hd),
        "wv": stack(d, cfg.n_kv_heads * hd),
        "wo": stack(cfg.n_heads * hd, d),
        "mlp_norm": torch.ones((l, d), dtype=dt, device=dev),
        "w_gate": stack(d, f),
        "w_up": stack(d, f),
        "w_down": stack(f, d),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((l, cfg.n_heads * hd), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((l, cfg.n_kv_heads * hd), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((l, cfg.n_kv_heads * hd), dtype=dt, device=dev)
    params = {
        "embed": cm.embed_init(gen, cfg.vocab_size, d, dt),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["out_head"] = cm.dense_init(gen, d, cfg.vocab_size, dt)
    return params


# --------------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------------- #
def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """Mean next-token cross-entropy over every position; each layer
    rematerialised in the backward. batch: ``tokens`` and ``labels`` (B, S).
    Returns (loss, {"loss": loss})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in cm.unstack(params["layers"]):
        x = cm.remat_first(_prefill_layer, x, lp, cfg, positions, plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"], params.get("out_head"))
    loss = cm.cross_entropy(logits, labels)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------- #
# serving: prefill + decode
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    hd = cfg.resolved_head_dim
    dt = cm.param_dtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(cache["k"], 1), (cache["v"], 1)]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: all of them but an embedding
    that an untied head replaces (the step gathers only its rows)."""
    return cm.leaves({k: w for k, w in params.items()
                      if k != "embed" or "out_head" not in params})


def _prefill_layer(x, lp, cfg: ModelConfig, positions, plain: bool):
    """One pre-norm block over the full sequence: (x after it, its keys, its
    values). The prefill and the training loss share it."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    attn = ops.flash_attention(q, k, v, causal=True, plain=plain)
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    return cm.mlp_residual(x, lp, cfg, plain), k, v


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False):
    """Full-sequence forward that also populates the KV cache.

    tokens: (B, S) int64. Returns (cache, logits_last) — logits for the final
    position only, (B, 1, V).
    """
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(s, device=dev)
    cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks = torch.empty(cache_shape, dtype=x.dtype, device=dev)
    vs = torch.empty(cache_shape, dtype=x.dtype, device=dev)
    for i in range(cfg.n_layers):
        x, ks[i], vs[i] = _prefill_layer(x, cm.layer(params["layers"], i), cfg, positions,
                                         plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x[:, -1:], params["embed"], params.get("out_head"))
    cache = {"k": ks, "v": vs,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step. tokens: (B, 1) int64. Writes the new keys and values
    into ``cache`` and advances its ``len``, all in place (a CUDA graph of the
    step replays into the same tensors); returns (cache, logits)."""
    b = tokens.shape[0]
    x = params["embed"][tokens]
    pos = cache["len"]
    positions = pos.reshape(1, 1).expand(b, 1)
    write_at = pos.clamp(max=cache["k"].shape[2] - 1).reshape(1).long()
    cache_len = pos + 1
    for i in range(cfg.n_layers):
        lp = cm.layer(params["layers"], i)
        h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
        q, k, v = cm.qkv(h, lp, cfg)
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache.index_copy_(1, write_at, k)
        v_cache.index_copy_(1, write_at, v)
        attn = ops.decode_attention(q, k_cache, v_cache, cache_len, plain=plain)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"]
        x = cm.mlp_residual(x, lp, cfg, plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"], params.get("out_head"))
    pos.copy_(cache_len)                # last: every layer read the old position
    return cache, logits
