"""Llama-3.2-Vision-style VLM backbone (cross-attention image layers), as
the JAX package's ``vlm.py``.

The vision tower is a stub, as in the reference: the model takes
precomputed patch embeddings (B, n_vision_tokens, d_model). The layer stack
is ``n_groups = n_layers // cross_every`` groups, each ``cross_every - 1``
self-attention blocks (the dense family's) followed by one tanh-gated
cross-attention block. Self layers are stacked ``(G, P, ...)`` and cross
layers ``(G, ...)``, the reference's layout, so its parameters carry over
leaf for leaf.

Kernels: K1 for every RMSNorm; K2 causal on self layers and without the
mask over the vision tokens on cross layers; K3 over the self caches at
``len + 1`` and over the vision K/V at ``n_vision_tokens``. The serving
functions follow the reference exactly, writing the cache, ``len``
included, in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.n_layers % cfg.cross_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"cross_every {cfg.cross_every}")
    return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _block_stack(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    """A dense block's weights, stacked over ``lead``, drawn one matrix at a
    time (f32 for one matrix, then cast)."""
    dt = cm.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    d, f = cfg.d_model, cfg.d_ff

    def stack(d_in: int, d_out: int) -> torch.Tensor:
        return cm.normal_stack(gen, (*lead, d_in, d_out), 1 / math.sqrt(d_in), dt)

    return {
        "attn_norm": torch.ones((*lead, d), dtype=dt, device=gen.device),
        "wq": stack(d, cfg.n_heads * hd),
        "wk": stack(d, cfg.n_kv_heads * hd),
        "wv": stack(d, cfg.n_kv_heads * hd),
        "wo": stack(cfg.n_heads * hd, d),
        "mlp_norm": torch.ones((*lead, d), dtype=dt, device=gen.device),
        "w_gate": stack(d, f),
        "w_up": stack(d, f),
        "w_down": stack(f, d),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on ``gen.device`` in the reference's tree. The gates
    start at 0 as the reference's, so ``tanh(gate) = 0`` and the cross
    blocks add nothing until the gates are set."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    n_groups, per_group = _groups(cfg)
    d = cfg.d_model
    cross = _block_stack(gen, cfg, (n_groups,))
    cross["gate_attn"] = torch.zeros((n_groups,), dtype=torch.float32, device=dev)
    cross["gate_mlp"] = torch.zeros((n_groups,), dtype=torch.float32, device=dev)
    return {
        "embed": cm.embed_init(gen, cfg.vocab_size, d, dt),
        "out_head": cm.dense_init(gen, d, cfg.vocab_size, dt),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "self_layers": _block_stack(gen, cfg, (n_groups, per_group)),   # (G, P, ...)
        "cross_layers": cross,                                           # (G, ...)
    }


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def _self_prefill(x, lp, cfg: ModelConfig, positions, plain: bool):
    """One self-attention block of the prefill: (x after it, its keys, its
    values)."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    attn = ops.flash_attention(q, k, v, causal=True, plain=plain)
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    return cm.mlp_residual(x, lp, cfg, plain), k, v


def _self_decode(x, lp, cfg: ModelConfig, positions, k_cache, v_cache, write_at,
                 cache_len, plain: bool):
    """One self-attention block of the decode step: writes its key and value
    at ``write_at`` of the caches in place and returns x after it."""
    b = x.shape[0]
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    k_cache.index_copy_(1, write_at, k)
    v_cache.index_copy_(1, write_at, v)
    attn = ops.decode_attention(q, k_cache, v_cache, cache_len, plain=plain)
    x = x + attn.reshape(b, 1, -1) @ lp["wo"]
    return cm.mlp_residual(x, lp, cfg, plain)


def _cross_block(x, lp, cfg: ModelConfig, attend, plain: bool):
    """The gated cross-attention block; ``attend(q)`` is the attention of
    the queries (B, S, H, hd) over the vision K/V."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)
    attn = attend(q)
    gate_a = torch.tanh(lp["gate_attn"]).to(x.dtype)
    x = x + gate_a * (attn.reshape(b, s, -1) @ lp["wo"])
    h = ops.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plain=plain)
    mlp = cm.glu_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)
    gate_m = torch.tanh(lp["gate_mlp"]).to(x.dtype)
    return x + gate_m * mlp


def _attend_vision(xk, xv, plain: bool):
    """The cross block's ``attend`` over the whole prompt: K2 with no mask,
    Sq the prompt, Sk the vision tokens."""
    return lambda q: ops.flash_attention(q, xk, xv, causal=False, plain=plain)


def _vision_kv(vision, lp, cfg: ModelConfig):
    """Project vision embeddings with this cross layer's wk/wv."""
    b, nv, _ = vision.shape
    hd = cfg.resolved_head_dim
    k = (vision @ lp["wk"]).reshape(b, nv, cfg.n_kv_heads, hd)
    v = (vision @ lp["wv"]).reshape(b, nv, cfg.n_kv_heads, hd)
    return k, v


# --------------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------------- #
def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """Mean next-token cross-entropy over ``batch["vision"]`` (B, Nv, D),
    cast to the model dtype; each self and each cross block rematerialised
    in the backward, the vision K/V projections not, as in the reference.
    Returns (loss, {"loss": loss})."""
    tokens, labels = batch["tokens"], batch["labels"]
    vision = batch["vision"].to(cm.param_dtype(cfg))
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    groups = zip((cm.unstack(g) for g in cm.unstack(params["self_layers"])),
                 cm.unstack(params["cross_layers"]))
    for self_layers, cross in groups:
        for lp in self_layers:
            x = cm.remat_first(_self_prefill, x, lp, cfg, positions, plain)
        xk, xv = _vision_kv(vision, cross, cfg)
        x = cm.remat(_cross_block, x, cross, cfg, _attend_vision(xk, xv, plain), plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    loss = cm.cross_entropy(x @ params["out_head"], labels)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    dt = cm.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    n_groups, per_group = _groups(cfg)
    self_shape = (n_groups, per_group, batch, max_len, cfg.n_kv_heads, hd)
    cross_shape = (n_groups, batch, cfg.n_vision_tokens, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dt, device=device),
        "v": torch.zeros(self_shape, dtype=dt, device=device),
        "xk": torch.zeros(cross_shape, dtype=dt, device=device),
        "xv": torch.zeros(cross_shape, dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(cache["k"], 2), (cache["v"], 2), (cache["xk"], 1), (cache["xv"], 1)]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: the head, the final norm, the
    self layers and the cross layers but their key and value projections,
    which the prefill reads once to fill the vision K/V. The embedding's
    rows are gathered."""
    cross = {k: w for k, w in params["cross_layers"].items() if k not in ("wk", "wv")}
    return [params["out_head"], params["final_norm"], *cm.leaves(params["self_layers"]),
            *cm.leaves(cross)]


def prefill(params, tokens, cfg: ModelConfig, vision=None, plain: bool = False):
    """tokens: (B, S); vision: (B, Nv, D) stub patch embeddings (zeros when
    None, as the reference). Returns (cache, logits_last)."""
    b, s = tokens.shape
    dev = tokens.device
    dt = cm.param_dtype(cfg)
    n_groups, per_group = _groups(cfg)
    if vision is None:
        vision = torch.zeros((b, cfg.n_vision_tokens, cfg.d_model), dtype=dt, device=dev)
    vision = vision.to(dt)
    x = params["embed"][tokens]
    positions = torch.arange(s, device=dev)
    hd = cfg.resolved_head_dim
    ks = torch.empty((n_groups, per_group, b, s, cfg.n_kv_heads, hd), dtype=dt, device=dev)
    vs = torch.empty_like(ks)
    xks = torch.empty((n_groups, b, vision.shape[1], cfg.n_kv_heads, hd), dtype=dt,
                      device=dev)
    xvs = torch.empty_like(xks)
    for g in range(n_groups):
        for p in range(per_group):
            lp = {name: w[g, p] for name, w in params["self_layers"].items()}
            x, ks[g, p], vs[g, p] = _self_prefill(x, lp, cfg, positions, plain)
        lp = cm.layer(params["cross_layers"], g)
        xk, xv = _vision_kv(vision, lp, cfg)
        xks[g], xvs[g] = xk, xv
        x = _cross_block(x, lp, cfg, _attend_vision(xk, xv, plain), plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = x[:, -1:] @ params["out_head"]
    cache = {"k": ks, "v": vs, "xk": xks, "xv": xvs,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step. tokens: (B, 1) int64. Writes the new self keys and
    values at ``len`` (clamped to the last slot, as the reference's
    ``dynamic_update_slice``) and advances ``len``, all in place; the vision
    K/V are read only. Returns (cache, logits)."""
    b = tokens.shape[0]
    n_groups, per_group = _groups(cfg)
    x = params["embed"][tokens]
    pos = cache["len"]
    positions = pos.reshape(1, 1).expand(b, 1)
    write_at = pos.clamp(max=cache["k"].shape[3] - 1).reshape(1).long()
    cache_len = pos + 1
    n_vision = torch.full((), cache["xk"].shape[2], dtype=torch.int32, device=pos.device)
    for g in range(n_groups):
        for p in range(per_group):
            lp = {name: w[g, p] for name, w in params["self_layers"].items()}
            x = _self_decode(x, lp, cfg, positions, cache["k"][g, p], cache["v"][g, p],
                             write_at, cache_len, plain)
        xk, xv = cache["xk"][g], cache["xv"][g]
        x = _cross_block(x, cm.layer(params["cross_layers"], g), cfg,
                         lambda q: ops.decode_attention(q, xk, xv, n_vision, plain=plain),
                         plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = x @ params["out_head"]
    pos.copy_(cache_len)                # last: every layer read the old position
    return cache, logits
