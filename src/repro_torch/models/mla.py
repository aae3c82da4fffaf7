"""DeepSeek-V3-style model: MLA attention + (shared + routed) MoE + MTP, as
the JAX package's ``mla.py``.

MLA (Multi-head Latent Attention, arXiv:2412.19437): queries through a
low-rank bottleneck (q_lora_rank), keys/values through a compressed latent
(kv_lora_rank) plus a shared RoPE key. The prefill runs the expanded form;
the decode step runs the absorbed form in f32, attending in latent space so
that the cache is (kv_lora + rope) wide. Neither fits the attention kernels
(q/k 192 wide against v 128, then products over the 512 + 64 latent), and
the reference computes both in plain jnp, so both are plain PyTorch here.
K1 runs every RMSNorm: ``attn_norm``, ``q_norm``, ``kv_norm``, ``mlp_norm``
and ``final_norm``.

Layer stack: the first ``first_k_dense`` layers have a dense GLU FFN (width
d_ff), the rest the MoE FFN (``moe.moe_ffn``: the dense dispatch, or the
expert-parallel one under a ``dist`` whose model axis is wider than 1) with
its shared expert. The MTP module (one dense-FFN MLA layer predicting token
t + 2 from the last hidden state and token t + 1's embedding) is a training
term: the loss runs it, serving never does.

The decode step writes the latents at ``len`` in place (clamped to the last
slot, as the reference's ``dynamic_update_slice``) instead of building new
caches as the reference does, so it is capturable into a CUDA graph.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import LOCAL, DistContext
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import common as cm
from repro_torch.models import moe

MTP_LOSS_WEIGHT = 0.3

# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _stack(gen: torch.Generator, n: int, d_in: int, d_out: int, dt) -> torch.Tensor:
    return cm.normal_stack(gen, (n, d_in, d_out), 1 / math.sqrt(d_in), dt)


def _init_mla_attn(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    dt = cm.param_dtype(cfg)
    dev = gen.device
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ql, kvl = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "attn_norm": torch.ones((n, d), dtype=dt, device=dev),
        "w_dq": _stack(gen, n, d, ql, dt),
        "q_norm": torch.ones((n, ql), dtype=dt, device=dev),
        "w_uq": _stack(gen, n, ql, h * (nope + rope), dt),
        "w_dkv": _stack(gen, n, d, kvl + rope, dt),
        "kv_norm": torch.ones((n, kvl), dtype=dt, device=dev),
        "w_ukv": _stack(gen, n, kvl, h * (nope + vd), dt),
        "wo": _stack(gen, n, h * vd, d, dt),
    }


def _glu_stack(gen: torch.Generator, cfg: ModelConfig, n: int, width: int) -> dict:
    dt = cm.param_dtype(cfg)
    d = cfg.d_model
    return {
        "mlp_norm": torch.ones((n, d), dtype=dt, device=gen.device),
        "w_gate": _stack(gen, n, d, width, dt),
        "w_up": _stack(gen, n, d, width, dt),
        "w_down": _stack(gen, n, width, d, dt),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, ep_size: int = 1) -> dict:
    """Random weights on ``gen.device`` in the reference's tree: the dense
    layers' and the MoE layers' stacks, and the MTP module's parameters."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    d = cfg.d_model
    n_dense, n_moe = cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    params = {
        "embed": cm.embed_init(gen, cfg.vocab_size, d, dt),
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
        "dense_layers": {**_init_mla_attn(gen, cfg, n_dense),
                         **_glu_stack(gen, cfg, n_dense, cfg.d_ff)},
        "moe_layers": {**_init_mla_attn(gen, cfg, n_moe),
                       "mlp_norm": torch.ones((n_moe, d), dtype=dt, device=dev),
                       **moe.init_moe_ffn(gen, cfg, ep_size, n_layers=n_moe)},
    }
    if cfg.mtp_depth > 0:
        layer = {**_init_mla_attn(gen, cfg, 1), **_glu_stack(gen, cfg, 1, cfg.d_ff)}
        params["mtp"] = {
            "norm_h": torch.ones((d,), dtype=dt, device=dev),
            "norm_e": torch.ones((d,), dtype=dt, device=dev),
            "proj": cm.dense_init(gen, 2 * d, d, dt),
            "layer": cm.layer(layer, 0),
        }
    return params


# --------------------------------------------------------------------------- #
# MLA attention
# --------------------------------------------------------------------------- #
def _latents(x, lp, cfg: ModelConfig, positions, plain: bool):
    """The queries (B, S, H, nope + rope), the normed latent (B, S, kvl) and
    the rotated shared key (B, S, 1, rope) of ``x``."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    kvl = cfg.kv_lora_rank
    cq = ops.rmsnorm(x @ lp["w_dq"], lp["q_norm"], cfg.norm_eps, plain=plain)
    q = (cq @ lp["w_uq"]).reshape(b, s, h, nope + rope)
    q = torch.cat([q[..., :nope], cm.apply_rope(q[..., nope:], positions, cfg.rope_theta)],
                  dim=-1)
    ckv_full = x @ lp["w_dkv"]
    # K1 reads whole contiguous rows: the latent's rows sit rope apart
    ckv = ops.rmsnorm(ckv_full[..., :kvl].contiguous(), lp["kv_norm"], cfg.norm_eps,
                      plain=plain)
    k_rope = cm.apply_rope(ckv_full[..., kvl:].reshape(b, s, 1, rope), positions,
                           cfg.rope_theta)
    return q, ckv, k_rope


def _causal_attention(q, k, v):
    """The reference's plain attention (``cm.attention``, one block):
    f32 scores scaled by q's width, causal, probabilities cast to v's
    dtype for the product with v. q/k: (B, S, H, dq); v: (B, S, H, dv)."""
    s = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos[None, :] <= pos[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def mla_attention(x, lp, cfg: ModelConfig, positions, plain: bool = False):
    """The expanded form (prefill). Returns (attn_out (B, S, D), (ckv
    (B, S, kvl), k_rope (B, S, rope)) latents for the cache)."""
    b, s, _ = x.shape
    h, nope, rope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q, ckv, k_rope = _latents(x, lp, cfg, positions, plain)
    kv = (ckv @ lp["w_ukv"]).reshape(b, s, h, nope + vd)
    k = torch.cat([kv[..., :nope], k_rope.expand(b, s, h, rope)], dim=-1)
    attn = _causal_attention(q, k, kv[..., nope:])
    out = attn.reshape(b, s, h * vd) @ lp["wo"]
    return out, (ckv, k_rope[:, :, 0, :])


def mla_decode_attention(x, lp, cfg: ModelConfig, ckv_cache, krope_cache, pos,
                         write_at, plain: bool = False):
    """The absorbed form (decode), in f32. x: (B, 1, D); caches (B, S, kvl)
    and (B, S, rope), written at ``write_at`` in place; the slots at or
    before ``pos`` are valid. Returns the attention output (B, 1, D)."""
    b = x.shape[0]
    h, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    q, ckv_new, krope_new = _latents(x, lp, cfg, pos.reshape(1, 1).expand(b, 1), plain)
    ckv_cache.index_copy_(1, write_at, ckv_new)
    krope_cache.index_copy_(1, write_at, krope_new[:, :, 0, :])

    w_ukv = lp["w_ukv"].reshape(kvl, h, nope + vd)
    w_uk, w_uv = w_ukv[..., :nope], w_ukv[..., nope:]
    # absorb W_UK into the query: q_abs (B, 1, H, kvl)
    q_abs = torch.einsum("bqhn,khn->bqhk", q[..., :nope].float(), w_uk.float())
    ckv = ckv_cache.float()
    scores = (torch.einsum("bqhk,bsk->bhqs", q_abs, ckv)
              + torch.einsum("bqhr,bsr->bhqs", q[..., nope:].float(), krope_cache.float())
              ) * (1.0 / math.sqrt(q.shape[-1]))
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    probs = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
    ctx = torch.einsum("bhqs,bsk->bqhk", probs, ckv)
    v_out = torch.einsum("bqhk,khv->bqhv", ctx, w_uv.float())
    return v_out.reshape(b, 1, h * vd).to(x.dtype) @ lp["wo"]


# --------------------------------------------------------------------------- #
# layers and serving
# --------------------------------------------------------------------------- #
def _prefill_layer(x, lp, cfg: ModelConfig, positions, plain: bool, aux: bool = False,
                   dist: DistContext = LOCAL):
    """One layer of the prefill: (x after the layer, its latent, its shared
    rotated key, its MoE aux loss or None); the training loss asks for the
    aux loss."""
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    attn, (ckv, krope) = mla_attention(h, lp, cfg, positions, plain)
    x, aux_loss = _ffn_residual(x + attn, lp, cfg, plain, aux, dist)
    return x, ckv, krope, aux_loss


def _decode_layer(x, lp, cfg: ModelConfig, caches, at, plain: bool,
                  dist: DistContext = LOCAL):
    """One layer of the decode step. ``caches``: the layer's (latent, shared
    rotated key), written at ``write_at`` in place; ``at``: (pos, write_at,
    cache_len) of the step (:func:`decode_at`). Returns x after the layer."""
    pos, write_at, _ = at
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    attn = mla_decode_attention(h, lp, cfg, *caches, pos, write_at, plain)
    return _ffn_residual(x + attn, lp, cfg, plain, dist=dist)[0]


def _ffn_residual(x, lp, cfg: ModelConfig, plain: bool, aux: bool = False,
                  dist: DistContext = LOCAL):
    """(x + the dense GLU or, in a layer with a router, the MoE FFN of the
    RMS-normed x, the MoE layer's aux loss or None); the norm is K1."""
    h = ops.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plain=plain)
    if "router" in lp:
        y, aux_loss = moe.moe_ffn(h, lp, cfg, dist, aux=aux)
        return x + y, aux_loss
    return x + cm.glu_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act), None


decode_at = moe.decode_at


def layers(params, cfg: ModelConfig) -> list[dict]:
    """Every layer's parameters, in order: the dense layers, then the MoE
    layers."""
    return ([cm.layer(params["dense_layers"], i) for i in range(cfg.first_k_dense)]
            + [cm.layer(params["moe_layers"], i)
               for i in range(cfg.n_layers - cfg.first_k_dense)])


def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False,
            dist: DistContext = LOCAL):
    """The cross-entropy, plus ``router_aux_coef`` times the MoE layers' mean
    load-balance loss, plus ``MTP_LOSS_WEIGHT`` times the MTP head's
    cross-entropy on tokens shifted one further (its last two positions
    masked); each layer rematerialised in the backward, the MTP layer not,
    as in the reference. Returns (loss, {"loss", "ce", "aux"[, "ce_mtp"]})."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    embed = params["embed"]
    x = embed[tokens]
    positions = torch.arange(s, device=tokens.device)
    aux_sum = 0.0
    for lp in cm.unstack(params["dense_layers"]) + cm.unstack(params["moe_layers"]):
        x, _, _, aux = cm.remat(_prefill_layer, x, lp, cfg, positions, plain, True, dist)
        if aux is not None:
            aux_sum = aux_sum + aux
    hidden = x
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    ce = cm.cross_entropy(cm.lm_logits(x, embed), labels)
    aux = cfg.router_aux_coef * aux_sum / max(cfg.n_layers - cfg.first_k_dense, 1)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp_depth > 0:
        mtp = params["mtp"]
        # token t+1's embedding at position t (shifted left, wrapping)
        emb_next = embed[torch.roll(tokens, -1, dims=1)]
        mtp_in = torch.cat([ops.rmsnorm(hidden, mtp["norm_h"], cfg.norm_eps, plain=plain),
                            ops.rmsnorm(emb_next, mtp["norm_e"], cfg.norm_eps, plain=plain)],
                           dim=-1) @ mtp["proj"]
        h_mtp = _prefill_layer(mtp_in, mtp["layer"], cfg, positions, plain)[0]
        h_mtp = ops.rmsnorm(h_mtp, params["final_norm"], cfg.norm_eps, plain=plain)
        mask = torch.ones((b, s), dtype=torch.bool, device=tokens.device)
        mask[:, -2:] = False
        ce_mtp = cm.cross_entropy(cm.lm_logits(h_mtp, embed), torch.roll(labels, -1, dims=1),
                                  mask)
        loss = loss + MTP_LOSS_WEIGHT * ce_mtp
        metrics["ce_mtp"] = ce_mtp
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    dt = cm.param_dtype(cfg)
    l = cfg.n_layers
    return {
        "ckv": torch.zeros((l, batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
        "krope": torch.zeros((l, batch, max_len, cfg.qk_rope_dim), dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(cache["ckv"], 1), (cache["krope"], 1)]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: all of them (the embedding is
    also the head, the dense dispatch reads every expert) but the MTP
    module's, a training term that serving never runs."""
    return cm.leaves({k: w for k, w in params.items() if k != "mtp"})


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False,
            dist: DistContext = LOCAL):
    """Full-sequence forward in the expanded form that also fills the latent
    cache. tokens: (B, S) int64. Returns (cache, logits_last)."""
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(s, device=dev)
    ckv = torch.empty((cfg.n_layers, b, s, cfg.kv_lora_rank), dtype=x.dtype, device=dev)
    krope = torch.empty((cfg.n_layers, b, s, cfg.qk_rope_dim), dtype=x.dtype, device=dev)
    for i, lp in enumerate(layers(params, cfg)):
        x, ckv[i], krope[i], _ = _prefill_layer(x, lp, cfg, positions, plain, dist=dist)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x[:, -1:], params["embed"])
    cache = {"ckv": ckv, "krope": krope,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False,
                dist: DistContext = LOCAL):
    """One decode step in the absorbed form. tokens: (B, 1) int64. Writes
    the new latents into ``cache`` and advances its ``len``, all in place;
    returns (cache, logits)."""
    x = params["embed"][tokens]
    at = decode_at(cache["len"], cache["ckv"].shape[2])
    for i, lp in enumerate(layers(params, cfg)):
        x = _decode_layer(x, lp, cfg, (cache["ckv"][i], cache["krope"][i]), at, plain,
                          dist)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"])
    cache["len"].copy_(at[2])           # last: every layer read the old position
    return cache, logits
