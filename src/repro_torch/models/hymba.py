"""Hymba (arXiv:2411.13676): hybrid-head LM — parallel attention + Mamba
(SSM) heads in every layer.

Each layer runs a GQA attention branch and a Mamba selective-scan branch on
the same normed input; branch outputs are RMS-normalized, averaged with
learned per-branch scales, and added to the residual, followed by a SwiGLU
MLP. Most layers use sliding-window attention (``cfg.window``); layers in
``cfg.global_layers`` use full attention. Layers are not stacked (window and
global caches differ in shape): ``params["layers"]`` is a list of dicts.

On the card every RMSNorm is K1, prefill attention K2 (``window`` on local
layers), decode attention K3 and the selective scan K5; the port adds the
D-skip term itself, as the JAX package's ``selective_scan`` does.

The serving functions follow the JAX package exactly, including its
ring-buffer placement: a prefill keeps a window layer's last ``min(window,
s)`` keys at slots ``0..keep-1``, and decode writes position ``p`` at slot
``p % size``, so after a prefill longer than the window and not a multiple
of it, decode overwrites a key that is not the oldest (ROADMAP, reference
caveats). Global layers clamp their write to the last slot once the shared
``len`` reaches the cache length, as ``lax.dynamic_update_slice`` does. A
decode step writes the caches and states in place and returns the cache
with ``len`` advanced.

``plain=True`` runs the plain PyTorch versions of the kernels, to hold the
kernel path against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cm.param_dtype(cfg)
    dev = gen.device
    d, hd = cfg.d_model, cfg.resolved_head_dim
    di, n = cfg.d_inner, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    f32 = torch.float32
    conv_w = torch.randn((cfg.conv_kernel, di), generator=gen, device=dev, dtype=f32)
    return {
        "attn_norm": torch.ones((d,), dtype=dt, device=dev),
        # attention branch
        "wq": cm.dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": cm.dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": cm.dense_init(gen, cfg.n_heads * hd, d, dt),
        "attn_out_norm": torch.ones((d,), dtype=dt, device=dev),
        # mamba branch
        "in_proj": cm.dense_init(gen, d, 2 * di, dt),
        "conv_w": (conv_w * 0.2).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": cm.dense_init(gen, di, dt_rank + 2 * n, dt),
        "dt_proj": cm.dense_init(gen, dt_rank, di, dt),
        "dt_bias": torch.zeros((di,), dtype=f32, device=dev),
        "a_log": torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=f32, device=dev),
        "ssm_out_proj": cm.dense_init(gen, di, d, dt),
        "ssm_out_norm": torch.ones((d,), dtype=dt, device=dev),
        # fusion + MLP
        "beta_attn": torch.ones((), dtype=f32, device=dev),
        "beta_ssm": torch.ones((), dtype=f32, device=dev),
        "mlp_norm": torch.ones((d,), dtype=dt, device=dev),
        "w_gate": cm.dense_init(gen, d, cfg.d_ff, dt),
        "w_up": cm.dense_init(gen, d, cfg.d_ff, dt),
        "w_down": cm.dense_init(gen, cfg.d_ff, d, dt),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on ``gen.device`` (the JAX package's tree and scales;
    f32 ``a_log``, ``dt_bias``, ``d_skip`` and ``beta_*`` under any dtype)."""
    dt = cm.param_dtype(cfg)
    return {
        "embed": cm.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
        "layers": [_init_layer(gen, cfg) for _ in range(cfg.n_layers)],
    }


# --------------------------------------------------------------------------- #
# mamba branch
# --------------------------------------------------------------------------- #
def _causal_conv(x, w, b):
    """Depthwise causal 1D conv. x: (B,S,I); w: (K,I)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1]] * w[i]
    return out + b


def _ssm_inputs(u, lp, cfg: ModelConfig):
    """(dt, a, B, C) of the selective scan from the conv output u (B,S,I)."""
    n = cfg.ssm_state
    dt_rank = lp["dt_proj"].shape[0]
    proj = u @ lp["x_proj"]
    dt_in, b_t, c_t = (proj[..., :dt_rank], proj[..., dt_rank:dt_rank + n],
                       proj[..., dt_rank + n:])
    dt = F.softplus(dt_in @ lp["dt_proj"] + lp["dt_bias"])
    a = -torch.exp(lp["a_log"])
    return dt.float(), a, b_t.float(), c_t.float()


def mamba_branch(x, lp, cfg: ModelConfig, plain: bool = False):
    """Full-sequence Mamba from a zero state (the prefill). Returns (out,
    conv state (B,K-1,I), ssm state (B,I,N) f32)."""
    di = cfg.d_inner
    xz = x @ lp["in_proj"]
    u, z = xz[..., :di], xz[..., di:]
    conv_out = _causal_conv(u, lp["conv_w"], lp["conv_b"])
    conv_state = u[:, -(cfg.conv_kernel - 1):]
    u = F.silu(conv_out)
    dt, a, b_t, c_t = _ssm_inputs(u, lp, cfg)
    y, ssm_state = ops.ssm_scan(u.float(), dt, a, b_t, c_t, plain=plain)
    y = y + u.float() * lp["d_skip"]
    y = (y.to(x.dtype) * F.silu(z)) @ lp["ssm_out_proj"]
    return y, conv_state, ssm_state


def mamba_step(x, lp, cfg: ModelConfig, conv_state, ssm_state, plain: bool = False):
    """Single-token Mamba. x: (B,1,D); conv_state: (B,K-1,I); ssm_state:
    (B,I,N) f32. Both states are advanced in place; returns the output."""
    di = cfg.d_inner
    xz = x @ lp["in_proj"]
    u, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv_state.to(u.dtype), u], dim=1)              # (B,K,I)
    conv_out = torch.einsum("bki,ki->bi", window, lp["conv_w"]) + lp["conv_b"]
    conv_state.copy_(window[:, 1:])
    u1 = F.silu(conv_out)[:, None, :]                                   # (B,1,I)
    dt, a, b_t, c_t = _ssm_inputs(u1, lp, cfg)
    y, _ = ops.ssm_scan(u1.float(), dt, a, b_t, c_t, h0=ssm_state, h_out=ssm_state,
                        plain=plain)
    y = y + u1.float() * lp["d_skip"]
    return (y.to(x.dtype) * F.silu(z)) @ lp["ssm_out_proj"]


# --------------------------------------------------------------------------- #
# layer pieces
# --------------------------------------------------------------------------- #
def _fuse(attn_out, ssm_out, lp, cfg: ModelConfig, plain: bool):
    dt = attn_out.dtype  # f32 betas must not promote the residual stream
    a = ops.rmsnorm(attn_out, lp["attn_out_norm"], cfg.norm_eps, plain=plain) * \
        lp["beta_attn"].to(dt)
    m = ops.rmsnorm(ssm_out, lp["ssm_out_norm"], cfg.norm_eps, plain=plain) * \
        lp["beta_ssm"].to(dt)
    return (0.5 * (a + m)).to(dt)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    """Window KV caches (``min(window, max_len)`` slots) for local layers,
    full caches for global layers, plus per-layer conv and f32 ssm state."""
    dt = cm.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    layers = []
    for i in range(cfg.n_layers):
        size = max_len if i in cfg.global_layers else min(cfg.window, max_len)
        layers.append({
            "k": torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dt, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner), dtype=dt,
                                device=device),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                               device=device),
        })
    return {"len": torch.zeros((), dtype=torch.int32, device=device), "layers": layers}


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(lc[name], 0) for lc in cache["layers"] for name in ("k", "v", "conv", "ssm")]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: all of them (the embedding is
    also the head)."""
    return cm.leaves(params)


def _full_layer(x, lp, cfg: ModelConfig, positions, is_global: bool, plain: bool):
    """One hybrid layer over the full sequence from a zero state: (x after
    it, its keys, its values, conv state, ssm state). The prefill and the
    training loss share it."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    attn = cm.attention(q, k, v, causal=True,
                        window=0 if is_global else cfg.window, plain=plain)
    attn_out = attn.reshape(b, s, -1) @ lp["wo"]
    ssm_out, conv_state, ssm_state = mamba_branch(h, lp, cfg, plain)
    x = x + _fuse(attn_out, ssm_out, lp, cfg, plain)
    return cm.mlp_residual(x, lp, cfg, plain), k, v, conv_state, ssm_state


def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """Mean next-token cross-entropy; each layer rematerialised in the
    backward (so the selective scan runs twice a layer forward, and its
    backward kernel once). Returns (loss, {"loss": loss})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        x = cm.remat_first(_full_layer, x, lp, cfg, positions, i in cfg.global_layers,
                           plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    loss = cm.cross_entropy(cm.lm_logits(x, params["embed"]), labels)
    return loss, {"loss": loss}


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False):
    """Full-sequence forward that also builds the cache. tokens: (B, S) int64.
    Returns (cache, logits_last) — logits for the final position, (B, 1, V)."""
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(s, device=dev)
    layers = []
    for i, lp in enumerate(params["layers"]):
        is_global = i in cfg.global_layers
        x, k, v, conv_state, ssm_state = _full_layer(x, lp, cfg, positions, is_global, plain)
        keep = s if is_global else min(cfg.window, s)
        layers.append({"k": k[:, -keep:], "v": v[:, -keep:],
                       "conv": conv_state, "ssm": ssm_state})
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x[:, -1:], params["embed"])
    cache = {"len": torch.full((), s, dtype=torch.int32, device=dev), "layers": layers}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step. tokens: (B, 1) int64. Writes keys, values and states
    into ``cache`` and advances its ``len``, all in place (a CUDA graph of the
    step replays into the same tensors); returns (cache, logits)."""
    b = tokens.shape[0]
    x = params["embed"][tokens]
    pos = cache["len"]
    positions = pos.reshape(1, 1).expand(b, 1)
    cache_len = pos + 1
    for i, lp in enumerate(params["layers"]):
        lc = cache["layers"][i]
        h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
        q, k, v = cm.qkv(h, lp, cfg)
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
        size = lc["k"].shape[1]
        slot = pos.clamp(max=size - 1) if i in cfg.global_layers else pos % size
        slot = slot.reshape(1).long()
        lc["k"].index_copy_(1, slot, k)
        lc["v"].index_copy_(1, slot, v)
        # a window layer's ring counts every slot once cache_len >= size,
        # which K3 does for any cache_len at or past S
        attn = cm.decode_attention(q, lc["k"], lc["v"], cache_len, plain=plain)
        attn_out = attn.reshape(b, 1, -1) @ lp["wo"]
        ssm_out = mamba_step(h, lp, cfg, lc["conv"], lc["ssm"], plain)
        x = x + _fuse(attn_out, ssm_out, lp, cfg, plain)
        x = cm.mlp_residual(x, lp, cfg, plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"])
    pos.copy_(cache_len)                # last: every layer read the old position
    return cache, logits
