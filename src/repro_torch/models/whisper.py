"""Whisper-style encoder-decoder (whisper-tiny), as the JAX package's
``whisper.py``.

The conv audio frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, n_frames, d_model). Encoder: bidirectional
MHA with biases + GELU MLP, pre-LN. Decoder: causal self-attention, then
cross-attention to the encoder states. Positions are sinusoidal on both
sides. LayerNorm is plain PyTorch (K1 is RMSNorm, which whisper never
calls); every attention is a kernel from ``repro_torch.kernels.ops``: the
encoder's and the cross-attention's K2 without the causal mask (the cross
one at Sq = the prompt, Sk = n_frames), the decoder's K2 causal, and K3 over
the self cache at ``len + 1`` and over the cross cache at ``n_frames``.

The serving functions follow the reference exactly, including the shared
cache ``len`` of the engine, and write the cache, ``len`` included, in
place. The decode step reads the position from the cache's ``len`` on the
device, so it is capturable into a CUDA graph.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions: (S,) or (B, S) -> (..., d) f32. The frequencies are the
    reference's float64 ones, cast to f32 as it casts them."""
    half = d // 2
    steps = torch.arange(half, dtype=torch.float64, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * steps / max(half - 1, 1)).float()
    angles = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _attn_stack(gen: torch.Generator, n: int, d: int, width: int,
                dt: torch.dtype, prefix: str = "") -> dict:
    dev = gen.device
    return {
        prefix + "wq": cm.normal_stack(gen, (n, d, width), 1 / math.sqrt(d), dt),
        prefix + "bq": torch.zeros((n, width), dtype=dt, device=dev),
        prefix + "wk": cm.normal_stack(gen, (n, d, width), 1 / math.sqrt(d), dt),
        prefix + "wv": cm.normal_stack(gen, (n, d, width), 1 / math.sqrt(d), dt),
        prefix + "bv": torch.zeros((n, width), dtype=dt, device=dev),
        prefix + "wo": cm.normal_stack(gen, (n, width, d), 1 / math.sqrt(width), dt),
        prefix + "bo": torch.zeros((n, d), dtype=dt, device=dev),
    }


def _mlp_stack(gen: torch.Generator, n: int, d: int, f: int, dt: torch.dtype) -> dict:
    dev = gen.device
    return {
        "w_up": cm.normal_stack(gen, (n, d, f), 1 / math.sqrt(d), dt),
        "b_up": torch.zeros((n, f), dtype=dt, device=dev),
        "w_down": cm.normal_stack(gen, (n, f, d), 1 / math.sqrt(f), dt),
        "b_down": torch.zeros((n, d), dtype=dt, device=dev),
    }


def _ln(n: int, d: int, dt: torch.dtype, dev, name: str) -> dict:
    return {f"{name}_w": torch.ones((n, d), dtype=dt, device=dev),
            f"{name}_b": torch.zeros((n, d), dtype=dt, device=dev)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on ``gen.device`` in the reference's tree (encoder and
    decoder stacks on axis 0, the cross-attention's under ``x_``)."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    d, width = cfg.d_model, cfg.n_heads * cfg.resolved_head_dim
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    enc = {**_ln(ne, d, dt, dev, "ln1"), **_attn_stack(gen, ne, d, width, dt),
           **_ln(ne, d, dt, dev, "ln2"), **_mlp_stack(gen, ne, d, cfg.d_ff, dt)}
    dec = {**_ln(nd, d, dt, dev, "ln1"), **_attn_stack(gen, nd, d, width, dt),
           **_ln(nd, d, dt, dev, "ln_x"), **_attn_stack(gen, nd, d, width, dt, "x_"),
           **_ln(nd, d, dt, dev, "ln2"), **_mlp_stack(gen, nd, d, cfg.d_ff, dt)}
    return {
        "embed": cm.embed_init(gen, cfg.vocab_size, d, dt),
        "enc_ln_w": torch.ones((d,), dtype=dt, device=dev),
        "enc_ln_b": torch.zeros((d,), dtype=dt, device=dev),
        "dec_ln_w": torch.ones((d,), dtype=dt, device=dev),
        "dec_ln_b": torch.zeros((d,), dtype=dt, device=dev),
        "enc_layers": enc,
        "dec_layers": dec,
    }


# --------------------------------------------------------------------------- #
# attention (bias MHA, no RoPE)
# --------------------------------------------------------------------------- #
def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, dd = x.shape
    return x.reshape(b, s, n_heads, dd // n_heads)


def _mha(x, kv_src, lp, cfg: ModelConfig, prefix: str = "", causal: bool = False,
         plain: bool = False):
    """Attention of ``x`` over ``kv_src`` with the reference's biases (none
    on the keys); K2. Returns (output (B, S, D), (k, v))."""
    h = cfg.n_heads
    q = _heads(x @ lp[prefix + "wq"] + lp[prefix + "bq"], h)
    k = _heads(kv_src @ lp[prefix + "wk"], h)
    v = _heads(kv_src @ lp[prefix + "wv"] + lp[prefix + "bv"], h)
    out = ops.flash_attention(q, k, v, causal=causal, plain=plain)
    return out.reshape(x.shape) @ lp[prefix + "wo"] + lp[prefix + "bo"], (k, v)


def _mlp_residual(x, lp):
    h = cm.layernorm(x, lp["ln2_w"], lp["ln2_b"])
    return x + cm.dense_mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"])


# --------------------------------------------------------------------------- #
# encoder
# --------------------------------------------------------------------------- #
def encode(params, frames: torch.Tensor, cfg: ModelConfig, plain: bool = False):
    """frames: (B, F, D) stub embeddings -> encoder states (B, F, D)."""
    dt = cm.param_dtype(cfg)
    b, f, d = frames.shape
    x = frames.to(dt) + sinusoidal(torch.arange(f, device=frames.device), d).to(dt)
    for lp in cm.unstack(params["enc_layers"]):
        h = cm.layernorm(x, lp["ln1_w"], lp["ln1_b"])
        attn, _ = _mha(h, h, lp, cfg, causal=False, plain=plain)
        x = _mlp_residual(x + attn, lp)
    return cm.layernorm(x, params["enc_ln_w"], params["enc_ln_b"])


# --------------------------------------------------------------------------- #
# decoder over a whole prompt (prefill and training)
# --------------------------------------------------------------------------- #
def _dec_layer(x, lp, enc_out, cfg: ModelConfig, plain: bool):
    """One decoder layer: (x after it, its self (k, v), its cross (k, v))."""
    h = cm.layernorm(x, lp["ln1_w"], lp["ln1_b"])
    attn, self_kv = _mha(h, h, lp, cfg, causal=True, plain=plain)
    x = x + attn
    h = cm.layernorm(x, lp["ln_x_w"], lp["ln_x_b"])
    attn, cross_kv = _mha(h, enc_out, lp, cfg, "x_", causal=False, plain=plain)
    return _mlp_residual(x + attn, lp), self_kv, cross_kv


def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """Mean next-token cross-entropy of the decoder over the encoded
    ``batch["frames"]`` (B, F, D); each decoder layer rematerialised in the
    backward, the encoder not, as in the reference. Returns (loss,
    {"loss": loss})."""
    tokens, labels = batch["tokens"], batch["labels"]
    enc_out = encode(params, batch["frames"], cfg, plain)
    s = tokens.shape[1]
    dt = cm.param_dtype(cfg)
    x = params["embed"][tokens] + sinusoidal(torch.arange(s, device=tokens.device),
                                             cfg.d_model).to(dt)
    for lp in cm.unstack(params["dec_layers"]):
        x = cm.remat_first(_dec_layer, x, lp, enc_out, cfg, plain)
    x = cm.layernorm(x, params["dec_ln_w"], params["dec_ln_b"])
    loss = cm.cross_entropy(cm.lm_logits(x, params["embed"]), labels)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    dt = cm.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    l = cfg.n_layers
    self_shape = (l, batch, max_len, cfg.n_heads, hd)
    cross_shape = (l, batch, cfg.n_frames, cfg.n_heads, hd)
    return {
        "k": torch.zeros(self_shape, dtype=dt, device=device),
        "v": torch.zeros(self_shape, dtype=dt, device=device),
        "xk": torch.zeros(cross_shape, dtype=dt, device=device),
        "xv": torch.zeros(cross_shape, dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(cache[name], 1) for name in ("k", "v", "xk", "xv")]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: the embedding (also the head),
    the final LayerNorm and the decoder's layers but the cross-attention's
    key and value projections, which the prefill reads once to fill the
    cross cache. The encoder runs only at the prefill."""
    skip = ("x_wk", "x_wv", "x_bv")
    return [params["embed"], params["dec_ln_w"], params["dec_ln_b"],
            *(w for k, w in params["dec_layers"].items() if k not in skip)]


def prefill(params, tokens, cfg: ModelConfig, frames=None, plain: bool = False):
    """tokens: (B, S) decoder prompt; frames: (B, F, D) stub audio embeddings
    (zeros when None, as the reference). Returns (cache, logits_last)."""
    b, s = tokens.shape
    dev = tokens.device
    dt = cm.param_dtype(cfg)
    if frames is None:
        frames = torch.zeros((b, cfg.n_frames, cfg.d_model), dtype=dt, device=dev)
    enc_out = encode(params, frames, cfg, plain)
    x = params["embed"][tokens] + sinusoidal(torch.arange(s, device=dev), cfg.d_model).to(dt)
    nd, hd = cfg.n_layers, cfg.resolved_head_dim
    ks = torch.empty((nd, b, s, cfg.n_heads, hd), dtype=dt, device=dev)
    vs = torch.empty_like(ks)
    xks = torch.empty((nd, b, enc_out.shape[1], cfg.n_heads, hd), dtype=dt, device=dev)
    xvs = torch.empty_like(xks)
    for i in range(nd):
        x, (ks[i], vs[i]), (xks[i], xvs[i]) = _dec_layer(
            x, cm.layer(params["dec_layers"], i), enc_out, cfg, plain)
    x = cm.layernorm(x, params["dec_ln_w"], params["dec_ln_b"])
    logits = cm.lm_logits(x[:, -1:], params["embed"])
    cache = {"k": ks, "v": vs, "xk": xks, "xv": xvs,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step. tokens: (B, 1) int64. Writes the new self keys and
    values at ``len`` (clamped to the last slot, as the reference's
    ``dynamic_update_slice``) and advances ``len``, all in place; the cross
    cache is read only. Returns (cache, logits)."""
    b = tokens.shape[0]
    dt = cm.param_dtype(cfg)
    pos = cache["len"]
    x = params["embed"][tokens] + sinusoidal(pos.reshape(1, 1).expand(b, 1),
                                             cfg.d_model).to(dt)
    write_at = pos.clamp(max=cache["k"].shape[2] - 1).reshape(1).long()
    cache_len = pos + 1
    n_frames = torch.full((), cache["xk"].shape[2], dtype=torch.int32, device=pos.device)
    h_heads = cfg.n_heads
    for i in range(cfg.n_layers):
        lp = cm.layer(params["dec_layers"], i)
        h = cm.layernorm(x, lp["ln1_w"], lp["ln1_b"])
        q = _heads(h @ lp["wq"] + lp["bq"], h_heads)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache.index_copy_(1, write_at, _heads(h @ lp["wk"], h_heads))
        v_cache.index_copy_(1, write_at, _heads(h @ lp["wv"] + lp["bv"], h_heads))
        attn = ops.decode_attention(q, k_cache, v_cache, cache_len, plain=plain)
        x = x + attn.reshape(b, 1, -1) @ lp["wo"] + lp["bo"]
        h = cm.layernorm(x, lp["ln_x_w"], lp["ln_x_b"])
        q = _heads(h @ lp["x_wq"] + lp["x_bq"], h_heads)
        attn = ops.decode_attention(q, cache["xk"][i], cache["xv"][i], n_frames, plain=plain)
        x = _mlp_residual(x + attn.reshape(b, 1, -1) @ lp["x_wo"] + lp["x_bo"], lp)
    x = cm.layernorm(x, params["dec_ln_w"], params["dec_ln_b"])
    logits = cm.lm_logits(x, params["embed"])
    pos.copy_(cache_len)                # last: every layer read the old position
    return cache, logits
