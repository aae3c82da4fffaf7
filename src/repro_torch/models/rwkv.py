"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay.

Each layer = time-mix (token shift + 5-way data-dependent lerp via LoRA,
WKV linear recurrence with decay w_t = exp(-exp(.)) and bonus u) +
channel-mix (token shift + squared-ReLU FFN). LayerNorms per RWKV convention.
Decode state is O(1) in sequence length: a (heads, head_k, head_v) f32
matrix per layer plus two token-shift vectors in the model dtype.

Layer weights are stacked on axis 0, as in the JAX package, and walked with
a Python loop in place of its ``lax.scan``. On the card the WKV recurrence
is K6, fed the model's (B, S, H, K) projections in float32 (the JAX package
casts them there) with the layer's carried state; a decode step is a scan of
one step, as in the JAX package. The decay LoRA runs in float32 on the f32
``decay_base``. A decode step writes the states in place and returns the
cache with ``len`` advanced.

``plain=True`` runs the plain PyTorch version of the kernel, to hold the
kernel path against it on the card.
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
def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights on ``gen.device`` (the JAX package's tree and scales;
    f32 ``decay_base`` and ``u`` under any dtype), drawn one layer at a time
    so no full f32 copy of a stacked weight is made."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    ml, dl = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora

    def stack(*shape, fan_in):
        out = torch.empty((l, *shape), dtype=dt, device=dev)
        for i in range(l):
            w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            out[i] = w * (1.0 / math.sqrt(fan_in))
        return out

    def full(value, *shape, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = {
        "ln1_w": full(1.0, l, d), "ln1_b": full(0.0, l, d),
        "ln2_w": full(1.0, l, d), "ln2_b": full(0.0, l, d),
        # time-mix lerp anchors + LoRA
        "mu_x": full(0.5, l, d),
        "mu": full(0.5, l, 5, d),                       # w,k,v,r,g anchors
        "tm_w1": stack(d, 5 * ml, fan_in=d),
        "tm_w2": stack(5, ml, d, fan_in=ml),
        # decay
        "decay_base": full(-4.0, l, d, dtype=torch.float32),
        "dw1": stack(d, dl, fan_in=d),
        "dw2": stack(dl, d, fan_in=dl),
        "u": full(0.0, l, d, dtype=torch.float32),      # per-channel bonus
        # projections
        "wr": stack(d, d, fan_in=d),
        "wk": stack(d, d, fan_in=d),
        "wv": stack(d, d, fan_in=d),
        "wg": stack(d, d, fan_in=d),
        "wo": stack(d, d, fan_in=d),
        "gn_w": full(1.0, l, d), "gn_b": full(0.0, l, d),
        # channel-mix
        "cm_mu_k": full(0.5, l, d),
        "cm_mu_r": full(0.5, l, d),
        "cm_wk": stack(d, f, fan_in=d),
        "cm_wv": stack(f, d, fan_in=f),
        "cm_wr": stack(d, d, fan_in=d),
    }
    return {
        "embed": cm.embed_init(gen, cfg.vocab_size, d, dt),
        "ln0_w": full(1.0, d), "ln0_b": full(0.0, d),
        "final_ln_w": full(1.0, d), "final_ln_b": full(0.0, d),
        "head": cm.dense_init(gen, d, cfg.vocab_size, dt),
        "layers": layers,
    }


# --------------------------------------------------------------------------- #
# time-mix / channel-mix
# --------------------------------------------------------------------------- #
def _token_shift(x, prev):
    """prev: (B,1,D) last token of the previous chunk. Returns shifted x."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(x, dx, lp):
    """Data-dependent 5-way lerp (w,k,v,r,g inputs). Returns 5 mixed tensors."""
    b, s, d = x.shape
    ml = lp["tm_w1"].shape[-1] // 5
    xxx = x + dx * lp["mu_x"]
    ws = torch.tanh(xxx @ lp["tm_w1"]).reshape(b, s, 5, ml)
    offs = torch.einsum("bsim,imd->bsid", ws, lp["tm_w2"])     # (B,S,5,D)
    mix = lp["mu"][None, None] + offs                           # (B,S,5,D)
    return tuple(x + dx * mix[:, :, i] for i in range(5))


def time_mix(x, lp, cfg: ModelConfig, shift_prev, wkv_state, state_out,
             plain: bool = False):
    """Full-sequence time-mix from ``wkv_state`` (None: zeros); the final
    state goes to ``state_out``. Returns (out, new shift)."""
    b, s, d = x.shape
    h, kd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    dx = _token_shift(x, shift_prev) - x
    xw, xk, xv, xr, xg = _ddlerp(x, dx, lp)

    r = (xr @ lp["wr"]).reshape(b, s, h, kd)
    k = (xk @ lp["wk"]).reshape(b, s, h, kd)
    v = (xv @ lp["wv"]).reshape(b, s, h, kd)
    g = F.silu(xg @ lp["wg"])

    decay = lp["decay_base"] + torch.tanh(xw.float() @ lp["dw1"].float()) @ lp["dw2"].float()
    w = torch.exp(-torch.exp(decay)).reshape(b, s, h, kd)
    u = lp["u"].reshape(h, kd)

    y, _ = ops.wkv6(r.float(), k.float(), v.float(), w, u, wkv_state, state_out,
                    plain=plain)
    y = y.reshape(b, s, d).to(x.dtype)
    y = cm.groupnorm_heads(y, lp["gn_w"], lp["gn_b"], h) * g
    return y @ lp["wo"], x[:, -1:]


def channel_mix(x, lp, shift_prev):
    dx = _token_shift(x, shift_prev) - x
    xk = x + dx * lp["cm_mu_k"]
    xr = x + dx * lp["cm_mu_r"]
    r = torch.sigmoid(xr @ lp["cm_wr"])
    k = torch.square(F.relu(xk @ lp["cm_wk"]))
    return r * (k @ lp["cm_wv"]), x[:, -1:]


def _block(x, lp, cfg: ModelConfig, tm_shift, cm_shift, wkv_state, state_out,
           plain: bool):
    """One layer. The token-shift states it returns are the last rows of the
    two mixes' (normed) inputs."""
    h = cm.layernorm(x, lp["ln1_w"], lp["ln1_b"])
    y, new_tm = time_mix(h, lp, cfg, tm_shift, wkv_state, state_out, plain)
    x = x + y
    h = cm.layernorm(x, lp["ln2_w"], lp["ln2_b"])
    y, new_cm = channel_mix(h, lp, cm_shift)
    return x + y, new_tm, new_cm


# --------------------------------------------------------------------------- #
# training loss
# --------------------------------------------------------------------------- #
def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """Mean next-token cross-entropy from zero states; each layer
    rematerialised in the backward (so the WKV recurrence runs twice a layer
    forward, and its backward kernel once). Returns (loss, {"loss": loss})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = cm.layernorm(params["embed"][tokens], params["ln0_w"], params["ln0_b"])
    zeros = x.new_zeros((x.shape[0], 1, cfg.d_model))
    for lp in cm.unstack(params["layers"]):
        x = cm.remat_first(_block, x, lp, cfg, zeros, zeros, None, None, plain)
    x = cm.layernorm(x, params["final_ln_w"], params["final_ln_b"])
    loss = cm.cross_entropy(x @ params["head"], labels)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    """O(1)-in-sequence cache; ``max_len`` is ignored (kept for API parity)."""
    l, d = cfg.n_layers, cfg.d_model
    h, kd = cfg.n_rwkv_heads, cfg.rwkv_head_size
    dt = cm.param_dtype(cfg)
    return {
        "wkv": torch.zeros((l, batch, h, kd, kd), dtype=torch.float32, device=device),
        "tm_shift": torch.zeros((l, batch, 1, d), dtype=dt, device=device),
        "cm_shift": torch.zeros((l, batch, 1, d), dtype=dt, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis."""
    return [(cache[name], 1) for name in ("wkv", "tm_shift", "cm_shift")]


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights a decode step reads whole: all of them but the embedding,
    whose rows it gathers (the head is its own matrix)."""
    return cm.leaves({k: w for k, w in params.items() if k != "embed"})


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False):
    """Full-sequence forward from zero state. tokens: (B, S) int64. Returns
    (cache, logits_last) — logits for the final position, (B, 1, V)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    x = cm.layernorm(x, params["ln0_w"], params["ln0_b"])
    cache = init_cache(cfg, b, s, tokens.device)
    zeros = torch.zeros((b, 1, cfg.d_model), dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, tm, cmix = _block(x, cm.layer(params["layers"], i), cfg, zeros, zeros,
                             None, cache["wkv"][i], plain)
        cache["tm_shift"][i] = tm
        cache["cm_shift"][i] = cmix
    x = cm.layernorm(x, params["final_ln_w"], params["final_ln_b"])
    logits = x[:, -1:] @ params["head"]
    cache["len"].fill_(s)
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step. tokens: (B, 1) int64. Advances the states and
    ``len`` of ``cache`` in place (a CUDA graph of the step replays into the
    same tensors); returns (cache, logits)."""
    x = params["embed"][tokens]
    x = cm.layernorm(x, params["ln0_w"], params["ln0_b"])
    for i in range(cfg.n_layers):
        state = cache["wkv"][i]
        x, tm, cmix = _block(x, cm.layer(params["layers"], i), cfg,
                             cache["tm_shift"][i], cache["cm_shift"][i], state, state,
                             plain)
        cache["tm_shift"][i] = tm
        cache["cm_shift"][i] = cmix
    x = cm.layernorm(x, params["final_ln_w"], params["final_ln_b"])
    logits = x @ params["head"]
    cache["len"].add_(1)
    return cache, logits
