"""Mixture-of-Experts FFN + the granite-moe architecture.

The dense dispatch of the JAX package's ``moe.py``: every expert computed for
every token, masked by the top-k gates. Exact; O(E) FLOPs, and at serving's
few tokens a step it reads every expert's weights once a step, as a
dispatch that gathers the routed experts' weights would for most of them.
The expert-parallel dispatch (the reference's ``moe_ffn_ep``) is not ported:
``moe_ffn`` raises if asked for it.

Dtype flow, as ``moe_ffn_dense``: the router product is f32 on an f32
router (TF32 left off: it would move near-ties between experts), the gate,
up and down products run in the model dtype, the combine in f32, cast back.

Experts are zero-padded to a multiple of the expert-parallel width
(``padded_experts``); padded experts get ``-inf`` router logits.

The load-balance auxiliary loss of the reference's ``router_topk`` is a
training term: it is computed only when the loss asks for it (``aux=True``),
so the serving path, whose compiled step the JAX package strips of it as
dead code, runs none of it.

The decode step is capturable into a CUDA graph: no host read of a device
value and no shape that depends on the data (the combine weights are
scattered into a fixed ``(B, S, E)`` tensor).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import dense as _dense


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def padded_experts(cfg: ModelConfig, ep_size: int) -> int:
    return int(math.ceil(cfg.n_experts / ep_size) * ep_size)


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig, ep_size: int = 1,
                 n_layers: int | None = None) -> dict:
    """Stacked-over-layers MoE FFN params for ``n_layers`` layers (default
    ``cfg.n_layers``), drawn one layer at a time on ``gen.device``; the
    router stays f32. d_expert is the per-expert width. Each layer's stack
    is drawn in chunks of whole experts of at most ``common.DRAW_CHUNK``
    elements (:func:`common.fill_normal_`), so deepseek-v3's (256, 7168,
    2048) stacks need 1-GiB f32 temporaries, not 15-GB ones; a stack of at
    most that many elements a layer (granite-moe's) is one draw."""
    dt = cm.param_dtype(cfg)
    dev = gen.device
    l = cfg.n_layers if n_layers is None else n_layers
    d, fe, e = cfg.d_model, cfg.d_expert, padded_experts(cfg, ep_size)

    def stack(*shape, fan_in: int, dtype: torch.dtype = dt) -> torch.Tensor:
        out = torch.empty((l, *shape), dtype=dtype, device=dev)
        for i in range(l):
            cm.fill_normal_(out[i], gen, 1.0 / math.sqrt(fan_in))
        return out

    params = {
        "router": stack(d, e, fan_in=d, dtype=torch.float32),
        "we_gate": stack(e, d, fe, fan_in=d),
        "we_up": stack(e, d, fe, fan_in=d),
        "we_down": stack(e, fe, d, fan_in=fe),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_expert * cfg.n_shared_experts
        params["ws_gate"] = stack(d, fs, fan_in=d)
        params["ws_up"] = stack(d, fs, fan_in=d)
        params["ws_down"] = stack(fs, d, fan_in=fs)
    return params


# --------------------------------------------------------------------------- #
# routing and the dense dispatch
# --------------------------------------------------------------------------- #
def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: ModelConfig,
                aux: bool = False) -> tuple:
    """Returns (gates (..., k) f32, ids (..., k) int64, aux loss), as the
    reference's; the switch-style load-balance loss over the real experts
    is computed with ``aux`` only, else None.

    ``jax.lax.top_k`` puts the lower index first among equal logits;
    ``torch.topk`` does not, so the top k are taken from a stable
    descending sort, which keeps the reference's order on exact ties (the
    ``-inf`` of padded experts among them)."""
    logits = x.float() @ w_router.float()
    e_pad = w_router.shape[-1]
    if e_pad > cfg.n_experts:  # mask padded experts
        pad_mask = torch.arange(e_pad, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad_mask, float("-inf"))
    top_logits, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, ids = top_logits[..., :cfg.top_k], ids[..., :cfg.top_k]
    gates = torch.softmax(top_logits, dim=-1)
    if not aux:
        return gates, ids, None
    me = torch.softmax(logits, dim=-1).reshape(-1, e_pad).mean(dim=0)
    assign = F.one_hot(ids, e_pad).float().sum(dim=-2)
    ce = assign.reshape(-1, e_pad).mean(dim=0) / cfg.top_k
    return gates, ids, cfg.n_experts * (me * ce).sum()


def moe_ffn_dense(x: torch.Tensor, p: dict, cfg: ModelConfig, aux: bool = False):
    """All-experts compute, gate-masked. x: (B, S, D). Exact oracle. Returns
    (output, aux loss or None), as :func:`router_topk` says.

    The expert products are batched over experts, (E, B*S, D) @ (E, D, F),
    so each expert's weights are read in place."""
    b, s, d = x.shape
    gates, ids, aux_loss = router_topk(x, p["router"], cfg, aux)
    e_pad = p["router"].shape[-1]
    combine = torch.zeros((b, s, e_pad), dtype=torch.float32, device=x.device)
    combine.scatter_(-1, ids, gates)                             # (B,S,E)
    xe = x.reshape(1, b * s, d).expand(e_pad, b * s, d)
    h = torch.bmm(xe, p["we_gate"])                              # (E,N,F)
    u = torch.bmm(xe, p["we_up"])
    y = torch.bmm(cm.act_fn(cfg.act)(h) * u, p["we_down"])       # (E,N,D)
    out = torch.einsum("end,ne->nd", y.float(), combine.reshape(b * s, e_pad))
    return out.reshape(b, s, d).to(x.dtype), aux_loss


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig, ep_size: int = 1,
            aux: bool = False):
    """Routed experts + optional shared experts: (output, aux loss or
    None), as :func:`moe_ffn_dense`."""
    if ep_size > 1:
        raise NotImplementedError("the expert-parallel dispatch is not ported")
    out, aux_loss = moe_ffn_dense(x, p, cfg, aux)
    if cfg.n_shared_experts:
        out = out + cm.glu_mlp(x, p["ws_gate"], p["ws_up"], p["ws_down"], cfg.act)
    return out, aux_loss


def _moe_residual(x, lp, cfg: ModelConfig, plain: bool, aux: bool = False):
    """(x + MoE FFN of the RMS-normed x, aux loss or None); the norm is
    K1."""
    h = ops.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plain=plain)
    y, aux_loss = moe_ffn(h, lp, cfg, aux=aux)
    return x + y, aux_loss


# =========================================================================== #
# granite-moe architecture: GQA attention blocks with MoE FFNs
# =========================================================================== #
def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    params = _dense.init_params(gen, cfg)
    layers = params["layers"]
    # replace the dense FFN with MoE FFN params
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    layers.update(init_moe_ffn(gen, cfg))
    return params


init_cache = _dense.init_cache
cache_rows = _dense.cache_rows
decode_params = _dense.decode_params


def _prefill_layer(x, lp, cfg: ModelConfig, positions, plain: bool, aux: bool = False):
    """One layer of the prefill: (x after the layer, its keys, its values,
    its aux loss or None); the training loss asks for the aux loss."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    attn = ops.flash_attention(q, k, v, causal=True, plain=plain)
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    x, aux_loss = _moe_residual(x, lp, cfg, plain, aux)
    return x, k, v, aux_loss


def _decode_layer(x, lp, cfg: ModelConfig, caches, at, plain: bool):
    """One layer of the decode step. ``caches``: the layer's (keys, values),
    written at ``write_at`` in place; ``at``: (pos, write_at, cache_len) of
    the step (:func:`decode_at`). Returns x after the layer."""
    b = x.shape[0]
    k_cache, v_cache = caches
    pos, write_at, cache_len = at
    positions = pos.reshape(1, 1).expand(b, 1)
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    k_cache.index_copy_(1, write_at, k)
    v_cache.index_copy_(1, write_at, v)
    attn = ops.decode_attention(q, k_cache, v_cache, cache_len, plain=plain)
    x = x + attn.reshape(b, 1, -1) @ lp["wo"]
    return _moe_residual(x, lp, cfg, plain)[0]


def decode_at(pos: torch.Tensor, cache_size: int) -> tuple:
    """(pos, write_at, cache_len) of a decode step at position ``pos`` (a
    0-d int32 tensor) over a cache of ``cache_size`` slots: the new entry
    goes to ``pos`` clamped to the last slot (the reference's
    ``dynamic_update_slice``), and the slots before ``pos + 1`` are valid."""
    return pos, pos.clamp(max=cache_size - 1).reshape(1).long(), pos + 1


def layers(params, cfg: ModelConfig) -> list[dict]:
    """Every layer's parameters, in order."""
    return [cm.layer(params["layers"], i) for i in range(cfg.n_layers)]


def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False):
    """The cross-entropy plus ``router_aux_coef`` times the layers' mean
    load-balance loss; each layer rematerialised in the backward. Returns
    (loss, {"loss", "ce", "aux"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux_sum = 0.0
    for lp in cm.unstack(params["layers"]):
        x, _, _, aux = cm.remat(_prefill_layer, x, lp, cfg, positions, plain, True)
        aux_sum = aux_sum + aux
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    ce = cm.cross_entropy(cm.lm_logits(x, params["embed"], params.get("out_head")), labels)
    aux = cfg.router_aux_coef * aux_sum / cfg.n_layers
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False):
    """Full-sequence forward that also populates the KV cache, as
    ``dense.prefill`` with the MoE FFN. Returns (cache, logits_last)."""
    b, s = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens]
    positions = torch.arange(s, device=dev)
    cache_shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks = torch.empty(cache_shape, dtype=x.dtype, device=dev)
    vs = torch.empty(cache_shape, dtype=x.dtype, device=dev)
    for i, lp in enumerate(layers(params, cfg)):
        x, ks[i], vs[i], _ = _prefill_layer(x, lp, cfg, positions, plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x[:, -1:], params["embed"], params.get("out_head"))
    cache = {"k": ks, "v": vs,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False):
    """One decode step, as ``dense.decode_step`` with the MoE FFN: writes the
    new keys and values into ``cache`` and advances its ``len``, all in
    place; returns (cache, logits)."""
    x = params["embed"][tokens]
    at = decode_at(cache["len"], cache["k"].shape[2])
    for i, lp in enumerate(layers(params, cfg)):
        x = _decode_layer(x, lp, cfg, (cache["k"][i], cache["v"][i]), at, plain)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"], params.get("out_head"))
    cache["len"].copy_(at[2])           # last: every layer read the old position
    return cache, logits
