"""Mixture-of-Experts FFN + the granite-moe architecture, as the JAX
package's ``moe.py``.

Two dispatch paths with identical semantics:

* **dense** (``LOCAL``, or a model axis of 1): every expert computed for
  every token, masked by the top-k gates. Exact; O(E) FLOPs, and at
  serving's few tokens a step it reads every expert's weights once a step,
  as a dispatch that gathers the routed experts' weights would for most of
  them.
* **expert-parallel** (a mesh whose ``model`` axis is wider than 1,
  :func:`moe_ffn_ep`): tokens are sequence-sharded over ``model``, routed
  into fixed-capacity per-expert buffers, exchanged by two all-to-alls over
  the ``model`` group, processed as batched per-expert products and combined
  on the way back. Capacity overflow drops tokens (GShard), as the
  reference's does.

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
from repro_torch.distributed.context import LOCAL, DistContext
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
                aux: bool = False, dist: DistContext = LOCAL) -> tuple:
    """Returns (gates (..., k) f32, ids (..., k) int64, aux loss), as the
    reference's; the switch-style load-balance loss over the real experts
    is computed with ``aux`` only, else None. Under a ``dist`` whose batch
    axes are wider than 1, x is this rank's rows and the loss's expert
    shares are the global batch's, as the reference's (GSPMD) means are.

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
    if dist.enabled and dist.dp_size > 1:
        me = _AxesMean.apply(me, dist, dist.batch_axes, 1.0)
        ce = _AxesMean.apply(ce, dist, dist.batch_axes, 1.0)
    return gates, ids, cfg.n_experts * (me * ce).sum()


def moe_ffn_dense(x: torch.Tensor, p: dict, cfg: ModelConfig, aux: bool = False,
                  dist: DistContext = LOCAL):
    """All-experts compute, gate-masked. x: (B, S, D). Exact oracle. Returns
    (output, aux loss or None), as :func:`router_topk` says.

    The expert products are batched over experts, (E, B*S, D) @ (E, D, F),
    so each expert's weights are read in place."""
    b, s, d = x.shape
    gates, ids, aux_loss = router_topk(x, p["router"], cfg, aux, dist)
    e_pad = p["router"].shape[-1]
    combine = torch.zeros((b, s, e_pad), dtype=torch.float32, device=x.device)
    combine.scatter_(-1, ids, gates)                             # (B,S,E)
    xe = x.reshape(1, b * s, d).expand(e_pad, b * s, d)
    h = torch.bmm(xe, p["we_gate"])                              # (E,N,F)
    u = torch.bmm(xe, p["we_up"])
    y = torch.bmm(cm.act_fn(cfg.act)(h) * u, p["we_down"])       # (E,N,D)
    out = torch.einsum("end,ne->nd", y.float(), combine.reshape(b * s, e_pad))
    return out.reshape(b, s, d).to(x.dtype), aux_loss


# --------------------------------------------------------------------------- #
# expert-parallel dispatch (two all-to-alls over the model group)
# --------------------------------------------------------------------------- #
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` in equal splits of dim 0: chunk j
    goes to rank j, and chunk j of the output came from rank j. Its backward
    sends each gradient back to where its input came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    torch.distributed.all_to_all_single(out, x, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _SplitSeq(torch.autograd.Function):
    """This model rank's slice of the sequence (dim 1) of a tensor that is
    the same on every rank of ``group``; the backward gathers the slices'
    gradients, so every rank holds the whole gradient again."""

    @staticmethod
    def forward(ctx, x, group, rank: int, n: int):
        ctx.group = group
        s = x.shape[1] // n
        return x[:, rank * s:(rank + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, 1), None, None, None


class _GatherSeq(torch.autograd.Function):
    """The slices of ``group`` gathered along the sequence (dim 1); what
    follows is the same on every rank, so the backward keeps this rank's
    slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank: int):
        ctx.rank, ctx.s = rank, x.shape[1]
        return _gather(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.s:(ctx.rank + 1) * ctx.s].contiguous(), None, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over ``group``: a weight
    the same on every rank, each rank using it on its own slice of tokens."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _AxesMean(torch.autograd.Function):
    """The mean of a tensor over the ranks of the mesh ``axes`` (the
    reference's ``pmean``, or GSPMD's mean over a sharded batch). Every rank
    adds its loss's term alike, and the train step averages gradients over
    the batch axes, so the backward only scales the gradient, by ``scale``,
    with no communication (:func:`moe_ffn_ep` says which)."""

    @staticmethod
    def forward(ctx, x, dist: DistContext, axes: tuple, scale: float):
        ctx.scale = scale
        out = x.detach().clone()
        for name in axes:
            torch.distributed.all_reduce(out, group=dist.mesh.get_group(name))
        return out / dist.axis_size(tuple(axes))

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


def _local_experts(w: torch.Tensor, e_pad: int, rank: int, ep: int) -> torch.Tensor:
    """This rank's ``e_pad / ep`` experts of a stack: the stack itself when
    it holds only those (the train step's), else its slice."""
    e_loc = e_pad // ep
    if w.shape[0] == e_loc:
        return w
    if w.shape[0] != e_pad:
        raise ValueError(f"an expert stack of {w.shape[0]} experts; want {e_pad} or "
                         f"this rank's {e_loc}")
    return w[rank * e_loc:(rank + 1) * e_loc]


def _ep_block(x_loc, router, we_gate, we_up, we_down, *, cfg: ModelConfig, group,
              ep_size: int, capacity_factor: float, aux: bool):
    """Per-rank body: x_loc (b, s, D) the tokens this rank dispatches, the
    expert stacks this rank's ``e_pad / ep_size`` experts. Returns (out_loc,
    aux loss of these tokens or None)."""
    b, s, d = x_loc.shape
    e_pad = router.shape[-1]
    e_loc = e_pad // ep_size
    k = cfg.top_k
    n_tok = b * s
    n_assign = n_tok * k
    cap = max(1, int(math.ceil(n_tok * k / e_pad * capacity_factor)))
    dev = x_loc.device

    xf = x_loc.reshape(n_tok, d)
    gates, ids, aux_loss = router_topk(xf, router, cfg, aux)      # (n,k)
    flat_ids = ids.reshape(-1)                                     # (n*k,)
    flat_gates = gates.reshape(-1)
    tok_idx = torch.arange(n_tok, device=dev).repeat_interleave(k)

    # position of each assignment within its expert's capacity buffer
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(flat_ids, minlength=e_pad)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n_assign, device=dev) - starts[sorted_ids]
    slot = torch.where(pos_in_e < cap, pos_in_e, cap)              # overflow -> dropped row

    # scatter tokens into (E, cap+1, D); slot `cap` catches drops
    send = xf.new_zeros((e_pad, cap + 1, d)).index_put(
        (sorted_ids, slot), xf[tok_idx[order]])
    send = send[:, :cap].reshape(ep_size, e_loc, cap, d)

    # exchange: recv[src] is what rank src sent this rank's experts
    recv = _AllToAll.apply(send, group)                            # (ep_src, e_loc, cap, D)
    hbuf = recv.transpose(0, 1).reshape(e_loc, ep_size * cap, d)
    g = cm.act_fn(cfg.act)(torch.bmm(hbuf, we_gate))
    u = torch.bmm(hbuf, we_up)
    y = torch.bmm(g * u, we_down)                                  # (e_loc, ep*cap, D)
    y = y.reshape(e_loc, ep_size, cap, d).transpose(0, 1)          # (ep, e_loc, cap, D)
    back = _AllToAll.apply(y, group).reshape(e_pad, cap, d)

    # gather per-assignment results and combine with gates (segment sum)
    back = torch.cat([back, back.new_zeros((e_pad, 1, d))], dim=1)  # slot `cap` -> zeros
    y_assign = back.new_zeros((n_assign, d)).index_put((order,), back[sorted_ids, slot])
    out = torch.zeros((n_tok, d), dtype=torch.float32, device=dev).index_add(
        0, tok_idx, y_assign.float() * flat_gates[:, None])
    return out.reshape(b, s, d).to(x_loc.dtype), aux_loss


def moe_ffn_ep(x: torch.Tensor, p: dict, cfg: ModelConfig, dist: DistContext,
               capacity_factor: float = 1.25, aux: bool = False):
    """Expert-parallel MoE FFN. x: (B, S, D), this rank's batch rows (the
    same on every rank of its ``model`` group). Returns (out, aux loss over
    the whole mesh or None).

    Train/prefill (S divisible by the model axis): every model rank
    dispatches its own slice of the sequence, and the outputs are gathered
    back over ``model``. Decode (S=1): every rank dispatches all tokens,
    every expert shard receives the same dispatch from each rank and the
    combine keeps each rank's own copy; correct, with redundant expert FLOPs
    proportional to ep_size, as the reference's.

    The expert stacks are this rank's experts or the whole stacks, whose
    slice is taken; the router is whole. Gradients: everything outside the
    dispatch is computed alike on every rank of the ``model`` group, so each
    rank's backward yields the whole gradient of x (the slices' gradients
    are gathered), of the router (summed over the slices that used it) and
    of its own experts (scaled by 1/ep_size at decode, where each expert
    sees every token ep_size times). The aux loss is the mean of the ranks'
    losses over every mesh axis, as the reference's; its backward gives each
    rank ``1/ep_size`` of the gradient when the tokens are split over
    ``model``, all of it when they are not, so that gradients averaged over
    the batch axes (the train step's reduction) are the mean loss's."""
    group = dist.mesh.get_group(dist.model_axis)
    ep = dist.ep_size
    rank = dist.mesh.get_local_rank(dist.model_axis)
    e_pad = p["router"].shape[-1]
    seq_shard = x.shape[1] % ep == 0 and x.shape[1] >= ep
    weights = [_local_experts(p[name], e_pad, rank, ep)
               for name in ("we_gate", "we_up", "we_down")]
    router = p["router"]
    if seq_shard:
        x_loc = _SplitSeq.apply(x, group, rank, ep)
        router = _SumGrad.apply(router, group)
    else:
        x_loc = x
        weights = [_ScaleGrad.apply(w, 1.0 / ep) for w in weights]
    out, aux_loss = _ep_block(x_loc, router, *weights, cfg=cfg, group=group, ep_size=ep,
                              capacity_factor=capacity_factor, aux=aux)
    if seq_shard:
        out = _GatherSeq.apply(out, group, rank)
    if aux_loss is not None:
        aux_loss = _AxesMean.apply(aux_loss, dist, dist.mesh.mesh_dim_names,
                                   1.0 / ep if seq_shard else 1.0)
    return out, aux_loss


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig, dist: DistContext = LOCAL,
            capacity_factor: float = 1.25, aux: bool = False):
    """Routed experts + optional shared experts: (output, aux loss or
    None). Expert-parallel (:func:`moe_ffn_ep`) when ``dist`` has a model
    axis wider than 1, else the dense dispatch."""
    if dist.enabled and dist.ep_size > 1:
        out, aux_loss = moe_ffn_ep(x, p, cfg, dist, capacity_factor, aux)
    else:
        out, aux_loss = moe_ffn_dense(x, p, cfg, aux, dist)
    if cfg.n_shared_experts:
        out = out + cm.glu_mlp(x, p["ws_gate"], p["ws_up"], p["ws_down"], cfg.act)
    return out, aux_loss


def _moe_residual(x, lp, cfg: ModelConfig, plain: bool, aux: bool = False,
                  dist: DistContext = LOCAL):
    """(x + MoE FFN of the RMS-normed x, aux loss or None); the norm is
    K1."""
    h = ops.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plain=plain)
    y, aux_loss = moe_ffn(h, lp, cfg, dist, aux=aux)
    return x + y, aux_loss


# =========================================================================== #
# granite-moe architecture: GQA attention blocks with MoE FFNs
# =========================================================================== #
def init_params(gen: torch.Generator, cfg: ModelConfig, ep_size: int = 1) -> dict:
    params = _dense.init_params(gen, cfg)
    layers = params["layers"]
    # replace the dense FFN with MoE FFN params
    for name in ("w_gate", "w_up", "w_down"):
        del layers[name]
    layers.update(init_moe_ffn(gen, cfg, ep_size))
    return params


init_cache = _dense.init_cache
cache_rows = _dense.cache_rows
decode_params = _dense.decode_params


def _prefill_layer(x, lp, cfg: ModelConfig, positions, plain: bool, aux: bool = False,
                   dist: DistContext = LOCAL):
    """One layer of the prefill: (x after the layer, its keys, its values,
    its aux loss or None); the training loss asks for the aux loss."""
    b, s, _ = x.shape
    h = ops.rmsnorm(x, lp["attn_norm"], cfg.norm_eps, plain=plain)
    q, k, v = cm.qkv(h, lp, cfg)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    attn = ops.flash_attention(q, k, v, causal=True, plain=plain)
    x = x + attn.reshape(b, s, -1) @ lp["wo"]
    x, aux_loss = _moe_residual(x, lp, cfg, plain, aux, dist)
    return x, k, v, aux_loss


def _decode_layer(x, lp, cfg: ModelConfig, caches, at, plain: bool,
                  dist: DistContext = LOCAL):
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
    return _moe_residual(x, lp, cfg, plain, dist=dist)[0]


def decode_at(pos: torch.Tensor, cache_size: int) -> tuple:
    """(pos, write_at, cache_len) of a decode step at position ``pos`` (a
    0-d int32 tensor) over a cache of ``cache_size`` slots: the new entry
    goes to ``pos`` clamped to the last slot (the reference's
    ``dynamic_update_slice``), and the slots before ``pos + 1`` are valid."""
    return pos, pos.clamp(max=cache_size - 1).reshape(1).long(), pos + 1


def layers(params, cfg: ModelConfig) -> list[dict]:
    """Every layer's parameters, in order."""
    return [cm.layer(params["layers"], i) for i in range(cfg.n_layers)]


def loss_fn(params, batch, cfg: ModelConfig, plain: bool = False,
            dist: DistContext = LOCAL):
    """The cross-entropy plus ``router_aux_coef`` times the layers' mean
    load-balance loss; each layer rematerialised in the backward. Returns
    (loss, {"loss", "ce", "aux"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux_sum = 0.0
    for lp in cm.unstack(params["layers"]):
        x, _, _, aux = cm.remat(_prefill_layer, x, lp, cfg, positions, plain, True, dist)
        aux_sum = aux_sum + aux
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    ce = cm.cross_entropy(cm.lm_logits(x, params["embed"], params.get("out_head")), labels)
    aux = cfg.router_aux_coef * aux_sum / cfg.n_layers
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False,
            dist: DistContext = LOCAL):
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
        x, ks[i], vs[i], _ = _prefill_layer(x, lp, cfg, positions, plain, dist=dist)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x[:, -1:], params["embed"], params.get("out_head"))
    cache = {"k": ks, "v": vs,
             "len": torch.full((), s, dtype=torch.int32, device=dev)}
    return cache, logits


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False,
                dist: DistContext = LOCAL):
    """One decode step, as ``dense.decode_step`` with the MoE FFN: writes the
    new keys and values into ``cache`` and advances its ``len``, all in
    place; returns (cache, logits)."""
    x = params["embed"][tokens]
    at = decode_at(cache["len"], cache["k"].shape[2])
    for i, lp in enumerate(layers(params, cfg)):
        x = _decode_layer(x, lp, cfg, (cache["k"][i], cache["v"][i]), at, plain, dist)
    x = ops.rmsnorm(x, params["final_norm"], cfg.norm_eps, plain=plain)
    logits = cm.lm_logits(x, params["embed"], params.get("out_head"))
    cache["len"].copy_(at[2])           # last: every layer read the old position
    return cache, logits
