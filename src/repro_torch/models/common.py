"""Building blocks of the model families: init helpers, LayerNorm and the
per-head GroupNorm (RWKV), RoPE, the QKV projection, the GLU MLP block,
the plain two-layer MLP (whisper), the LM head, and the training pieces:
the cross-entropy, per-layer rematerialisation, a stack split into its
layers, and the chunk-checkpointed scan.

Parameters are plain dicts of tensors. RMSNorm, attention and decode
attention are the Hopper kernels, called from ``repro_torch.kernels.ops``;
the projections, MLP and LM head are ``torch.matmul``. :func:`attention`
and :func:`decode_attention` read the tuning knobs (``models/tuning.py``),
as the JAX package's ``common.attention`` and ``common.decode_attention``
do, and pass them to the kernels' wrappers; with every knob off this is
the reference's default path.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models import tuning


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` name."""
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------- #
# init helpers (same scales as the JAX package; torch draws other numbers)
# --------------------------------------------------------------------------- #
#: the most elements :func:`fill_normal_` draws in f32 at once
DRAW_CHUNK = 1 << 28


def fill_normal_(out: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``out`` in place with normal draws from ``gen`` times ``scale``,
    cast to its dtype. The draws are made in f32 over slices of whole rows
    of axis 0, each at most :data:`DRAW_CHUNK` elements, so a tensor of any
    size is made with f32 temporaries of at most 1 GiB; a tensor of at most
    that many elements is one draw of its whole shape."""
    step = max(1, DRAW_CHUNK // max(1, math.prod(out.shape[1:])))
    for r in range(0, out.shape[0], step):
        part = out[r:r + step]
        w = torch.randn(part.shape, generator=gen, device=gen.device, dtype=torch.float32)
        part.copy_((w * scale).to(out.dtype))
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    return fill_normal_(torch.empty((d_in, d_out), dtype=dtype, device=gen.device), gen,
                        1.0 / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return fill_normal_(torch.empty((vocab, d), dtype=dtype, device=gen.device), gen, 0.02)


def normal_stack(gen: torch.Generator, shape: tuple[int, ...], scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """A new ``(*lead, d_in, d_out)`` tensor on ``gen.device`` whose every
    matrix is filled by :func:`fill_normal_` in turn."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for mat in out.reshape(-1, *shape[-2:]):
        fill_normal_(mat, gen, scale)
    return out


def layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of weights stacked on axis 0."""
    return {name: w[i] for name, w in layers.items()}


def unstack(layers: dict) -> list[dict]:
    """Every layer's weights of a stack on axis 0, each stacked tensor split
    once with ``unbind``. The training loss walks a stack this way: indexing
    a layer out of it (:func:`layer`) once per layer would make each
    ``select``'s backward write a zero tensor as large as the whole stack."""
    names = list(layers)
    return [dict(zip(names, row)) for row in zip(*(layers[n].unbind(0) for n in names))]


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a parameter tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for node in tree for t in leaves(node)]
    return [tree]


# --------------------------------------------------------------------------- #
# norms (RMSNorm is the kernel in repro_torch.kernels)
# --------------------------------------------------------------------------- #
def layernorm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    normed = (x32 - mu) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def groupnorm_heads(x, weight, bias, n_heads: int, eps: float = 1e-5):
    """GroupNorm over head groups; x: (..., n_heads * head_dim). Used by RWKV."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], n_heads, shape[-1] // n_heads).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, unbiased=False, keepdim=True)
    xn = ((xh - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return (xn * weight.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). Half-rotation convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        angles = positions.float()[:, None] * freqs[None, :]     # (S, hd/2)
        angles = angles[None, :, None, :]                         # (1, S, 1, hd/2)
    else:
        angles = positions.float()[..., None] * freqs             # (B, S, hd/2)
        angles = angles[:, :, None, :]                            # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# attention projections, MLP and head
# --------------------------------------------------------------------------- #
def qkv(x, lp, cfg):
    """q (B,S,H,hd) and k, v (B,S,KV,hd), with the optional QKV bias."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    return q, k, v


def attention(q, k, v, causal: bool = True, window: int = 0, plain: bool = False):
    """Prefill attention (K2, ``ops.flash_attention``) under the active
    tuning knobs. q: (B,S,H,d); k/v: (B,S,KV,d)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window, plain=plain,
                               knobs=tuning.attention_knobs())


def decode_attention(q, k_cache, v_cache, cache_len, plain: bool = False):
    """Decode attention (K3, ``ops.decode_attention``) under the active
    tuning knobs. q: (B,1,H,d); caches: (B,S,KV,d)."""
    return ops.decode_attention(q, k_cache, v_cache, cache_len, plain=plain,
                                knobs=tuning.attention_knobs())


def mlp_residual(x, lp, cfg, plain: bool):
    """x + GLU MLP of the RMS-normed x (the norm is K1)."""
    h = ops.rmsnorm(x, lp["mlp_norm"], cfg.norm_eps, plain=plain)
    return x + glu_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)


# --------------------------------------------------------------------------- #
# MLP and head
# --------------------------------------------------------------------------- #
def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def glu_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    """SwiGLU / GeGLU: down(act(gate(x)) * up(x))."""
    g = act_fn(act)(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def dense_mlp(x, w_up, b_up, w_down, b_down, act: str = "gelu"):
    """Plain 2-layer MLP with biases (whisper)."""
    return act_fn(act)(x @ w_up + b_up) @ w_down + b_down


def lm_logits(x, embed, out_head=None):
    """Project hidden states to vocabulary (tied embeddings by default)."""
    w = embed.T if out_head is None else out_head
    return x @ w


# --------------------------------------------------------------------------- #
# training: loss, rematerialisation, chunked scan
# --------------------------------------------------------------------------- #
def cross_entropy(logits, labels, mask=None):
    """logits: (..., V) any float dtype; labels int (...,). Mean of the f32
    negative log-likelihood over ``mask`` (all positions when None)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def remat(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept: the per-layer ``jax.checkpoint`` of the JAX package's losses."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def remat_first(fn: Callable, *args):
    """The first output of ``fn(*args)`` under :func:`remat`: the loss's
    use of a layer that also returns what the prefill keeps (its keys,
    values or states)."""
    return remat(lambda *a: fn(*a)[0], *args)


def _scan(step: Callable, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step: Callable, init, xs, chunk: int = 64):
    """``carry, y_t = step(carry, x_t)`` over the leading (time) axis of the
    tensors ``xs``; returns (final carry, ys stacked on axis 0).

    The backward keeps the carry only at chunk boundaries and recomputes
    within a chunk (:func:`remat` per chunk), as the JAX package's
    ``chunked_scan`` does for long recurrences; a plain loop when the time
    axis is at most ``chunk`` or not a multiple of it."""
    length = xs[0].shape[0]
    if chunk <= 1 or length % chunk or length <= chunk:
        return _scan(step, init, xs)
    carry, ys = init, []
    for t in range(0, length, chunk):
        carry, y = remat(lambda c, *xc: _scan(step, c, xc), carry,
                         *(x[t:t + chunk] for x in xs))
        ys.append(y)
    return carry, torch.cat(ys)
