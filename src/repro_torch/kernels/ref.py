"""Plain PyTorch versions of the serving path's kernels (the correctness
contracts).

Deliberately simple O(S^2) / sequential implementations of the same maths as
the JAX package's oracles. The kernel wrappers run these for tensors on the CPU
and on the ``meta`` device, and the card's kernels are held against them.

The two attentions take :class:`AttentionKnobs`, which the models layer
builds from its tuning knobs (``models/tuning.py``), as the JAX package's
``common.attention`` and ``common.decode_attention`` read them; with the
default knobs they compute as before the knobs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint

NEG_INF = -1e30


class AttentionKnobs(NamedTuple):
    """How the plain attentions compute. ``grouped``: contract each kv
    head's group of q heads in the operands' dtype (no repeated K and V);
    ``probs_bf16``: cast P to bf16 before PV; ``q_block``: query rows a
    block (0: one block); ``block_remat``: each block under
    ``torch.utils.checkpoint``."""
    grouped: bool = False
    probs_bf16: bool = False
    q_block: int = 0
    block_remat: bool = False


#: the plain attentions' default: one block, no knob
NO_KNOBS = AttentionKnobs()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (the gradient checks' precision)."""
    return torch.promote_types(dtype, torch.float32)


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   device: torch.device, q_start: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool, True where query i may attend key j: ``j <= i`` when
    causal, ``j > i - window`` when ``window > 0``; keys count from 0,
    queries from ``q_start`` (a block of query rows)."""
    q_pos = torch.arange(q_start, q_start + sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def mha_reference(q, k, v, causal: bool = True, window: int = 0,
                  knobs: AttentionKnobs = NO_KNOBS):
    """q: (B,H,Sq,d); k/v: (B,KV,Sk,d) -> (B,H,Sq,d) f32 (f64 for f64
    inputs).

    Under ``knobs``, as ``common.attention``: ``grouped`` contracts per kv
    head in the operands' dtype, ``probs_bf16`` casts P to bf16 and takes PV
    in v's dtype; queries go in blocks of ``q_block`` rows where Sq is a
    multiple of it longer than one, each under ``torch.utils.checkpoint``
    with ``block_remat``."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    acc = acc_dtype(q.dtype)
    if knobs.grouped:
        pv_dtype = v.dtype
        q_in = q.reshape(b, kvh, h // kvh, sq, d)
    else:
        k = torch.repeat_interleave(k, h // kvh, dim=1)
        v = torch.repeat_interleave(v, h // kvh, dim=1)
        pv_dtype = v.dtype if knobs.probs_bf16 else acc
        q_in, k = q.to(acc), k.to(acc)
    v = v.to(pv_dtype)

    def block(q_blk, start):
        bq = q_blk.shape[-2]
        eq = "bgpqd,bgkd->bgpqk" if knobs.grouped else "bhqd,bhkd->bhqk"
        s = torch.einsum(eq, q_blk, k).to(acc) / math.sqrt(d)
        s = torch.where(attention_mask(bq, sk, causal, window, q.device, start), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if knobs.probs_bf16:
            p = p.to(torch.bfloat16)
        eq = "bgpqk,bgkd->bgpqd" if knobs.grouped else "bhqk,bhkd->bhqd"
        return torch.einsum(eq, p.to(pv_dtype), v).to(acc).reshape(b, h, bq, d)

    fn = block
    if knobs.block_remat:
        def fn(q_blk, start):
            return torch.utils.checkpoint.checkpoint(block, q_blk, start, use_reentrant=False)
    qb = knobs.q_block
    if not qb or sq <= qb or sq % qb:
        return fn(q_in, 0)
    return torch.cat([fn(q_in[..., i:i + qb, :], i) for i in range(0, sq, qb)], dim=-2)


def decode_attention_reference(q, k_cache, v_cache, cache_len,
                               knobs: AttentionKnobs = NO_KNOBS):
    """q: (B,H,d); caches: (B,KV,S,d); cache_len int or int tensor ->
    (B,H,d) f32. ``knobs.grouped`` and ``knobs.probs_bf16`` act as in
    :func:`mha_reference`."""
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    valid = torch.arange(s, device=q.device) < cache_len
    if knobs.grouped:
        qg = q.reshape(b, kvh, h // kvh, d)
        scores = torch.einsum("bgpd,bgkd->bgpk", qg, k_cache).float() / math.sqrt(d)
        p = torch.softmax(torch.where(valid, scores, NEG_INF), dim=-1)
        if knobs.probs_bf16:
            p = p.to(torch.bfloat16)
        out = torch.einsum("bgpk,bgkd->bgpd", p.to(v_cache.dtype), v_cache)
        return out.reshape(b, h, d).float()
    k = torch.repeat_interleave(k_cache, h // kvh, dim=1)
    v = torch.repeat_interleave(v_cache, h // kvh, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) / math.sqrt(d)
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if knobs.probs_bf16:
        p = p.to(torch.bfloat16)
        return torch.einsum("bhk,bhkd->bhd", p.to(v.dtype), v).float()
    return torch.einsum("bhk,bhkd->bhd", p, v.float())


def wkv6_reference(r, k, v, w, u, state0=None):
    """Sequential WKV-6. r/k/v/w: (B,H,S,K); u: (H,K); state0: (B,H,K,V) f32
    or None (zeros). Returns (y (B,H,S,V) f32, final state (B,H,K,V) f32),
    both f64 for f64 inputs (the gradient checks' precision)."""
    b, h, s, kd = r.shape
    acc = acc_dtype(r.dtype)
    r, k, v, w, u = (t.to(acc) for t in (r, k, v, w, u))
    state = (torch.zeros((b, h, kd, v.shape[-1]), dtype=acc, device=r.device)
             if state0 is None else state0.to(acc))
    ys = []
    for t in range(s):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, :, t, :, None] * state + kv
    y = torch.stack(ys, dim=2) if ys else v.new_zeros(v.shape)
    return y, state


def ssm_scan_reference(u, dt, a, b, c, h0=None):
    """Sequential selective scan. u/dt: (B,S,I); a: (I,N); b/c: (B,S,N); h0:
    (B,I,N) f32 or None (zeros). Returns (y (B,S,I) f32 without the D-skip,
    final state (B,I,N) f32), both f64 for f64 inputs."""
    bsz, s, di = u.shape
    n = a.shape[-1]
    acc = acc_dtype(u.dtype)
    u, dt, a, b, c = (t.to(acc) for t in (u, dt, a, b, c))
    h = (torch.zeros((bsz, di, n), dtype=acc, device=u.device)
         if h0 is None else h0.to(acc))
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)
        h = da * h + dt[:, t, :, None] * b[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum("bin,bn->bi", h, c[:, t]))
    y = torch.stack(ys, dim=1) if ys else u.new_zeros(u.shape)
    return y, h


def ssm_scan_backward_reference(u, dt, a, b, c, h0, dy, dh_out):
    """The selective scan's gradient, the analytic reverse recurrence one
    step at a time, in f32 (f64 for f64 inputs). ``dy`` (B,S,I) and
    ``dh_out`` (B,I,N) or None (zeros) are the gradients of y and of the
    final state; ``h0`` None means zeros. With dA_t = exp(dt_t a) and g_t
    the total gradient of h_t (g_{S-1} = dh_out + c_{S-1} dy_{S-1},
    g_{t-1} = dA_t g_t + c_{t-1} dy_{t-1}):

    dc_t[n] = Σ_i dy_t[i] h_t[i,n], db_t[n] = Σ_i g_t[i,n] dt_t[i] u_t[i],
    du_t[i] = dt_t[i] Σ_n g_t[i,n] b_t[n],
    ddt_t[i] = Σ_n g_t[i,n] (a[i,n] dA_t[i,n] h_{t-1}[i,n] + b_t[n] u_t[i]),
    da = Σ_{b,t} g_t dt_t dA_t h_{t-1}, dh0 = dA_0 g_0.

    Returns (du, ddt, da, db, dc, dh0)."""
    acc = acc_dtype(u.dtype)
    u, dt, a, b, c, dy = (t.to(acc) for t in (u, dt, a, b, c, dy))
    bsz, s, di = u.shape
    n = a.shape[-1]
    h = u.new_zeros((bsz, di, n)) if h0 is None else h0.to(acc)
    hs = [h]                                   # the state before each step, and the last
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h + \
            dt[:, t, :, None] * b[:, t, None, :] * u[:, t, :, None]
        hs.append(h)
    g = u.new_zeros((bsz, di, n)) if dh_out is None else dh_out.to(acc)
    du, ddt, db, dc = (torch.zeros_like(x) for x in (u, u, b, b))
    da = torch.zeros_like(a)
    for t in reversed(range(s)):
        d_a = torch.exp(dt[:, t, :, None] * a)
        g = g + c[:, t, None, :] * dy[:, t, :, None]
        dc[:, t] = torch.einsum("bi,bin->bn", dy[:, t], hs[t + 1])
        db[:, t] = torch.einsum("bin,bi->bn", g, dt[:, t] * u[:, t])
        du[:, t] = dt[:, t] * torch.einsum("bin,bn->bi", g, b[:, t])
        ddt[:, t] = (g * (a * d_a * hs[t] + b[:, t, None, :] * u[:, t, :, None])).sum(-1)
        da += (g * dt[:, t, :, None] * d_a * hs[t]).sum(0)
        g = d_a * g
    return du, ddt, da, db, dc, g


def wkv6_backward_reference(r, k, v, w, u, state0, dy, dstate_out):
    """The WKV recurrence's gradient, the analytic reverse recurrence one
    step at a time, in f32 (f64 for f64 inputs). r/k/v/w/dy: (B,H,S,K);
    u: (H,K); ``state0`` and ``dstate_out`` (B,H,K,V) or None (zeros). With
    G_t the gradient of the state after step t (G_{S-1} = dstate_out,
    the state before step t S_{t-1}):

    dr_t = (S_{t-1} + u ⊙ k_t ⊗ v_t) dy_t, dk_t = r_t u (dy_t·v_t) + G_t v_t,
    dv_t = dy_t (Σ_k r_t u k_t) + G_tᵀ k_t, dw_t[k] = Σ_v G_t[k,v] S_{t-1}[k,v],
    du = Σ_{b,t} r_t k_t (dy_t·v_t), G_{t-1} = w_t ⊙_k G_t + r_t ⊗ dy_t,
    dstate0 = G_{-1}. Never divides by a decay.

    Returns (dr, dk, dv, dw, du, dstate0)."""
    acc = acc_dtype(r.dtype)
    r, k, v, w, u, dy = (t.to(acc) for t in (r, k, v, w, u, dy))
    bsz, h, s, kd = r.shape
    state = r.new_zeros((bsz, h, kd, v.shape[-1])) if state0 is None else state0.to(acc)
    states = [state]                           # the state before each step
    for t in range(s - 1):
        state = w[:, :, t, :, None] * state + k[:, :, t, :, None] * v[:, :, t, None, :]
        states.append(state)
    grad = torch.zeros_like(states[0]) if dstate_out is None else dstate_out.to(acc)
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (r, k, v, w))
    du = torch.zeros_like(u)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dyt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t], dy[:, :, t]
        prev = states[t]
        dyv = (dyt * vt).sum(-1, keepdim=True)                      # (B,H,1)
        dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", prev, dyt) + u * kt * dyv
        dk[:, :, t] = rt * u * dyv + torch.einsum("bhkv,bhv->bhk", grad, vt)
        dv[:, :, t] = dyt * (rt * u * kt).sum(-1, keepdim=True) + \
            torch.einsum("bhkv,bhk->bhv", grad, kt)
        dw[:, :, t] = (grad * prev).sum(-1)
        du += (rt * kt * dyv).sum(0)
        grad = wt[..., None] * grad + rt[..., None] * dyt[:, :, None, :]
    return dr, dk, dv, dw, du, grad


def rmsnorm_reference(x, weight, eps: float = 1e-6):
    x32 = x.to(acc_dtype(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.to(x32.dtype)).to(x.dtype)
