"""Plain PyTorch versions of the serving path's kernels (the correctness
contracts).

Deliberately simple O(S^2) / sequential implementations of the same maths as
the JAX package's oracles. The kernel wrappers run these for tensors on the CPU,
and the card's kernels are held against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (the gradient checks' precision)."""
    return torch.promote_types(dtype, torch.float32)


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   device: torch.device) -> torch.Tensor:
    """(Sq, Sk) bool, True where query i may attend key j: ``j <= i`` when
    causal, ``j > i - window`` when ``window > 0``; positions count from 0
    on both sides."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def mha_reference(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,d); k/v: (B,KV,Sk,d) -> (B,H,Sq,d) f32 (f64 for f64
    inputs)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    acc = acc_dtype(q.dtype)
    k = torch.repeat_interleave(k, h // kvh, dim=1)
    v = torch.repeat_interleave(v, h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(d)
    s = torch.where(attention_mask(sq, sk, causal, window, q.device)[None, None], s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc))


def decode_attention_reference(q, k_cache, v_cache, cache_len):
    """q: (B,H,d); caches: (B,KV,S,d); cache_len int or int tensor ->
    (B,H,d) f32."""
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    k = torch.repeat_interleave(k_cache, h // kvh, dim=1)
    v = torch.repeat_interleave(v_cache, h // kvh, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), k.float()) / math.sqrt(d)
    valid = torch.arange(s, device=q.device)[None, None, :] < cache_len
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v.float())


def wkv6_reference(r, k, v, w, u, state0=None):
    """Sequential WKV-6. r/k/v/w: (B,H,S,K); u: (H,K); state0: (B,H,K,V) f32
    or None (zeros). Returns (y (B,H,S,V) f32, final state (B,H,K,V) f32)."""
    b, h, s, kd = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = (torch.zeros((b, h, kd, v.shape[-1]), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float())
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
    final state (B,I,N) f32)."""
    bsz, s, di = u.shape
    n = a.shape[-1]
    u, dt, b, c = (t.float() for t in (u, dt, b, c))
    a = a.float()
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)
        h = da * h + dt[:, t, :, None] * b[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum("bin,bn->bi", h, c[:, t]))
    y = torch.stack(ys, dim=1) if ys else u.new_zeros(u.shape)
    return y, h


def rmsnorm_reference(x, weight, eps: float = 1e-6):
    x32 = x.to(acc_dtype(x.dtype))
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.to(x32.dtype)).to(x.dtype)
