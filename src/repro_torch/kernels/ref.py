"""Plain PyTorch versions of the serving path's kernels (the correctness
contracts).

Deliberately simple O(S^2) implementations of the same maths as the JAX
package's oracles. The kernel wrappers run these for tensors on the CPU,
and the card's kernels are held against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,d); k/v: (B,KV,Sk,d) -> (B,H,Sq,d) f32."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, h // kvh, dim=1)
    v = torch.repeat_interleave(v, h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


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


def rmsnorm_reference(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
