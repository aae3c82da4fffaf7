"""The kernels in their callers' layouts: attention in the model's (B, S, H,
d), the cap-bucket scan in the run-level replay's (rows, width).

The head-major kernels read and write through strides, so these wrappers
only take views: no transpose copy of q, k, v or the KV cache. ``plain=True``
runs the plain PyTorch version on any device; it exists so the kernels can be
held against it on the card, and the serving path never sets it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import run_replay as _rr


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            plain: bool = False) -> torch.Tensor:
    fn = _rms.rmsnorm_plain if plain else _rms.rmsnorm
    return fn(x, weight, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    plain: bool = False) -> torch.Tensor:
    """q: (B,S,H,d); k/v: (B,S,KV,d). Returns (B,S,H,d)."""
    fn = _fa.flash_attention_plain if plain else _fa.flash_attention
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, window=window)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int | torch.Tensor, plain: bool = False) -> torch.Tensor:
    """q: (B,1,H,d); caches: (B,S,KV,d). Returns (B,1,H,d)."""
    fn = _da.decode_attention_plain if plain else _da.decode_attention
    out = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), cache_len)
    return out[:, None]


def cap_bucket_scan(sorted_p: torch.Tensor, caps: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """``#{sorted_p[r] > caps[r, c]}`` per row, int32 — the run-replay cap
    scan. ``sorted_p`` rows ascending (``-inf`` front padding allowed)."""
    fn = _rr.cap_bucket_scan_plain if plain else _rr.cap_bucket_scan
    return fn(sorted_p, caps)
