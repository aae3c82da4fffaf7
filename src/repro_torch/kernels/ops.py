"""The kernels in their callers' layouts: attention and the WKV recurrence in
the model's (B, S, H, d), the selective scan in the Mamba branch's (B, S, I),
the cap-bucket scan in the run-level replay's (rows, width).

The head-major kernels read and write through strides, so these wrappers
only take views: no transpose copy of q, k, v, r, w or the KV cache. ``plain=True``
runs the plain PyTorch version on any device; it exists so the kernels can be
held against it on the card, and the serving path never sets it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import run_replay as _rr
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import ssm_scan as _ssm


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


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None,
             h_out: torch.Tensor | None = None,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """u/dt: (B,S,I); a: (I,N); b/c: (B,S,N); h0/h_out: (B,I,N). Returns
    (y (B,S,I) f32 without the D-skip, final state)."""
    fn = _ssm.ssm_scan_plain if plain else _ssm.ssm_scan
    return fn(u, dt, a, b, c, h0, h_out)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor | None = None,
         state_out: torch.Tensor | None = None,
         plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B,S,H,K); u: (H,K); state0/state_out: (B,H,K,K). Returns
    (y (B,S,H,K) f32, final state)."""
    fn = _wkv.wkv6_plain if plain else _wkv.wkv6
    y, state = fn(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  w.transpose(1, 2), u, state0, state_out)
    return y.transpose(1, 2), state


def cap_bucket_scan(sorted_p: torch.Tensor, caps: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """``#{sorted_p[r] > caps[r, c]}`` per row, int32 — the run-replay cap
    scan. ``sorted_p`` rows ascending (``-inf`` front padding allowed)."""
    fn = _rr.cap_bucket_scan_plain if plain else _rr.cap_bucket_scan
    return fn(sorted_p, caps)
