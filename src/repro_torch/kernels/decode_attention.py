"""Decode attention, one query token against a KV cache with GQA: the CUDA
kernel ``csrc/decode_attention.cu`` on the card, :func:`decode_attention_plain`
on the CPU.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention``. The caches are read in place through their strides, any
cache length works, and ``cache_len`` may be an int32 tensor on the card
(read there, no host synchronisation) and may reach or pass S, where every
slot counts as valid. The kernel splits the cache over blocks
(:func:`split_plan`) and merges the splits in one launch, the last block of
each (kv head, batch) merging by a ticket kept in a per-device buffer; bf16
computes its products on the tensor cores, f32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, MAX_Q_PER_KV, require_16b_rows

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: streaming multiprocessors of the card the split plan fills (H100 SXM)
SMS = 132
#: shared memory the K and V chunks of one block may take (above C = 32):
#: at most 32 KB keeps five or more blocks on an SM
MAX_CHUNK_BYTES = 32 * 1024

_TICKETS: dict[torch.device, torch.Tensor] = {}


def decode_attention_plain(q, k_cache, v_cache, cache_len):
    return ref.decode_attention_reference(q, k_cache, v_cache, cache_len).to(q.dtype)


def split_plan(b: int, kv: int, s: int, d: int, itemsize: int) -> tuple[int, int]:
    """(C, n_split): the cache slots each block takes and the blocks per (kv
    head, batch). C is the largest of 128, 64 and 32 whose K and V chunks
    fit in ``MAX_CHUNK_BYTES`` and whose grid (n_split, KV, B) still holds
    two waves of the card's SMs; 32 where none does. The splits cover the
    cache: n_split = ceil(S / C), the last one ragged."""
    for c in (128, 64):
        if 2 * c * d * itemsize <= MAX_CHUNK_BYTES and -(-s // c) * kv * b >= 2 * SMS:
            return c, -(-s // c)
    return 32, -(-s // 32)


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The device's zeroed int32 tickets, at least ``n`` of them; the kernel
    leaves every ticket 0, so one buffer serves every call."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int | torch.Tensor) -> torch.Tensor:
    """q: (B, H, d) one token; caches: (B, KV, S, d); ``cache_len`` an int
    or a one-element int32 tensor. Returns (B, H, d) in q's dtype."""
    global LAUNCHES
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    _build.require_cuda(q, k_cache, v_cache)
    _build.refuse_grad("decode_attention (K3)", q, k_cache, v_cache)
    b, h, d = q.shape
    kb, kv, s, kd = k_cache.shape
    if (kb, kd) != (b, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)} do not match")
    if kv == 0 or h % kv or not 1 <= h // kv <= MAX_Q_PER_KV:
        raise ValueError(f"{h} q heads over {kv} kv heads: q_per_kv must be "
                         f"an integer in 1..{MAX_Q_PER_KV}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"dtypes differ: {q.dtype} {k_cache.dtype} {v_cache.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k_cache, v_cache)):
        raise ValueError("the head-dim axis must be contiguous")
    require_16b_rows(k_cache, v_cache)
    if max(b, kv, s) >= 2**31:
        raise ValueError("unsupported size")
    if isinstance(cache_len, torch.Tensor):
        if (cache_len.dtype != torch.int32 or cache_len.numel() != 1
                or cache_len.device != q.device):
            raise ValueError("cache_len must be one int32 on the query's device")
    else:
        cache_len = torch.full((1,), int(cache_len), dtype=torch.int32, device=q.device)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    chunk, n_split = split_plan(b, kv, s, d, q.element_size())
    part = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 10)(
        *q.stride()[:2], *out.stride()[:2], *k_cache.stride()[:3],
        *v_cache.stride()[:3])
    err = _build.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        cache_len.data_ptr(), part.data_ptr(), _tickets(q.device, b * kv).data_ptr(),
        ctypes.addressof(strides), b, h, kv, s, d, chunk, n_split,
        ctypes.c_float(1.0 / math.sqrt(d)), _build.dtype_code(q), _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    LAUNCHES += 1
    return out
