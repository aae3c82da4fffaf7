"""Forward attention with causal and sliding-window masks and GQA: the CUDA
kernels of ``csrc/flash_attention.cu`` on the card, :func:`flash_attention_plain`
on the CPU.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention``. Unlike it, any sequence length works (ragged tiles are
masked), and inputs are read through their strides, so head-major views of
the model's (B, S, H, d) tensors need no copy. On the card the element type
picks the kernel (:func:`route`): bf16 runs on the tensor cores (wgmma fed by
TMA), f32 on the CUDA cores, whose f32 arithmetic the f32 checks need.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

#: launches of either CUDA kernel in this process
LAUNCHES = 0
#: of them, launches of the tensor-core (bf16) kernel
WGMMA_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
MAX_Q_PER_KV = 8


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call of ``dtype`` launches: ``"wgmma"`` (bf16, the
    tensor cores) or ``"cuda_cores"`` (f32)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"unsupported dtype {dtype}; the kernels take bfloat16 and float32")


def require_16b_rows(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor's rows (its last axis) can be read in 16-byte
    units, as tensor maps and 16-byte copies read them: a 16-byte aligned
    start and, on every other axis longer than 1, a stride of whole 16
    bytes."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(n > 1 and (st * size) % 16
                                    for n, st in zip(t.shape[:-1], t.stride()[:-1])):
            raise ValueError(f"tensor of shape {tuple(t.shape)} and strides "
                             f"{t.stride()} is not readable in 16-byte rows")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    return ref.mha_reference(q, k, v, causal=causal, window=window).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, KV, Sk, d). Returns (B, H, Sq, d) in q's
    dtype.

    On the card the result is a head-major view of memory laid out as
    (B, Sq, H, d), so the model layout is one free transpose away.
    """
    global LAUNCHES, WGMMA_LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _build.require_cuda(q, k, v)
    _build.refuse_grad("flash_attention (K2)", q, k, v,
                       function="repro_torch.kernels.ops.FlashAttentionFunction")
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if (kb, kd) != (b, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if kv == 0 or h % kv or not 1 <= h // kv <= MAX_Q_PER_KV:
        raise ValueError(f"{h} q heads over {kv} kv heads: q_per_kv must be "
                         f"an integer in 1..{MAX_Q_PER_KV}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    kernel = route(q.dtype)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head-dim axis must be contiguous")
    if kernel == "wgmma":
        require_16b_rows(q, k, v)
    if window < 0 or max(b, h, sq, sk) >= 2**31:
        raise ValueError("unsupported window or size")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    # The bf16 kernel's TMA tensor maps are encoded on the host here, from
    # q, k and v's addresses, and passed by value: a CUDA graph that captures
    # this call replays them unchanged. That is right only while q, k and v
    # keep their addresses, as they do in a captured prefill, where they are
    # intermediates in the graph's own memory pool.
    lib = _build.library()
    fn = lib.repro_flash_attention_bf16 if kernel == "wgmma" else lib.repro_flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), b, h, kv, sq, sk, d,
             ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    LAUNCHES += 1
    if kernel == "wgmma":
        WGMMA_LAUNCHES += 1
    return out
