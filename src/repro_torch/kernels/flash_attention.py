"""Forward attention with causal and sliding-window masks and GQA: the CUDA
kernels of ``csrc/flash_attention.cu`` on the card, :func:`flash_attention_plain`
on the CPU.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention``. Unlike it, any sequence length works (ragged tiles are
masked), and inputs are read through their strides, so head-major views of
the model's (B, S, H, d) tensors need no copy. On the card the element type
picks the kernel (:func:`route`): bf16 runs on the tensor cores (wgmma fed by
TMA), f32 on the CUDA cores, whose f32 arithmetic the f32 checks need.
The plain version follows ``knobs`` (:class:`repro_torch.kernels.ref.AttentionKnobs`);
the kernels read none: their GQA is grouped by construction and their
probabilities stay f32 until the bf16 kernel rounds P to bf16 as PV's
operand (the f32 kernel never rounds them).

The gradient (``csrc/flash_attention_bwd.cu``, K2′): where
:func:`backward_route` says ``"kernels"``, the training forward
(:func:`flash_attention_lse`) also keeps each row's log-sum-exp, and
:func:`flash_attention_backward` recomputes P from it tile by tile on the
tensor cores in two kernels, dQ and dK/dV, never writing an (Sq, Sk)
tensor; :func:`flash_attention_backward_plain` is their arithmetic in
PyTorch. Other calls take the backward in PyTorch ops
(``ops.FlashAttentionFunction``).
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
#: launches of the backward's dQ kernel and of its dK/dV kernel
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
#: the head dims of the backward kernels (d 256 would hold 2 x 128 f32
#: accumulators a thread in the dK/dV kernel)
BWD_HEAD_DIMS = (32, 64, 128)
MAX_Q_PER_KV = 8
#: query rows a tile of the tensor-core kernels; the log-sum-exp and D rows
#: are padded to whole tiles
TILE_ROWS = 64


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call of ``dtype`` launches: ``"wgmma"`` (bf16, the
    tensor cores) or ``"cuda_cores"`` (f32)."""
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"unsupported dtype {dtype}; the kernels take bfloat16 and float32")


def backward_route(device_type: str, dtype: torch.dtype, head_dim: int) -> str:
    """The backward a call of ``FlashAttentionFunction`` takes, decided at
    its forward from what the inputs show: ``"kernels"`` (K2′, the two
    tensor-core backward kernels after the forward that keeps each row's
    log-sum-exp) for a CUDA call in bf16 at a head dim of
    :data:`BWD_HEAD_DIMS`; else ``"ops"``, the backward in PyTorch ops: on
    the CPU and ``meta`` (the plain path and the dry-run), for f32 and f64
    (the f32 checks need f32 arithmetic) and at d 256. The tuning knobs
    (``q_block``, ``attn_block_remat``, ``attn_probs_bf16``) act on the ops
    backward only: the kernels never build P whole."""
    if device_type == "cuda" and dtype == torch.bfloat16 and head_dim in BWD_HEAD_DIMS:
        return "kernels"
    return "ops"


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


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          knobs: ref.AttentionKnobs = ref.NO_KNOBS):
    return ref.mha_reference(q, k, v, causal=causal, window=window, knobs=knobs).to(q.dtype)


def _scores(q, k, causal: bool, window: int):
    """(B, KV, g, Sq, Sk) scaled scores in f32 (f64 for f64 inputs) of q
    (B, H, Sq, d) against k (B, KV, Sk, d), and the mask's keep."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    acc = ref.acc_dtype(q.dtype)
    s = torch.einsum("bgpqd,bgkd->bgpqk", q.to(acc).reshape(b, kvh, h // kvh, sq, d),
                     k.to(acc)) / math.sqrt(d)
    return s, ref.attention_mask(sq, sk, causal, window, q.device)


def softmax_lse_plain(q, k, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, H, Sq): each query row's log-sum-exp (natural) of its scaled
    scores over the keys the mask keeps, in f32 (f64 for f64 inputs); -inf
    for a row that keeps none. The kernels keep it in base 2, times
    log2(e)."""
    s, keep = _scores(q, k, causal, window)
    s = s.masked_fill(~keep, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = m_safe + torch.log(torch.exp(s - m_safe).sum(dim=-1, keepdim=True))
    return lse.reshape(q.shape[0], q.shape[1], q.shape[2])


def softmax_delta_plain(out, dout) -> torch.Tensor:
    """D = rowsum(dO o O), (…, Sq) of (…, Sq, d) inputs, in f32 (f64 for
    f64 inputs): the softmax backward's row term, Σ_k P dP for P of rows
    that keep a key."""
    acc = ref.acc_dtype(out.dtype)
    return (dout.to(acc) * out.to(acc)).sum(dim=-1)


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                                   window: int = 0) -> tuple:
    """The backward kernels' arithmetic in PyTorch, head-major (q, out, dout
    (B, H, Sq, d); k, v (B, KV, Sk, d); lse (B, H, ≥ Sq) in base 2, as
    :func:`flash_attention_lse` keeps it): P = 2^(s log2(e) − lse) where the
    mask keeps, else 0; dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − D), dQ = dS K
    / √d, dK = dSᵀ Q / √d, dK and dV summed over each kv head's group. With
    bf16 inputs P and dS are rounded to bf16 before their products, as the
    kernels round them; sums in f32 (f64 for f64 inputs). Returns (dq, dk,
    dv) in the inputs' dtype and shapes."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    acc = ref.acc_dtype(q.dtype)
    operand = torch.bfloat16 if q.dtype == torch.bfloat16 else acc
    s, keep = _scores(q, k, causal, window)
    lse = lse[..., :sq].to(acc).reshape(b, kvh, h // kvh, sq, 1)
    p = torch.where(keep, torch.exp2(s * math.log2(math.e) - lse), 0.0)
    do = dout.to(acc).reshape(b, kvh, h // kvh, sq, d)
    delta = softmax_delta_plain(out, dout).reshape(b, kvh, h // kvh, sq, 1)
    dp = torch.einsum("bgpqd,bgkd->bgpqk", do, v.to(acc))
    ds = (p * (dp - delta)).to(operand).to(acc)
    p = p.to(operand).to(acc)
    qg = q.to(acc).reshape(b, kvh, h // kvh, sq, d)
    dv = torch.einsum("bgpqk,bgpqd->bgkd", p, do)
    dk = torch.einsum("bgpqk,bgpqd->bgkd", ds, qg) / math.sqrt(d)
    dq = torch.einsum("bgpqk,bgkd->bgpqd", ds, k.to(acc)) / math.sqrt(d)
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, window: int) -> str:
    """Raise on what the kernels do not take; return the forward's kernel."""
    _build.require_cuda(q, k, v)
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
    return kernel


def _strides(*tensors) -> ctypes.Array:
    """The (batch, head, seq) strides of each head-major view, in order.
    Keep the array referenced until the call that reads its address
    returns."""
    return (ctypes.c_int64 * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    knobs: ref.AttentionKnobs = ref.NO_KNOBS) -> torch.Tensor:
    """q: (B, H, Sq, d); k/v: (B, KV, Sk, d). Returns (B, H, Sq, d) in q's
    dtype. ``knobs`` acts on the plain version only.

    On the card the result is a head-major view of memory laid out as
    (B, Sq, H, d), so the model layout is one free transpose away.
    """
    global LAUNCHES, WGMMA_LAUNCHES
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window, knobs=knobs)
    _build.refuse_grad("flash_attention (K2)", q, k, v,
                       function="repro_torch.kernels.ops.FlashAttentionFunction")
    kernel = _check(q, k, v, window)
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    # The bf16 kernel's TMA tensor maps are encoded on the host here, from
    # q, k and v's addresses, and passed by value: a CUDA graph that captures
    # this call replays them unchanged. That is right only while q, k and v
    # keep their addresses, as they do in a captured prefill, where they are
    # intermediates in the graph's own memory pool.
    strides = _strides(q, k, v, out)
    lib = _build.library()
    fn = lib.repro_flash_attention_bf16 if kernel == "wgmma" else lib.repro_flash_attention_f32
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ctypes.addressof(strides), b, h, k.shape[1], sq, k.shape[2], d,
             ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window,
             _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    LAUNCHES += 1
    if kernel == "wgmma":
        WGMMA_LAUNCHES += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> tuple:
    """The training forward of a :func:`backward_route` ``"kernels"`` call:
    :func:`flash_attention`'s tensor-core kernel in its instantiation that
    also keeps each row's log-sum-exp. Returns (out as
    :func:`flash_attention` returns it, lse (B, H, Sq rounded up to whole
    :data:`TILE_ROWS`) f32, base 2: log2 Σ 2^(s log2(e)) over the kept keys
    of the scaled scores s, +inf for a row that keeps none; the padding rows
    hold the kernel's values for zero queries). Only
    ``ops.FlashAttentionFunction`` calls it; it launches nothing under
    autograd itself."""
    global LAUNCHES, WGMMA_LAUNCHES
    _build.refuse_grad("flash_attention (K2)", q, k, v,
                       function="repro_torch.kernels.ops.FlashAttentionFunction")
    b, h, sq, d = q.shape
    if _check(q, k, v, window) != "wgmma" or d not in BWD_HEAD_DIMS:
        raise ValueError(f"the training forward takes bf16 at head dims {BWD_HEAD_DIMS}, "
                         f"not {q.dtype} at {d}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, -(-sq // TILE_ROWS) * TILE_ROWS), dtype=torch.float32,
                      device=q.device)
    strides = _strides(q, k, v, out)
    err = _build.library().repro_flash_attention_bf16_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), b, h, k.shape[1], sq, k.shape[2], d,
        ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window, lse.data_ptr(),
        _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    LAUNCHES += 1
    WGMMA_LAUNCHES += 1
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0) -> tuple:
    """K2′: the gradient of :func:`flash_attention_lse`'s call, head-major as
    it (q, out, dout (B, H, Sq, d); k, v (B, KV, Sk, d); lse as it returned
    it), on the tensor cores: the dQ kernel (which also stores D =
    rowsum(dO ∘ O)), then the dK/dV kernel. Returns (dq, dk, dv) in bf16,
    each a head-major view of memory laid out as the model's (B, S, N, d).
    No float atomics: two calls give the same bits."""
    global BWD_DQ_LAUNCHES, BWD_DKV_LAUNCHES
    _build.require_cuda(q, k, v, out, lse, dout)
    _build.refuse_grad("flash_attention_backward (K2')", q, k, v, out, dout)
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if _check(q, k, v, window) != "wgmma" or d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernels take bf16 at head dims {BWD_HEAD_DIMS}, "
                         f"not {q.dtype} at {d}")
    sq_pad = -(-sq // TILE_ROWS) * TILE_ROWS
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.shape != (b, h, sq_pad)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, dout {tuple(dout.shape)} "
                         f"{dout.dtype}, lse {tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if any(t.stride(-1) != 1 for t in (out, dout)):
        raise ValueError("the head-dim axis must be contiguous")
    require_16b_rows(out, dout)
    delta = torch.empty_like(lse)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk, dv = (torch.empty((b, sk, kv, d), dtype=q.dtype, device=q.device).transpose(1, 2)
              for _ in range(2))
    # tensor maps encoded here, as the forward's: a captured train step
    # replays them at the addresses of its own pool
    strides = _strides(q, k, v, out, dout, dq, dk, dv)
    err = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(strides), b, h, kv, sq, sk, d,
        ctypes.c_float(1.0 / math.sqrt(d)), int(causal), window, _build.stream_ptr(q))
    _build.check(err, "flash_attention_backward")
    BWD_DQ_LAUNCHES += 1
    BWD_DKV_LAUNCHES += 1
    return dq, dk, dv
