"""The kernels in their callers' layouts: attention and the WKV recurrence in
the model's (B, S, H, d), the selective scan in the Mamba branch's (B, S, I),
the cap-bucket scan in the run-level replay's (rows, width).

The head-major kernels read and write through strides, so these wrappers
only take views: no transpose copy of q, k, v, r, w or the KV cache. ``plain=True``
runs the plain PyTorch version on any device; it exists so the kernels can be
held against it on the card, and the serving path never sets it.

Under autograd (grad mode on and an input that requires grad) RMSNorm,
prefill attention, the selective scan and the WKV recurrence run inside
:class:`RMSNormFunction`, :class:`FlashAttentionFunction`,
:class:`SsmScanFunction` and :class:`Wkv6Function`: the forward is the
kernel wrapper (the plain version on a CPU tensor); the backward is the
analytic gradient in PyTorch ops for the first two and a backward kernel
for the recurrences (their plain backwards on a CPU tensor). Only the
training loss reaches them; inference, whose inputs require no grad, calls
the wrappers as before. Decode attention, the cap-bucket scan and the
cooldown chain have no backward: their wrappers refuse a CUDA tensor that
requires grad.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import run_replay as _rr
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels.ref import NEG_INF, NO_KNOBS, AttentionKnobs, acc_dtype, attention_mask


def _grad_wanted(*tensors: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class RMSNormFunction(torch.autograd.Function):
    """K1 with its gradient. Forward: the kernel wrapper alone; it saves x
    and the weight. Backward, from the rows' f32 reciprocal RMS rstd
    computed there once, with x̂ = x * rstd and g = dy * w:
    dx = rstd * (g - x̂ * mean(g * x̂)), dw = sum over rows of dy * x̂, both
    in f32 (f64 for f64 inputs)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms.rmsnorm(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        x32 = x.to(acc_dtype(x.dtype))
        rstd = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = x32 * rstd
        dy = dy.to(x32.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            g = dy * weight.to(x32.dtype)
            dx = (rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (dy * xhat).reshape(-1, x.shape[-1]).sum(dim=0).to(weight.dtype)
        return dx, dw, None


@functools.lru_cache(maxsize=16)
def _backward_masks(sq: int, sk: int, causal: bool, window: int, groups: int, scale: float,
                    device: torch.device, dtype: torch.dtype, q_start: int = 0) -> tuple:
    """(score bias, 0 where a key is kept and NEG_INF where masked; scale
    where kept and 0 where masked), each (groups * Sq, Sk) for the
    backward's stacked rows of queries ``q_start`` on. Every layer's
    backward at one shape takes the same two, so they are built once."""
    keep = attention_mask(sq, sk, causal, window, device, q_start).repeat(groups, 1)
    bias = torch.full(keep.shape, NEG_INF, dtype=dtype, device=device).masked_fill_(keep, 0.0)
    return bias, keep.to(dtype) * scale


class FlashAttentionFunction(torch.autograd.Function):
    """K2 with its gradient, in the model's (B, S, H, d) layout. Forward: the
    kernel wrapper; it saves q, k, v and the output O. Backward in f32 (f64
    for f64 inputs), each kv head's group of g q heads stacked as g * Sq
    rows so that every product is one batched matmul: P = softmax(QKᵀ/√d)
    recomputed under the forward's mask (causal, window, Sq ≠ Sk) as an
    additive bias, dV = Pᵀ dO, dP = dO Vᵀ, dS = P ∘ (dP − rowsum(dO ∘ O)),
    dQ = dS K/√d, dK = dSᵀ Q/√d; the products over the stacked rows sum dK
    and dV over the group's q heads.

    Under ``knobs`` (:class:`repro_torch.kernels.ref.AttentionKnobs`, which
    the models layer sets from its tuning knobs): with ``block_remat`` P and
    dS are rebuilt a block of ``q_block`` query rows at a time (where Sq is
    a multiple longer than one block), dK and dV summed over the blocks, as
    the reference's per-block ``jax.checkpoint`` rebuilds them. With
    ``probs_bf16``, where the forward ran the plain version (which casts P
    to bf16 before PV), the backward is autograd's through that cast, as the
    reference's is: P rounded to bf16 for dV, dP rounded to bf16, and the
    softmax's row term Σ dP ∘ P taken from them (O is the rounded P's
    product, so rowsum(dO ∘ O) no longer equals it). K2 keeps P in f32, so
    on the card the backward keeps it too. With the default knobs, one
    block in f32."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, knobs=NO_KNOBS):
        out = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window, knobs=knobs).transpose(1, 2)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        ctx.q_block = knobs.q_block if knobs.block_remat else 0
        ctx.probs_bf16 = knobs.probs_bf16 and q.device.type in _build.PLAIN_DEVICES
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        g = h // kvh
        acc = acc_dtype(q.dtype)
        scale = 1.0 / math.sqrt(d)

        def heads(t):  # (B, S, N, d) -> (B * KV, N // KV, S, d) in acc: one copy
            n, t_s = t.shape[2], t.shape[1]
            return t.new_empty((b, n, t_s, d), dtype=acc).copy_(t.transpose(1, 2)).view(
                b * kvh, n // kvh, t_s, d)

        qh, doh, oh = map(heads, (q, dout, out))
        kh, vh = (heads(t)[:, 0] for t in (k, v))
        qb = ctx.q_block
        blocked = qb and sq > qb and sq % qb == 0
        dqs, dk, dv = [], None, None
        for i in range(0, sq, qb) if blocked else (0,):
            rows = slice(i, i + qb) if blocked else slice(None)
            n = qb if blocked else sq
            qr, dor, outr = (t[:, :, rows].reshape(b * kvh, g * n, d) for t in (qh, doh, oh))
            bias, keep_scale = _backward_masks(n, sk, ctx.causal, ctx.window, g, scale,
                                               q.device, acc, i)
            p = torch.softmax(torch.baddbmm(bias, qr, kh.transpose(1, 2), alpha=scale), dim=-1)
            dp = torch.bmm(dor, vh.transpose(1, 2))
            if ctx.probs_bf16:
                dv_r = torch.bmm(p.to(torch.bfloat16).to(acc).transpose(1, 2), dor)
                dp = dp.to(torch.bfloat16).to(acc)
                rowsum = (dp * p).sum(dim=-1, keepdim=True)
            else:
                dv_r = torch.bmm(p.transpose(1, 2), dor)
                rowsum = (dor * outr).sum(dim=-1, keepdim=True)
            # dS, in place of dP; a masked score is a constant: no gradient (a
            # row masked whole averages V)
            ds = dp.sub_(rowsum).mul_(p).mul_(keep_scale)
            dqs.append(torch.bmm(ds, kh).view(b * kvh, g, n, d))
            dk_r = torch.bmm(ds.transpose(1, 2), qr)
            dk, dv = (dk_r, dv_r) if dk is None else (dk + dk_r, dv + dv_r)
        dq = (dqs[0] if len(dqs) == 1 else torch.cat(dqs, dim=2)).view(b, h, sq, d).transpose(1, 2)
        dk = dk.view(b, kvh, sk, d).transpose(1, 2)
        dv = dv.view(b, kvh, sk, d).transpose(1, 2)
        return (dq.to(q.dtype, memory_format=torch.contiguous_format),
                dk.to(k.dtype, memory_format=torch.contiguous_format),
                dv.to(v.dtype, memory_format=torch.contiguous_format), None, None, None)


class SsmScanFunction(torch.autograd.Function):
    """K5 with its gradient, in the Mamba branch's (B, S, I) layout.
    Forward: the kernel wrapper; it saves its inputs and the initial state
    (None: zeros). Backward: the backward kernel
    (:func:`repro_torch.kernels.ssm_scan.ssm_scan_backward`, the plain
    reverse recurrence on a CPU tensor) from the gradients of y and of the
    final state (None where the loss does not use it: zeros)."""

    @staticmethod
    def forward(ctx, u, dt, a, b, c, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u, dt, a, b, c, h0)
        return _ssm.ssm_scan(u, dt, a, b, c, h0)

    @staticmethod
    def backward(ctx, dy, dh_out):
        u, dt, a, b, c, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, ddt, da, db, dc, dh0 = _ssm.ssm_scan_backward(u, dt, a, b, c, h0, dy, dh_out)
        return du, ddt, da, db, dc, None if h0 is None else dh0


class Wkv6Function(torch.autograd.Function):
    """K6 with its gradient, in the model's (B, S, H, K) layout. Forward:
    the kernel wrapper on head-major views; it saves its inputs and the
    initial state (None: zeros). Backward: the backward kernel
    (:func:`repro_torch.kernels.rwkv6_scan.wkv6_backward`, the plain
    reverse recurrence on a CPU tensor) from the gradients of y and of the
    final state (None where the loss does not use it: zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state0)
        y, state = _wkv.wkv6(*(t.transpose(1, 2) for t in (r, k, v, w)), u, state0)
        return y.transpose(1, 2), state

    @staticmethod
    def backward(ctx, dy, dstate_out):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        r, k, v, w, dy = (t.transpose(1, 2) for t in (r, k, v, w, dy))
        dr, dk, dv, dw, du, dstate0 = _wkv.wkv6_backward(r, k, v, w, u, state0, dy,
                                                         dstate_out)
        return (*(t.transpose(1, 2) for t in (dr, dk, dv, dw)), du,
                None if state0 is None else dstate0)


def _refuse_in_place(name: str, out: torch.Tensor | None) -> None:
    if out is not None:
        raise RuntimeError(f"{name}: the final state cannot be written in place under "
                           "autograd (a decode step's carried state); call it without "
                           "the output state, or without grad")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            plain: bool = False) -> torch.Tensor:
    if plain:
        return _rms.rmsnorm_plain(x, weight, eps)
    if _grad_wanted(x, weight):
        return RMSNormFunction.apply(x, weight, eps)
    return _rms.rmsnorm(x, weight, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, plain: bool = False,
                    knobs: AttentionKnobs = NO_KNOBS) -> torch.Tensor:
    """q: (B,S,H,d); k/v: (B,S,KV,d). Returns (B,S,H,d)."""
    if not plain and _grad_wanted(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, window, knobs)
    fn = _fa.flash_attention_plain if plain else _fa.flash_attention
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, window=window, knobs=knobs)
    return out.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int | torch.Tensor, plain: bool = False,
                     knobs: AttentionKnobs = NO_KNOBS) -> torch.Tensor:
    """q: (B,1,H,d); caches: (B,S,KV,d). Returns (B,1,H,d)."""
    fn = _da.decode_attention_plain if plain else _da.decode_attention
    out = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), cache_len, knobs)
    return out[:, None]


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None,
             h_out: torch.Tensor | None = None,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """u/dt: (B,S,I); a: (I,N); b/c: (B,S,N); h0/h_out: (B,I,N). Returns
    (y (B,S,I) f32 without the D-skip, final state). Under autograd
    through :class:`SsmScanFunction`, which takes no ``h_out``."""
    if not plain and _grad_wanted(u, dt, a, b, c, h0):
        _refuse_in_place("ssm_scan", h_out)
        return SsmScanFunction.apply(u, dt, a, b, c, h0)
    fn = _ssm.ssm_scan_plain if plain else _ssm.ssm_scan
    return fn(u, dt, a, b, c, h0, h_out)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor | None = None,
         state_out: torch.Tensor | None = None,
         plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B,S,H,K); u: (H,K); state0/state_out: (B,H,K,K). Returns
    (y (B,S,H,K) f32, final state). Under autograd through
    :class:`Wkv6Function`, which takes no ``state_out``."""
    if not plain and _grad_wanted(r, k, v, w, u, state0):
        _refuse_in_place("wkv6", state_out)
        return Wkv6Function.apply(r, k, v, w, u, state0)
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
