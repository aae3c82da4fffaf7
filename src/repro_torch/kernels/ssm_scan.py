"""Mamba selective scan: the CUDA kernel ``csrc/ssm_scan.cu`` on the card,
:func:`ssm_scan_plain` on the CPU.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan.py::ssm_scan``. Unlike
it, the scan may start from a carried state ``h0`` (a decode step is a scan
of one step), any length works, and the inputs are read through their
strides. ``h_out`` receives the final state and may be ``h0`` itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: SSM state sizes the kernel is compiled for
STATE_SIZES = (8, 16)


def ssm_scan_plain(u, dt, a, b, c, h0=None, h_out=None):
    y, h = ref.ssm_scan_reference(u, dt, a, b, c, h0)
    if h_out is not None:
        h = h_out.copy_(h)
    return y, h


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None,
             h_out: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """u/dt: (B, S, I); a: (I, N), negative; b/c: (B, S, N); h0: (B, I, N) or
    None (zeros). All float32. Returns (y (B, S, I) without the D-skip term,
    final state (B, I, N)), the state in ``h_out`` when given."""
    global LAUNCHES
    if u.device.type == "cpu":
        return ssm_scan_plain(u, dt, a, b, c, h0, h_out)
    states = [t for t in (h0, h_out) if t is not None]
    _build.require_cuda(u, dt, a, b, c, *states)
    bsz, s, di = u.shape
    n = a.shape[-1]
    if (dt.shape != u.shape or a.shape != (di, n) or b.shape != (bsz, s, n)
            or c.shape != b.shape
            or any(t.shape != (bsz, di, n) for t in states)):
        raise ValueError(f"shapes u {tuple(u.shape)} dt {tuple(dt.shape)} a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} "
                         f"states {[tuple(t.shape) for t in states]} do not match")
    if any(t.dtype != torch.float32 for t in (u, dt, a, b, c, *states)):
        raise ValueError("the selective scan takes float32 tensors")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} not in {STATE_SIZES}")
    if not all(t.is_contiguous() for t in states):
        raise ValueError("h0 and h_out must be contiguous")
    if max(bsz, s, di) >= 2**31 or bsz >= 2**16:
        raise ValueError(f"unsupported shape {tuple(u.shape)}")
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=u.device)
    if h_out is None:
        h_out = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    if bsz * di == 0:
        return y, h_out
    strides = (ctypes.c_int64 * 14)(*u.stride(), *dt.stride(), *b.stride(),
                                    *c.stride(), *a.stride())
    err = _build.library().repro_ssm_scan(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        ctypes.addressof(strides), bsz, s, di, n, _build.stream_ptr(u))
    _build.check(err, "ssm_scan")
    LAUNCHES += 1
    return y, h_out
