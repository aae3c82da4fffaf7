"""RMSNorm over the last axis: the CUDA kernel ``csrc/rmsnorm.cu`` on the
card, :func:`rmsnorm_plain` on the CPU.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process
LAUNCHES = 0

rmsnorm_plain = ref.rmsnorm_reference


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,). Output in x's dtype, f32 statistics."""
    global LAUNCHES
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    _build.require_cuda(x, weight)
    d = x.shape[-1]
    if weight.shape != (d,) or weight.dtype != x.dtype:
        raise ValueError(f"weight {tuple(weight.shape)} {weight.dtype} does not "
                         f"match x (..., {d}) {x.dtype}")
    if not weight.is_contiguous():
        raise ValueError("weight must be contiguous")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("x must have contiguous rows")
    rows = x2.shape[0]
    if rows >= 2**31 or d == 0:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    err = _build.library().repro_rmsnorm(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
        ctypes.c_float(eps), _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(err, "rmsnorm")
    LAUNCHES += 1
    return out.reshape(x.shape)
