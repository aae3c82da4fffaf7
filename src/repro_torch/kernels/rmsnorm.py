"""RMSNorm over the last axis: the CUDA kernel ``csrc/rmsnorm.cu`` on the
card, :func:`rmsnorm_plain` on the CPU.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: vectors a thread may hold in registers (a template parameter)
VPT_CHOICES = (1, 2, 4, 8)
#: a row of at most this many vectors goes to one warp
WARP_ROW_VECTORS = 32 * VPT_CHOICES[-1]
#: rows (warps) a block when a warp takes a row
WARP_ROWS_PER_BLOCK = 8
#: threads a block when a block takes a row: at most, and the count that
#: picks the vectors a thread
BLOCK_THREADS_MAX = 512
BLOCK_THREADS_TARGET = 256

rmsnorm_plain = ref.rmsnorm_reference


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """One launch: ``width`` elements a load (16 bytes' worth, or 1 on the
    scalar path), ``vpt`` loads a thread held in registers, ``threads`` a
    block, a warp per row (``warp_rows``, ``threads // 32`` rows a block) or
    a block per row, and ``blocks`` in the grid."""
    width: int
    vpt: int
    threads: int
    warp_rows: bool
    blocks: int


def launch_plan(rows: int, d: int, itemsize: int, aligned: bool) -> NormPlan:
    """The plan for ``rows`` rows of ``d`` elements of ``itemsize`` bytes.
    16-byte vectors where every row starts 16-byte aligned (``aligned``: x,
    w and the output are, and d is a multiple of the vector), else one
    element a load. A row of up to :data:`WARP_ROW_VECTORS` vectors takes
    one warp, the fewest vectors a lane that cover it; a longer row a block,
    the fewest vectors a thread that keep it within
    :data:`BLOCK_THREADS_TARGET` threads (past 8 a thread, the kernel reads
    the rest again)."""
    vec = 16 // itemsize
    width = vec if aligned and d % vec == 0 else 1
    nv = d // width
    if nv <= WARP_ROW_VECTORS:
        vpt = next(v for v in VPT_CHOICES if 32 * v >= nv)
        per_block = min(WARP_ROWS_PER_BLOCK, rows)
        return NormPlan(width, vpt, 32 * per_block, True, -(-rows // per_block))
    vpt = next((v for v in VPT_CHOICES if -(-nv // v) <= BLOCK_THREADS_TARGET),
               VPT_CHOICES[-1])
    threads = min(BLOCK_THREADS_MAX, -(-nv // (vpt * 32)) * 32)
    return NormPlan(width, vpt, threads, False, rows)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); weight: (D,). Output in x's dtype, f32 statistics."""
    if x.device.type in _build.PLAIN_DEVICES:
        return rmsnorm_plain(x, weight, eps)
    _build.require_cuda(x, weight)
    _build.refuse_grad("rmsnorm (K1)", x, weight,
                       function="repro_torch.kernels.ops.RMSNormFunction")
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
    aligned = (x2.data_ptr() | weight.data_ptr() | out.data_ptr()) % 16 == 0
    _launch(x2, weight, out, eps, launch_plan(rows, d, x.element_size(), aligned))
    return out.reshape(x.shape)


def _launch(x2: torch.Tensor, weight: torch.Tensor, out: torch.Tensor, eps: float,
            plan: NormPlan) -> None:
    global LAUNCHES
    err = _build.library().repro_rmsnorm(
        x2.data_ptr(), weight.data_ptr(), out.data_ptr(), x2.shape[0], x2.shape[1],
        ctypes.c_float(eps), _build.dtype_code(x2), plan.width, plan.vpt, plan.threads,
        int(plan.warp_rows), _build.stream_ptr(x2))
    _build.check(err, "rmsnorm")
    LAUNCHES += 1


def empty_launch(device: torch.device) -> None:
    """Launches an empty one-warp kernel on ``device``'s current stream as
    K1 is launched: the launch floor K1's time is read against. Not counted
    in :data:`LAUNCHES`."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_build.library().repro_empty_kernel(stream), "empty")
