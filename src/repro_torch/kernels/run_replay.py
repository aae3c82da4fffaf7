"""The run-level replay's cap-bucket scan: the CUDA kernel
``csrc/cap_bucket_scan.cu`` on the card, :func:`cap_bucket_scan_plain` on the
CPU.

Replaces the TPU kernel ``src/repro/kernels/run_replay.py::cap_bucket_scan``
(``_cap_scan_kernel``). The power-cap evaluator reduces every cap to ``k =
#{p > cap}`` against a stream's sorted per-state power bucket; clipped
energy, throttle count and the cube-law penalty are then gathers into prefix
sums (:mod:`repro_torch.whatif.backend`).

Rows may be front-padded with ``-inf`` to a common width: ``-inf <= cap``
always, so the padding only shifts the insertion point and ``Np - insertion``
still counts exactly the real samples above the cap. ``caps`` is read
through its strides, so a ``[S, C]`` cap table ``expand``-ed over the four
buckets of each stream is never materialised.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
LAUNCHES = 0


def _iters(n: int) -> int:
    return max(int(n).bit_length(), 1)


def cap_bucket_scan_plain(sorted_p: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """``Np - bisect_right(sorted_p[..., :], caps[..., c])`` as int32, by the
    same fixed-trip bisection as the kernel: ``lo`` converges to the
    insertion point in ``bit_length(Np)`` halvings, and lanes already done
    keep ``lo == hi``."""
    n = sorted_p.shape[-1]
    if n == 0:
        return torch.zeros(caps.shape, dtype=torch.int32, device=caps.device)
    lo = torch.zeros(caps.shape, dtype=torch.int64, device=caps.device)
    hi = torch.full(caps.shape, n, dtype=torch.int64, device=caps.device)
    for _ in range(_iters(n)):
        cont = lo < hi
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        right = cont & (torch.gather(sorted_p, -1, mid) <= caps)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(cont & ~right, mid, hi)
    return (n - lo).to(torch.int32)


def cap_bucket_scan(sorted_p: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """``k[..., c] = #{sorted_p[..., :] > caps[..., c]}``.

    ``sorted_p``: ``[R, Np]`` or ``[G, B, Np]`` float64, each row ascending;
    ``caps``: float64 of the same leading shape with ``C`` last, any strides
    (an expanded view is fine). Returns int32 of ``caps``' shape, contiguous.
    """
    global LAUNCHES
    if sorted_p.dim() not in (2, 3) or caps.dim() != sorted_p.dim() \
            or caps.shape[:-1] != sorted_p.shape[:-1]:
        raise ValueError(f"sorted_p {tuple(sorted_p.shape)} and caps "
                         f"{tuple(caps.shape)} must share their leading axes")
    if sorted_p.dtype != torch.float64 or caps.dtype != torch.float64:
        raise ValueError(f"float64 inputs only, got {sorted_p.dtype} {caps.dtype}")
    if sorted_p.device.type == "cpu" and caps.device.type == "cpu":
        return cap_bucket_scan_plain(sorted_p, caps)
    _build.require_cuda(sorted_p, caps)
    if not sorted_p.is_contiguous():
        raise ValueError("sorted_p must be contiguous")
    sp3 = sorted_p if sorted_p.dim() == 3 else sorted_p[None]
    caps3 = caps if caps.dim() == 3 else caps[None]
    g, b, n = sp3.shape
    c = caps3.shape[-1]
    if n >= 2**31 or c >= 2**31:
        raise ValueError(f"unsupported row width {n} or cap count {c}")
    out = torch.empty(caps3.shape, dtype=torch.int32, device=caps.device)
    if out.numel() == 0 or n == 0:
        return out.zero_().reshape(caps.shape)
    err = _build.library().repro_cap_bucket_scan(
        sp3.data_ptr(), caps3.data_ptr(), out.data_ptr(), g, b, n, c,
        *caps3.stride(), _iters(n), _build.stream_ptr(caps))
    _build.check(err, "cap_bucket_scan")
    LAUNCHES += 1
    return out.reshape(caps.shape)
