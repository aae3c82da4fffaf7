"""The yardstick's arithmetic: one H100's published peaks, and the
operations and bytes of a piece of work computed from its shapes.

A count follows the work, not an implementation: each input byte read once
and each output byte written once, whatever a kernel reads again, and the
operations the mathematics needs. ``Work`` keeps the operations as seconds at
their peak (bf16 tensor-core work at 989 TFLOP/s, float32 work outside the
tensor cores at 67 TFLOP/s), so works of both kinds add up; its bound is the
larger of that time and its bytes at 3.35 TB/s, and ``bound_by`` says which.
"""
from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM, dense, at its 700-W limit (NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float = 0.0          # bf16 tensor-core operations
    f32_flops: float = 0.0      # float32 operations outside the tensor cores
    bytes: float = 0.0

    @property
    def flop_s(self) -> float:
        return self.flops / BF16_FLOPS_PER_S + self.f32_flops / F32_FLOPS_PER_S

    @property
    def byte_s(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    @property
    def bound_s(self) -> float:
        return max(self.flop_s, self.byte_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.flop_s >= self.byte_s else "bytes"

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.f32_flops + other.f32_flops,
                    self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.f32_flops * k, self.bytes * k)


def total(works) -> Work:
    out = Work()
    for w in works:
        out = out + w
    return out


def visible_keys(s: int, window: int) -> int:
    """Keys that the S queries of a causal attention see in all, each the
    ones at or before it and, with ``window``, fewer than ``window`` back."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention(b: int, s: int, h: int, kv: int, d: int, window: int = 0,
              elt: int = 2) -> Work:
    """K2, causal prefill attention with GQA: QK^T and PV over the visible
    keys; q, k, v read and o written once, ``elt`` bytes an element."""
    return Work(flops=4 * b * h * d * visible_keys(s, window),
                bytes=elt * b * s * d * (2 * h + 2 * kv))


def decode_attention(b: int, h: int, kv: int, d: int, valid: int, elt: int = 2) -> Work:
    """K3, one query a row against the ``valid`` cache slots it reads: the
    keys and values of those slots, q and o."""
    return Work(flops=4 * b * h * d * valid,
                bytes=elt * (2 * b * valid * kv * d + 2 * b * h * d))


def ssm_scan_backward(b: int, s: int, i: int, n: int) -> Work:
    """K5′, the selective scan's reverse recurrence: 26 float32 operations a
    state entry and step; u, dt, dy, du, ddt, a, da, B, C, dB, dC once."""
    return Work(f32_flops=26 * b * s * i * n,
                bytes=4 * (5 * b * s * i + 2 * i * n + 4 * b * s * n))


def wkv(b: int, s: int, h: int, k: int) -> Work:
    """K6, the WKV recurrence: 7 float32 operations a state entry and step;
    r, k, v, w and y, u, and the state read and written once."""
    return Work(f32_flops=7 * b * s * h * k * k,
                bytes=4 * (5 * b * s * h * k + h * k + 2 * b * h * k * k))


def wkv_backward(b: int, h: int, s: int, k: int) -> Work:
    """K6′, the WKV reverse recurrence: 15 float32 operations a state entry
    and step; r, k, v, w, dy, dr, dk, dv, dw, u and du once."""
    return Work(f32_flops=15 * b * h * s * k * k,
                bytes=4 * (9 * b * s * h * k + 2 * h * k))


def matmul(rows: int, params: int, elt: int = 2, read_weights: bool = True) -> Work:
    """``rows`` rows through matrices of ``params`` weights: 2 operations a
    weight a row; the weights read once."""
    return Work(flops=2 * rows * params, bytes=elt * params if read_weights else 0)
