"""The comparisons that decide ``correct``, and the lower precision that
the control computes in.

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position. Training: the gap between the program's
and the reference's norm of each leaf (the first clipped gradient, the change
of the weights over the first steps), measured against the reference's norm
of that leaf or of the median leaf, whichever is larger, taken over the
worst leaf (the change) or as the median over leaves (the gradient); and the
loss of each of the first steps, relative.
"""
from __future__ import annotations

import statistics

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a slice along ``dim`` (a
    row of activations, a column of weights), back in its dtype."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return ((x / scale).to(F8).to(x.dtype)) * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's matrix product: both operands rounded to float8 e4m3,
    activations by row and weights by output column, accumulated in float32."""
    return to_fp8(x, -1) @ to_fp8(w, -2)


def served_gaps(ref_logits: list[torch.Tensor], served: list[list[int]]) -> list[float]:
    """For each request, the widest gap of its served tokens below the
    reference's best logit at their positions."""
    out = []
    for logits, toks in zip(ref_logits, served):
        idx = torch.tensor(toks)[:, None]
        out.append(float((logits.max(-1).values - logits.gather(-1, idx)[:, 0]).max()))
    return out


def control_gaps(ref_logits: list[torch.Tensor], low_logits: list[torch.Tensor]) -> list[float]:
    """For each request, the widest gap, below the reference's best, of the
    token the lower precision puts first at each position."""
    return served_gaps(ref_logits, [l.argmax(-1).tolist() for l in low_logits])


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, object]:
    """The worst leaf's |norm(prog) - norm(ref)| / max(norm(ref),
    median leaf's norm(ref)), over the paths in ``keep`` (all when None);
    (the gap, its path)."""
    paths = [p for p in ref if keep is None or p in keep]
    med = statistics.median(ref[p] for p in paths)
    worst = max(paths, key=lambda p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med, 1e-30), worst


def median_leaf_gap(prog: dict, ref: dict) -> float:
    """The median over leaves of |norm(prog) - norm(ref)| / max(norm(ref),
    median leaf's norm(ref)): steady where the worst leaf is a scalar whose
    gradient is a sum that nearly cancels."""
    med = statistics.median(ref.values())
    return statistics.median(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in ref)


def moved_leaves(ref_grad: dict, share: float = 1e-3) -> set:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return {p for p, g in ref_grad.items() if g >= share * med}


def relative(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
