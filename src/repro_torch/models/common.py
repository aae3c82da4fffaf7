"""Building blocks of the dense family: init helpers, RoPE, GLU MLP and the
LM head.

Parameters are plain dicts of tensors. RMSNorm, attention and decode
attention are the Hopper kernels, called from ``repro_torch.kernels.ops``;
the projections, MLP and LM head are ``torch.matmul``. This is the JAX
package's default path (no grouped attention, no probability downcast): its
TPU tuning knobs are not ported.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# init helpers (same scales as the JAX package; torch draws other numbers)
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). Half-rotation convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if positions.ndim == 1:
        angles = positions.float()[:, None] * freqs[None, :]     # (S, hd/2)
        angles = angles[None, :, None, :]                         # (1, S, 1, hd/2)
    else:
        angles = positions.float()[..., None] * freqs             # (B, S, hd/2)
        angles = angles[:, :, None, :]                            # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# MLP and head
# --------------------------------------------------------------------------- #
def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def glu_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    """SwiGLU / GeGLU: down(act(gate(x)) * up(x))."""
    g = act_fn(act)(x @ w_gate)
    return (g * (x @ w_up)) @ w_down


def lm_logits(x, embed, out_head=None):
    """Project hidden states to vocabulary (tied embeddings by default)."""
    w = embed.T if out_head is None else out_head
    return x @ w
