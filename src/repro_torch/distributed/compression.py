"""Gradient compression with error feedback for the cross-pod reduction, as
the JAX package's ``distributed/compression.py``, on ``torch.distributed``.

int8 block-quantized reduction: each pod quantizes its local gradients
(per-block scale, symmetric int8), every pod's int8 payload and f32 scales
are gathered over the pod group, and each rank dequantizes and sums them in
f32. Quantization error is carried in an error-feedback buffer so the
compression is unbiased over time (Karimireddy et al., EF-SGD). The payload
is a quarter of an f32 reduction's, plus one f32 scale per block of 256.

As in the reference, the trainer never calls it
(``TrainerConfig.grad_compression`` is kept and not read).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.train.tree import leaves, unflatten

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """Symmetric per-block int8. Returns (q int8 [blocks, BLOCK], scales f32
    [blocks], shape)."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], shape


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, t, group=group)
    return torch.stack(parts)


def compressed_psum(tree, group, error_buf=None):
    """The sum of ``tree`` over the ranks of ``group`` with an int8 wire
    format and error feedback: each rank gathers every rank's int8 payload
    and f32 per-block scales, then dequantizes and sums them locally.
    Returns (summed tree, new error buffer), both shaped as ``tree``."""
    flat = leaves(tree)
    errs = (leaves(error_buf) if error_buf is not None
            else [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in flat])
    out, new_err = [], []
    for g, e in zip(flat, errs):
        g32 = g.float() + e
        q, scale, shape = quantize_int8(g32)
        local_dq = dequantize_int8(q, scale, shape)
        new_err.append(g32 - local_dq)                     # error feedback
        q_all = _all_gather(q, group)                      # (P, blocks, BLOCK) int8
        s_all = _all_gather(scale, group)                  # (P, blocks) f32
        summed = (q_all.float() * s_all[..., None]).sum(dim=0)
        out.append(summed.reshape(-1)[:local_dq.numel()].reshape(shape).to(g.dtype))
    return unflatten(tree, out), unflatten(tree, new_err)


def make_compressed_allreduce(mesh, pod_axis: str = "pod"):
    """Returns f(grads, err) -> (reduced grads, err): the EF-int8 mean over
    the ranks of ``mesh``'s ``pod_axis`` group."""
    group = mesh.get_group(pod_axis)
    n_pods = mesh.shape[mesh.mesh_dim_names.index(pod_axis)]

    def reduce_fn(grads, err):
        summed, new_err = compressed_psum(grads, group, err)
        return unflatten(summed, [g / n_pods for g in leaves(summed)]), new_err

    return reduce_fn
