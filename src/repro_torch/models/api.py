"""Uniform LM interface, dispatching on ``cfg.family``: every family of the
JAX package, dense, moe (granite-moe), mla_moe (deepseek-v3), rwkv, hybrid
(hymba), encdec (whisper) and vlm (llama-3.2-vision).

The multimodal stubs' inputs (``frames=`` for encdec, ``vision=`` for vlm)
go only to the family that takes them, as the reference's ``api.prefill``
passes them. Training: ``loss_fn`` over a batch of ``tokens`` and ``labels``
(plus ``frames`` or ``vision``), ``make_batch``, and the parameter counts,
from an init on the ``meta`` device (``abstract_params``).

The distribution arguments go, as the reference's ``api`` passes them, only
to the families that take them: ``ep_size`` (the experts padded to a
multiple of the expert-parallel width) to ``init_params`` of moe and
mla_moe, and ``dist`` (keyword-only here, beside ``plain``) to their
``loss_fn``, ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import inspect
from types import ModuleType

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import LOCAL, DistContext
from repro_torch.models import dense, hymba, mla, moe, rwkv, vlm, whisper
from repro_torch.models.common import leaves

_FAMILY_MODULES: dict[str, ModuleType] = {"dense": dense, "moe": moe, "mla_moe": mla,
                                          "rwkv": rwkv, "hybrid": hymba,
                                          "encdec": whisper, "vlm": vlm}


def family_module(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY_MODULES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; ported: "
            f"{sorted(_FAMILY_MODULES)}") from None


def _accepts(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def init_params(gen: torch.Generator, cfg: ModelConfig, ep_size: int = 1) -> dict:
    fn = family_module(cfg).init_params
    if _accepts(fn, "ep_size"):
        return fn(gen, cfg, ep_size=ep_size)
    return fn(gen, cfg)


class _MetaGenerator(torch.Generator):
    """A generator whose tensors land on the ``meta`` device: shapes and
    dtypes without storage or draws."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig, ep_size: int = 1) -> dict:
    """The parameter tree as ``meta`` tensors: every leaf's shape and dtype,
    no storage."""
    return init_params(_MetaGenerator(), cfg, ep_size)


def _dist_kw(fn, dist: DistContext) -> dict:
    return {"dist": dist} if _accepts(fn, "dist") else {}


def loss_fn(params, batch: dict, cfg: ModelConfig, plain: bool = False, *,
            dist: DistContext = LOCAL):
    """(loss, metrics) of the family's training loss; ``plain=True`` runs the
    plain versions of the kernels."""
    fn = family_module(cfg).loss_fn
    return fn(params, batch, cfg, plain=plain, **_dist_kw(fn, dist))


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               gen: torch.Generator | None = None) -> dict:
    """A synthetic training batch for the family, drawn from ``gen`` (seed 0
    on the CPU when None) on its device: ``tokens`` and ``labels`` int64
    (B, S), and f32 ``frames`` (encdec) or ``vision`` (vlm)."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    dev = gen.device
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
           for name in ("tokens", "labels")}
    stub = {"encdec": ("frames", cfg.n_frames), "vlm": ("vision", cfg.n_vision_tokens)}
    if cfg.family in stub:
        name, n = stub[cfg.family]
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen, device=dev)
    return out


def count_params(params) -> int:
    return sum(t.numel() for t in leaves(params))


def count_params_abstract(cfg: ModelConfig, ep_size: int = 1) -> int:
    return count_params(abstract_params(cfg, ep_size))


def active_params_abstract(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k + shared experts only)."""
    total = count_params_abstract(cfg)
    if not cfg.is_moe:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_expert
    return total - (cfg.n_layers - cfg.first_k_dense) * (cfg.n_experts - cfg.top_k) * per_expert


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> dict:
    return family_module(cfg).init_cache(cfg, batch, max_len, device)


def cache_rows(cfg: ModelConfig, cache: dict) -> list[tuple[torch.Tensor, int]]:
    """Every per-sequence leaf of ``cache`` with its batch axis, in a fixed
    order (the shared ``len`` is not one)."""
    return family_module(cfg).cache_rows(cfg, cache)


def decode_params(params, cfg: ModelConfig) -> list[torch.Tensor]:
    """The weights one decode step reads whole, each once. An embedding not
    among them is only gathered, a row a token."""
    return family_module(cfg).decode_params(params, cfg)


def prefill(params, tokens, cfg: ModelConfig, plain: bool = False, frames=None,
            vision=None, *, dist: DistContext = LOCAL):
    fn = family_module(cfg).prefill
    stubs = {name: x for name, x in (("frames", frames), ("vision", vision))
             if _accepts(fn, name)}
    return fn(params, tokens, cfg, plain=plain, **stubs, **_dist_kw(fn, dist))


def decode_step(params, cache, tokens, cfg: ModelConfig, plain: bool = False, *,
                dist: DistContext = LOCAL):
    fn = family_module(cfg).decode_step
    return fn(params, cache, tokens, cfg, plain=plain, **_dist_kw(fn, dist))


def pad_cache(cfg: ModelConfig, cache: dict, max_len: int) -> dict:
    """Grow a prefill-sized cache so ``decode_step`` has room for new tokens,
    as the JAX package's ``api.pad_cache``: the dense, moe and encdec self
    caches, the vlm self caches, the mla_moe latents and hymba's
    global-attention layers are zero-padded along the sequence axis to
    ``max_len`` (never cut); the cross caches of encdec and vlm are as long
    as their encoder's output, hymba's window layers are ring buffers and
    RWKV's state is O(1), so these stay as they are. Returns a new dict that
    shares every tensor it did not pad."""
    def pad(t: torch.Tensor, axis: int) -> torch.Tensor:
        cur = t.shape[axis]
        if cur >= max_len:
            return t
        shape = list(t.shape)
        shape[axis] = max_len
        out = t.new_zeros(shape)
        out.narrow(axis, 0, cur).copy_(t)
        return out

    family_module(cfg)
    if cfg.family in ("dense", "moe", "encdec"):
        return dict(cache, k=pad(cache["k"], 2), v=pad(cache["v"], 2))
    if cfg.family == "vlm":
        return dict(cache, k=pad(cache["k"], 3), v=pad(cache["v"], 3))
    if cfg.family == "mla_moe":
        return dict(cache, ckv=pad(cache["ckv"], 2), krope=pad(cache["krope"], 2))
    if cfg.family == "hybrid":
        layers = [dict(lc, k=pad(lc["k"], 1), v=pad(lc["v"], 1))
                  if i in cfg.global_layers else lc
                  for i, lc in enumerate(cache["layers"])]
        return dict(cache, layers=layers)
    return dict(cache)
