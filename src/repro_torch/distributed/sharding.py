"""Sharding rules: parameter, batch and cache specs per (arch x shape), as
the JAX package's ``distributed/sharding.py``, over the port's trees of
dicts and lists (leaf names as ``keystr`` gives them, ``train/tree.py``).

Strategy, the reference's:

* **Tensor parallel** over ``model``: column-parallel in-projections
  (wq/wk/wv/w_gate/w_up/...), row-parallel out-projections (wo/w_down/...).
* **FSDP** over ``data`` (+ ``pod``): the non-TP weight dim is sharded over
  the batch axes.
* **Expert parallel**: expert-stacked weights sharded on the expert dim over
  ``model`` (the dispatch of ``models.moe.moe_ffn_ep`` reads them there).
* **Vocab parallel**: embedding (V, D) -> (model, data).
* **Decode caches**: batch over batch axes; sequence dim over ``model`` when
  kv_heads < |model|, else kv-heads over ``model``.

Placements on dims that do not divide their axes are dropped (replicated),
as the reference drops them for jit's in/out shardings; DTensor would take
an uneven shard, but the specs stay the reference's.

The port's train step gathers each leaf whole before the forward and keeps
the activations as plain tensors, so the models take no activation
constraints; :func:`activation_spec` is the spec the reference's shard hook
gives each kind of activation, for a step that keeps its activations
sharded.
"""
from __future__ import annotations

import re

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.context import DistContext, P
from repro_torch.models import tuning
from repro_torch.train.tree import map_up_to, map_with_path

# leaf-name rule sets (matched on the last string key in the tree path)
_COL = {
    "wq", "wk", "wv", "wg", "wr", "w_gate", "w_up", "tm_w1", "cm_wk",
    "in_proj", "w_dq", "w_uq", "w_dkv", "w_ukv", "x_wq", "x_wk", "x_wv",
    "proj", "dt_proj",
}
_ROW = {"wo", "w_down", "cm_wv", "cm_wr", "ssm_out_proj", "x_proj", "x_wo", "head"}
_BIAS_MODEL = {"bq", "bk", "bv", "b_up"}
_EXPERT_IN = {"we_gate", "we_up"}
_EXPERT_OUT = {"we_down"}
#: the expert stacks, which the train step keeps sharded over ``model``
EXPERT_LEAVES = _EXPERT_IN | _EXPERT_OUT


def _tail(rank: int, *axes) -> P:
    """PartitionSpec acting on the trailing ``len(axes)`` dims."""
    axes = list(axes)
    if len(axes) > rank:
        axes = axes[len(axes) - rank:]
    return P(*([None] * (rank - len(axes)) + axes))


def _leaf_spec(name: str, rank: int, dist: DistContext) -> P:
    b = dist.batch_axes if len(dist.batch_axes) > 1 else dist.batch_axes[0]
    m = dist.model_axis
    if name == "embed":
        return _tail(rank, m, b)
    if name == "out_head":
        return _tail(rank, b, m)
    if name == "router":
        return _tail(rank, b, None)
    if name in _EXPERT_IN:
        return _tail(rank, m, b, None)
    if name in _EXPERT_OUT:
        return _tail(rank, m, None, b)
    if name in _COL:
        return _tail(rank, b, m)
    if name in _ROW:
        return _tail(rank, m, b)
    if name in _BIAS_MODEL:
        return _tail(rank, m)
    if name in ("conv_w",):
        return _tail(rank, None, m)
    if name in ("a_log",):
        return _tail(rank, m, None)
    if name in ("d_skip", "dt_bias"):
        return _tail(rank, m)
    return P()  # norms, gates, scalars, small LoRAs: replicated


_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]")


def path_leaf_name(path: str) -> str:
    """The last string key of a ``keystr`` path (``"['layers'][0]['wq']"``
    -> ``"wq"``), or "" when it has none."""
    keys = _KEY.findall(path)
    return keys[-1] if keys else ""


def _fit(dist: DistContext, shape, spec: P) -> P:
    """Drop axis placements whose dim size doesn't divide evenly."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return P(*[ax if ax is None or dim % dist.axis_size(ax) == 0 else None
               for dim, ax in zip(shape, axes)])


def param_specs(params_tree, dist: DistContext):
    """PartitionSpec tree matching ``params_tree`` (``meta`` or real
    tensors): placements on dims that don't divide their axes are dropped
    (e.g. 49155/32001-row embeddings, hymba's 25-head projections)."""
    def spec(path, leaf):
        raw = _leaf_spec(path_leaf_name(path), len(leaf.shape), dist)
        return _fit(dist, leaf.shape, raw) if dist.enabled else raw

    return map_with_path(spec, params_tree)


# --------------------------------------------------------------------------- #
# batches
# --------------------------------------------------------------------------- #
def batch_specs(cfg: ModelConfig, dist: DistContext, global_batch: int | None = None):
    b = dist.batch_axes if _batch_fits(dist, global_batch) else None
    out = {"tokens": P(b, None), "labels": P(b, None)}
    if cfg.family == "encdec":
        out["frames"] = P(b, None, None)
    if cfg.family == "vlm":
        out["vision"] = P(b, None, None)
    return out


def _batch_fits(dist: DistContext, global_batch: int | None) -> bool:
    if global_batch is None or not dist.enabled:
        return True
    return global_batch % max(dist.dp_size, 1) == 0


def token_specs(dist: DistContext, global_batch: int | None = None) -> P:
    b = dist.batch_axes if _batch_fits(dist, global_batch) else None
    return P(b, None)


# --------------------------------------------------------------------------- #
# decode caches
# --------------------------------------------------------------------------- #
def cache_specs(cfg: ModelConfig, cache_tree, dist: DistContext,
                data_only: bool | None = None):
    """Spec tree matching ``init_cache``'s structure for each family; every
    placement is checked against the leaf's shape and dropped (replicated)
    if the dim does not divide, e.g. whisper's 1500-frame cross cache or
    rwkv's 40 heads on a 16-wide model axis. ``data_only`` shards the caches
    over the batch axes only; None takes the ``decode_cache_data_only``
    tuning knob, as the reference reads it."""
    if data_only is None:
        data_only = tuning.ACTIVE.decode_cache_data_only
    b = dist.batch_axes
    m = dist.model_axis
    ep = max(dist.ep_size, 1)
    dp = max(dist.dp_size, 1)
    heads_divisible = cfg.n_kv_heads % ep == 0 and dist.ep_size > 1

    def spec(path, leaf):
        name = path_leaf_name(path)
        if name == "len" or len(leaf.shape) == 0:
            return P()
        if data_only:
            # batch-only sharding: keeps the per-step cache write local
            if cfg.family == "hybrid":
                batch_dim = 0
            elif cfg.family == "vlm" and name in ("k", "v"):
                batch_dim = 2
            else:
                batch_dim = 1
            spec_axes = [None] * len(leaf.shape)
            if leaf.shape[batch_dim] % dp == 0:
                spec_axes[batch_dim] = b
            return P(*spec_axes)
        if cfg.family in ("dense", "moe"):
            # (L, B, S, KV, hd)
            raw = (P(None, b, None, m, None) if heads_divisible
                   else P(None, b, m, None, None))
        elif cfg.family == "mla_moe":
            raw = P(None, b, m, None)            # ckv/krope (L, B, S, r)
        elif cfg.family == "rwkv":
            if name == "wkv":                     # (L, B, H, K, V)
                raw = P(None, b, None, m, None)
            else:                                 # shifts (L, B, 1, D)
                raw = P(None, b, None, m)
        elif cfg.family == "hybrid":
            if name in ("k", "v"):                # (B, size, KV, hd)
                raw = P(b, m, None, None)
            elif name == "conv":                  # (B, K-1, I)
                raw = P(b, None, m)
            elif name == "ssm":                   # (B, I, N)
                raw = P(b, m, None)
            else:
                raw = P()
        elif cfg.family == "encdec":
            raw = P(None, b, m, None, None)       # (L,B,S,H,hd) / (L,B,F,H,hd)
        elif cfg.family == "vlm":
            if name in ("k", "v"):                # (G, P, B, S, KV, hd)
                raw = P(None, None, b, m, None, None)
            else:                                 # xk/xv (G, B, Nv, KV, hd)
                raw = P(None, b, m, None, None)
        else:
            raw = P()
        return _fit(dist, leaf.shape, raw)

    return map_with_path(spec, cache_tree)


def named(dist: DistContext, spec_tree):
    """PartitionSpec tree -> :class:`NamedSharding` tree (each leaf's
    DTensor placements on ``dist.mesh``)."""
    return map_up_to(dist.sharding, spec_tree)


# --------------------------------------------------------------------------- #
# activation specs (the reference's shard hook)
# --------------------------------------------------------------------------- #
def activation_spec(cfg: ModelConfig, dist: DistContext, kind: str, shape,
                    seq_parallel: bool | None = None) -> P | None:
    """The spec that the reference's ``make_shard_hook`` constrains an
    activation of ``kind`` and ``shape`` to under a mesh, or None where it
    leaves it as it is (an unknown kind). ``seq_parallel`` shards the
    residual stream's sequence dim over ``model``; None takes the
    ``seq_parallel`` tuning knob, as the reference's hook reads it. No
    activation of the port is a DTensor, so no count of the dry-run moves
    with it."""
    if seq_parallel is None:
        seq_parallel = tuning.ACTIVE.seq_parallel
    b = dist.batch_axes
    m = dist.model_axis
    ep = dist.ep_size
    if kind == "act_bsd":
        if seq_parallel and shape[1] % ep == 0:
            return P(b, m, None)
        return P(b, None, None)
    if kind == "act_bshd":
        return P(b, None, m, None) if cfg.n_heads % ep == 0 else P(b, m, None, None)
    if kind == "kv_bskd":
        return P(b, None, m, None) if cfg.n_kv_heads % ep == 0 else P(b, None, None, None)
    if kind == "kv_cache_bskd":
        return P(b, None, m, None) if cfg.n_kv_heads % ep == 0 else P(b, m, None, None)
    if kind == "logits":
        return P(b, None, m)
    return None
