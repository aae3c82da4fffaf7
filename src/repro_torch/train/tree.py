"""Parameter and optimizer-state trees: nested dicts and lists of tensors.

Flattening follows ``jax.tree_util``: dict keys in sorted order, list items
in order, and each leaf's path is its ``jax.tree_util.keystr`` string
(``['params']['layers'][0]['wq']``), so a checkpoint's keys are the JAX
package's.
"""
from __future__ import annotations

from typing import Callable


def flatten(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of every leaf of ``tree``, in the JAX package's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, values: list):
    """A tree shaped as ``like`` whose leaves are ``values``, in
    :func:`flatten`'s order."""
    it = iter(values)
    return map_up_to(lambda _: next(it), _sorted(like))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted(v) for v in tree]
    return tree


def map_up_to(fn: Callable, tree, *others):
    """``fn(leaf, *nodes)`` over the leaves of ``tree``, where ``nodes`` are
    the subtrees of ``others`` at the leaf's path (a leaf, or a whole
    subtree such as Adafactor's per-parameter statistics)."""
    if isinstance(tree, dict):
        return {k: map_up_to(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_up_to(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree)]
    return fn(tree, *others)


def map_with_path(fn: Callable, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, each path its
    ``keystr`` string as :func:`flatten` gives it; the same structure back."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return fn(path, tree)
