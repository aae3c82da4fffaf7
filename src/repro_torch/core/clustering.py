"""Density-based clustering (HDBSCAN-lite) for pre-idle window grouping (§4.5).

The paper uses HDBSCAN over pre-idle telemetry windows. hdbscan/sklearn are
not installable offline, so this is a NumPy implementation of the core of the
algorithm:

1. core distances (k-th nearest neighbour),
2. mutual-reachability distances  mreach(a,b) = max(core_a, core_b, d(a,b)),
3. minimum spanning tree over the mutual-reachability graph (Prim, O(n^2)),
4. single-linkage hierarchy from sorted MST edges,
5. flat extraction: cut edges above an adaptive scale, discard components
   smaller than ``min_cluster_size`` as noise (label -1).

O(n^2) memory/time is fine at our scale (10^3–10^4 windows).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterResult:
    labels: np.ndarray          # [n] int, -1 = noise
    n_clusters: int
    cut_scale: float
    core_distances: np.ndarray  # [n]


def _pairwise_dist(x: np.ndarray) -> np.ndarray:
    sq = np.sum(x * x, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    np.maximum(d2, 0.0, out=d2)
    return np.sqrt(d2)


def _mst_prim(w: np.ndarray) -> list[tuple[float, int, int]]:
    """Prim's MST over a dense weight matrix; returns (weight, u, v) edges."""
    n = w.shape[0]
    in_tree = np.zeros(n, dtype=bool)
    best = np.full(n, np.inf)
    parent = np.full(n, -1, dtype=np.int64)
    best[0] = 0.0
    edges: list[tuple[float, int, int]] = []
    for _ in range(n):
        u = int(np.argmin(np.where(in_tree, np.inf, best)))
        in_tree[u] = True
        if parent[u] >= 0:
            edges.append((float(w[u, parent[u]]), int(parent[u]), u))
        better = (~in_tree) & (w[u] < best)
        best[better] = w[u][better]
        parent[better] = u
    return edges


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, a: int) -> int:
        root = a
        while self.parent[root] != root:
            root = int(self.parent[root])
        while self.parent[a] != root:
            self.parent[a], a = root, int(self.parent[a])
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]


def density_cluster(
    features: np.ndarray,
    min_cluster_size: int = 10,
    min_samples: int = 5,
    cut_quantile: float = 0.85,
    standardize: bool = True,
) -> ClusterResult:
    """Cluster rows of ``features``; small/low-density points become noise."""
    x = np.asarray(features, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("features must be [n, d]")
    n = x.shape[0]
    if n == 0:
        return ClusterResult(np.empty(0, dtype=np.int64), 0, 0.0, np.empty(0))
    if standardize:
        mu = x.mean(axis=0)
        sd = x.std(axis=0)
        sd[sd == 0] = 1.0
        x = (x - mu) / sd
    if n == 1:
        return ClusterResult(np.zeros(1, dtype=np.int64), 1, 0.0, np.zeros(1))

    d = _pairwise_dist(x)
    k = min(min_samples, n - 1)
    core = np.partition(d, k, axis=1)[:, k]
    mreach = np.maximum(np.maximum(core[:, None], core[None, :]), d)
    np.fill_diagonal(mreach, 0.0)

    edges = sorted(_mst_prim(mreach))
    weights = np.array([e[0] for e in edges])
    cut = float(np.quantile(weights, cut_quantile)) if weights.size else 0.0

    uf = _UnionFind(n)
    for wgt, u, v in edges:
        if wgt <= cut:
            uf.union(u, v)

    roots = np.array([uf.find(i) for i in range(n)])
    labels = np.full(n, -1, dtype=np.int64)
    next_label = 0
    for root in np.unique(roots):
        members = np.flatnonzero(roots == root)
        if members.size >= min_cluster_size:
            labels[members] = next_label
            next_label += 1
    return ClusterResult(labels=labels, n_clusters=next_label, cut_scale=cut,
                         core_distances=core)
