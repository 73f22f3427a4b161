"""Synthetic graph streams shaped like the paper's Table IV datasets.

The port's own copy of the numpy generators of ``repro/data/graphs.py``:
the same RNG calls in the same order, so one seed gives identical arrays on
both sides.

  molhiv_like   : ~25.3 nodes, ~55.6 edges, 9d node + 3d edge features
  sized_stream  : molhiv_like with the node-count distribution as parameters
  molpcba_like  : ~27 nodes, ~59.3 edges, the same features
  hep_like      : kNN (k=16) graphs over particle point clouds, ~49 nodes
  mesh_like     : locality-structured oversized graphs (wide placement)
  citation_like : single graphs with the citation benchmarks' sizes
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class RawGraph:
    node_feat: np.ndarray       # (N, F)
    senders: np.ndarray         # (E,)
    receivers: np.ndarray       # (E,)
    edge_feat: Optional[np.ndarray]  # (E, D) or None
    node_pos: np.ndarray        # (N, 1) DGN field (Laplacian-eigvec proxy)
    label: float


def _random_connected_graph(rng: np.random.Generator, n: int, target_edges: int,
                            node_dim: int, edge_dim: Optional[int]
                            ) -> RawGraph:
    """Molecule-like sparse graph: random spanning tree + extra edges,
    symmetrized (undirected -> two directed edges), duplicate-free."""
    parents = np.array([rng.integers(0, i) for i in range(1, n)])
    src = np.concatenate([np.arange(1, n), parents])
    dst = np.concatenate([parents, np.arange(1, n)])
    pairs = set(zip(src.tolist(), dst.tolist()))
    n_extra = max(0, target_edges // 2 - (n - 1))
    tries = 0
    while n_extra > 0 and tries < 50 * n_extra:
        a, b = rng.integers(0, n, size=2)
        tries += 1
        if a == b or (int(a), int(b)) in pairs:
            continue
        pairs.add((int(a), int(b)))
        pairs.add((int(b), int(a)))
        n_extra -= 1
    arr = np.array(sorted(pairs), dtype=np.int32)
    senders, receivers = arr[:, 0], arr[:, 1]
    e = senders.shape[0]
    node_feat = rng.normal(size=(n, node_dim)).astype(np.float32)
    edge_feat = (rng.normal(size=(e, edge_dim)).astype(np.float32)
                 if edge_dim else None)
    # a few power iterations of the normalized adjacency on a random vector
    # (a cheap proxy for the Fiedler vector DGN attaches to its inputs)
    v = rng.normal(size=(n,)).astype(np.float32)
    deg = np.bincount(receivers, minlength=n).astype(np.float32) + 1.0
    for _ in range(3):
        agg = np.zeros(n, np.float32)
        np.add.at(agg, receivers, v[senders])
        v = agg / deg
        v = v - v.mean()
        v = v / (np.linalg.norm(v) + 1e-6)
    label = float(node_feat.mean() > 0)
    return RawGraph(node_feat, senders, receivers, edge_feat, v[:, None], label)


def molhiv_like(seed: int = 0, n_graphs: int = 4113,
                node_dim: int = 9, edge_dim: int = 3) -> Iterator[RawGraph]:
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = max(4, int(rng.normal(25.3, 6.0)))
        e = max(2 * (n - 1), int(rng.normal(55.6, 10.0)) // 2 * 2)
        yield _random_connected_graph(rng, n, e, node_dim, edge_dim)


def sized_stream(seed: int = 0, n_graphs: int = 64, n_mean: float = 25.0,
                 n_std: float = 6.0, e_per_node: float = 2.2,
                 node_dim: int = 9, edge_dim: int = 3) -> Iterator[RawGraph]:
    """Molecule-shaped stream with a controllable size class (``n_std=0``
    gives exact node counts, so a caller can pin the padding bucket)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = max(4, int(rng.normal(n_mean, n_std)))
        e = max(2 * (n - 1), int(n * e_per_node) // 2 * 2)
        yield _random_connected_graph(rng, n, e, node_dim, edge_dim)


def molpcba_like(seed: int = 1, n_graphs: int = 43773,
                 node_dim: int = 9, edge_dim: int = 3) -> Iterator[RawGraph]:
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = max(4, int(rng.normal(27.0, 6.0)))
        e = max(2 * (n - 1), int(rng.normal(59.3, 10.0)) // 2 * 2)
        yield _random_connected_graph(rng, n, e, node_dim, edge_dim)


def hep_like(seed: int = 2, n_graphs: int = 10000, n_points: int = 49,
             k: int = 16, node_dim: int = 9, edge_dim: int = 3
             ) -> Iterator[RawGraph]:
    """EdgeConv-style kNN graphs over particle point clouds (k=16)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = max(k + 1, int(rng.normal(n_points, 8.0)))
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nbr = np.argsort(d2, axis=1)[:, :k]                  # (n, k)
        receivers = np.repeat(np.arange(n, dtype=np.int32), k)
        senders = nbr.reshape(-1).astype(np.int32)
        e = senders.shape[0]
        node_feat = np.concatenate(
            [pts, rng.normal(size=(n, node_dim - 3)).astype(np.float32)], 1)
        edge_feat = rng.normal(size=(e, edge_dim)).astype(np.float32)
        v = pts[:, 0:1] - pts[:, 0:1].mean()
        yield RawGraph(node_feat, senders, receivers, edge_feat, v,
                       float(pts.mean() > 0))


def mesh_like(seed: int = 4, n_graphs: int = 8, n_nodes: int = 1000,
              window: int = 8, e_per_node: float = 4.0,
              node_dim: int = 9, edge_dim: int = 3) -> Iterator[RawGraph]:
    """Locality-structured oversized graphs (meshes, road nets, chains).

    Every edge connects nodes within ``window`` positions of each other,
    so a contiguous K-way dest-partition (``distributed/wide.py``) cuts
    only ``O(window)`` edges per boundary: the workload class wide
    placement exists for. A uniformly random graph has no such structure
    (every shard's halo is nearly the whole remote node set), and the wide
    planner rejects it as not fitting a per-executor budget. A ring
    backbone keeps each graph connected.
    """
    rng = np.random.default_rng(seed)
    for _ in range(n_graphs):
        n = int(n_nodes)
        ring = np.arange(n, dtype=np.int64)
        src = [ring, (ring + 1) % n]
        dst = [(ring + 1) % n, ring]
        n_extra = max(0, int(n * e_per_node) - 2 * n)
        if n_extra:
            a = rng.integers(0, n, size=n_extra)
            off = rng.integers(1, window + 1, size=n_extra)
            sign = rng.choice((-1, 1), size=n_extra)
            b = np.clip(a + sign * off, 0, n - 1)
            keep = a != b
            src.append(a[keep])
            dst.append(b[keep])
        senders = np.concatenate(src).astype(np.int32)
        receivers = np.concatenate(dst).astype(np.int32)
        e = senders.shape[0]
        node_feat = rng.normal(size=(n, node_dim)).astype(np.float32)
        edge_feat = (rng.normal(size=(e, edge_dim)).astype(np.float32)
                     if edge_dim else None)
        v = np.cos(np.linspace(0, 2 * np.pi, n)).astype(np.float32)[:, None]
        yield RawGraph(node_feat, senders, receivers, edge_feat, v,
                       float(node_feat.mean() > 0))


def citation_like(name: str, seed: int = 3) -> RawGraph:
    """Single-graph benchmarks with the paper's node and edge counts.

    The seed mixes in ``hash(name) % 1000``, as the reference's does.
    Python salts string hashes per process, so a name's graph is the same
    on both sides only within one interpreter (set ``PYTHONHASHSEED`` to
    fix it across runs).
    """
    sizes = {
        "cora": (2708, 5429, 1433),
        "citeseer": (3327, 4732, 3703),
        "pubmed": (19717, 44338, 500),
        # the real Reddit graph (232,965 nodes, 114.6M edges) scaled down
        # 100x linearly, which keeps the degree profile
        "reddit_mini": (2330, 1146159 // 100, 602),
    }
    n, e_undirected, f = sizes[name]
    rng = np.random.default_rng(seed + hash(name) % 1000)
    # preferential-attachment-like degree skew (citation graphs are
    # heavy-tailed)
    weights = rng.pareto(2.0, size=n) + 1.0
    weights /= weights.sum()
    src = rng.choice(n, size=2 * e_undirected, p=weights).astype(np.int32)
    dst = rng.integers(0, n, size=2 * e_undirected).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    senders = np.concatenate([src, dst])
    receivers = np.concatenate([dst, src])
    node_feat = (rng.random(size=(n, min(f, 512))) < 0.01).astype(np.float32)
    v = rng.normal(size=(n, 1)).astype(np.float32)
    return RawGraph(node_feat, senders, receivers, None, v, 0.0)
