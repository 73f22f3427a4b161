"""Graph containers: raw COO edge lists, padded, in arrival order.

The twin of ``repro/core/graph.py``. Graphs arrive as raw COO edge lists and
are never sorted or partitioned. Padding convention:

  * padded nodes/edges are masked out via ``node_mask`` / ``edge_mask``;
  * padded edges point at node 0 and are neutralised by the mask in every
    aggregation;
  * several small graphs may be packed into one batch; ``graph_ids`` maps
    each node to its graph for the readout.

Indices are int64 (``index_add_`` and friends want int64), converted once
when the batch is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


@dataclass(frozen=True)
class GraphBatch:
    """A batch of graphs in padded COO form (raw stream order)."""

    node_feat: torch.Tensor     # (N_pad, F_in) float32
    edge_feat: torch.Tensor     # (E_pad, D_in) float32 (zeros if none)
    senders: torch.Tensor       # (E_pad,) int64
    receivers: torch.Tensor     # (E_pad,) int64
    node_mask: torch.Tensor     # (N_pad,) bool
    edge_mask: torch.Tensor     # (E_pad,) bool
    graph_ids: torch.Tensor     # (N_pad,) int64 — graph id per node
    graph_mask: torch.Tensor    # (G_pad,) bool — which graph slots are real
    node_pos: torch.Tensor      # (N_pad, P) float32 — positional field

    @property
    def n_node_pad(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edge_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def n_graph_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_feat.device


def build_graph_batch(
    node_feat: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    *,
    edge_feat: Optional[np.ndarray] = None,
    node_pad: int,
    edge_pad: int,
    graph_offsets: Optional[np.ndarray] = None,
    graph_pad: int = 1,
    node_pos: Optional[np.ndarray] = None,
    pos_dim: int = 1,
    device: DeviceLike = None,
) -> GraphBatch:
    """Pad raw COO arrays (host-side numpy) into a GraphBatch on ``device``.

    ``graph_offsets``: node-index boundaries between packed graphs,
    e.g. [0, n0, n0+n1, ...]; defaults to a single graph.
    """
    dev = resolve_device(device)
    n, f = node_feat.shape
    e = senders.shape[0]
    if n > node_pad or e > edge_pad:
        raise ValueError(f"graph ({n} nodes, {e} edges) exceeds padding "
                         f"({node_pad}, {edge_pad})")
    if edge_feat is None:
        edge_feat = np.zeros((e, 1), dtype=np.float32)
    d = edge_feat.shape[1]
    if node_pos is None:
        node_pos = np.zeros((n, pos_dim), dtype=np.float32)

    nf = np.zeros((node_pad, f), dtype=np.float32)
    nf[:n] = node_feat
    ef = np.zeros((edge_pad, d), dtype=np.float32)
    ef[:e] = edge_feat
    snd = np.zeros((edge_pad,), dtype=np.int64)
    snd[:e] = senders
    rcv = np.zeros((edge_pad,), dtype=np.int64)
    rcv[:e] = receivers
    npos = np.zeros((node_pad, node_pos.shape[1]), dtype=np.float32)
    npos[:n] = node_pos

    nmask = np.arange(node_pad) < n
    emask = np.arange(edge_pad) < e

    gids = np.zeros((node_pad,), dtype=np.int64)
    if graph_offsets is None:
        graph_offsets = np.array([0, n])
    n_graphs = len(graph_offsets) - 1
    if n_graphs > graph_pad:
        raise ValueError(f"{n_graphs} graphs exceed graph_pad={graph_pad}")
    for g in range(n_graphs):
        gids[graph_offsets[g]:graph_offsets[g + 1]] = g
    # padded nodes pool into the last (masked) graph slot if it exists, else
    # 0; node_mask keeps them out of the readout either way
    gids[n:] = min(n_graphs, graph_pad - 1)
    gmask = np.arange(graph_pad) < n_graphs

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    return GraphBatch(
        node_feat=put(nf), edge_feat=put(ef), senders=put(snd),
        receivers=put(rcv), node_mask=put(nmask), edge_mask=put(emask),
        graph_ids=put(gids), graph_mask=put(gmask), node_pos=put(npos))


def concat_raw_graphs(graphs) -> dict:
    """Concatenate raw COO graphs (host-side numpy) for packed batching.

    Edge indices are shifted by each graph's node offset. Returns the keyword
    arguments for :func:`build_graph_batch` (minus the padding sizes)::

        {node_feat, senders, receivers, edge_feat, node_pos, graph_offsets}

    ``edge_feat`` / ``node_pos`` are None when absent from every input; when
    only some graphs carry them, the gaps are zero-filled at the width the
    other graphs use.
    """
    if not graphs:
        raise ValueError("cannot concatenate an empty graph list")

    def gather(attr: str, rows_of) -> Optional[np.ndarray]:
        vals = [getattr(g, attr, None) for g in graphs]
        if not any(v is not None for v in vals):
            return None
        width = next(v.shape[1] for v in vals if v is not None)
        return np.concatenate([
            v if v is not None else np.zeros((rows_of(g), width), np.float32)
            for g, v in zip(graphs, vals)
        ])

    offs = np.zeros(len(graphs) + 1, dtype=np.int64)
    for i, g in enumerate(graphs):
        offs[i + 1] = offs[i] + g.node_feat.shape[0]
    return {
        "node_feat": np.concatenate([g.node_feat for g in graphs]),
        "senders": np.concatenate(
            [g.senders + offs[i] for i, g in enumerate(graphs)]),
        "receivers": np.concatenate(
            [g.receivers + offs[i] for i, g in enumerate(graphs)]),
        "edge_feat": gather("edge_feat", lambda g: g.senders.shape[0]),
        "node_pos": gather("node_pos", lambda g: g.node_feat.shape[0]),
        "graph_offsets": offs,
    }


def pad_bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 4096, 16384)) -> int:
    """Smallest padding bucket holding ``n``; past the table, the next power
    of two."""
    for b in buckets:
        if n <= b:
            return b
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def permute_edges(g: GraphBatch, perm) -> GraphBatch:
    """Reorder the edge list (results must be invariant to it)."""
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                           device=g.device)
    return dataclasses.replace(
        g,
        edge_feat=g.edge_feat[perm],
        senders=g.senders[perm],
        receivers=g.receivers[perm],
        edge_mask=g.edge_mask[perm],
    )
