"""Dense oracles for the FlowGNN model zoo.

The twin of ``repro/core/pyg_ref.py``. The paper checks its FPGA design
against PyTorch(-Geometric); the reference checks every model of
``core/models.py`` (sparse COO, segment ops, kernels) against these, which
build an explicit dense (N, N) adjacency and evaluate Eq. (2) with plain
products. The port keeps the same second check.

Slow and memory-hungry by design: an oracle only. Assumes no duplicate
edges (the generators make none).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.graph import GraphBatch
from repro_torch.core.models import GNNConfig, _dense, _mlp


def dense_from_coo(graph: GraphBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, E): A (N, N) float32 with A[i, j] = 1 iff an edge j -> i, E (N,
    N, D) the dense edge features. Masked edges add 0; an edge with an
    index outside [0, N) adds nothing, as JAX's scatter drops it."""
    n = graph.n_node_pad
    snd, rcv = graph.senders, graph.receivers
    keep = (graph.edge_mask & (snd >= 0) & (snd < n) & (rcv >= 0)
            & (rcv < n))
    w = keep.to(torch.float32)
    idx = (torch.where(keep, rcv, 0), torch.where(keep, snd, 0))
    dev = graph.device
    a = torch.zeros((n, n), dtype=torch.float32, device=dev)
    a.index_put_(idx, w, accumulate=True)
    e = torch.zeros((n, n, graph.edge_feat.shape[1]), dtype=torch.float32,
                    device=dev)
    e.index_put_(idx, graph.edge_feat * w[:, None], accumulate=True)
    return a, e


def _mask_nodes(graph: GraphBatch, x: torch.Tensor) -> torch.Tensor:
    return torch.where(graph.node_mask[:, None], x, 0.0)


def _graph_onehot(graph: GraphBatch) -> torch.Tensor:
    """(N, G) float32: node i's graph, 0 on padding nodes."""
    oh = F.one_hot(graph.graph_ids, graph.n_graph_pad).to(torch.float32)
    return oh * graph.node_mask[:, None]


def _dense_pool_mean(graph: GraphBatch, x: torch.Tensor) -> torch.Tensor:
    onehot = _graph_onehot(graph)
    s = onehot.T @ x
    cnt = torch.clamp(onehot.sum(0), min=1.0)
    return s / cnt[:, None]


def _readout(head, cfg: GNNConfig, graph: GraphBatch,
             x: torch.Tensor) -> torch.Tensor:
    if cfg.task == "node":
        return _mlp(head, x)
    out = _mlp(head, _dense_pool_mean(graph, x))
    return torch.where(graph.graph_mask[:, None], out, 0.0)


def gcn_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, _ = dense_from_coo(graph)
    n = graph.n_node_pad
    deg = a.sum(1) + 1.0
    inv = torch.rsqrt(deg)
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    s_hat = inv[:, None] * (a + eye) * inv[None, :]
    # the identity adds self loops to padding nodes too; their rows are
    # masked at the end of each layer, as on the sparse path
    mask = graph.node_mask.to(torch.float32)
    s_hat = s_hat * mask[:, None] * mask[None, :]
    x = graph.node_feat.to(cfg.dtype)
    for l, p in enumerate(params["layers"]):
        h = _dense(p, s_hat @ x)
        x = h if l == cfg.num_layers - 1 else torch.relu(h)
        x = _mask_nodes(graph, x)
    return _readout(params["head"], cfg, graph, x)


def _gin_layer_dense(p, a, e_dense, x):
    e = e_dense @ p["edge_enc"]["w"] + p["edge_enc"]["b"]     # (N, N, D)
    msg = torch.relu(x[None, :, :] + e)                        # (dst, src, D)
    agg = torch.einsum("ij,ijd->id", a, msg)
    return _mlp(p["mlp"], (1.0 + p["eps"]) * x + agg)


def gin_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, e_dense = dense_from_coo(graph)
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    for p in params["layers"]:
        x = _mask_nodes(graph, _gin_layer_dense(p, a, e_dense, x))
    return _readout(params["head"], cfg, graph, x)


def gin_vn_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, e_dense = dense_from_coo(graph)
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    onehot = _graph_onehot(graph)
    vn = torch.zeros((graph.n_graph_pad, cfg.hidden_dim), dtype=cfg.dtype,
                     device=x.device)
    nl = len(params["layers"])
    for l, p in enumerate(params["layers"]):
        x = _mask_nodes(graph, x + onehot @ vn)
        x = _mask_nodes(graph, _gin_layer_dense(p, a, e_dense, x))
        if l < nl - 1:
            vn = _mlp(params["vn_mlps"][l], vn + onehot.T @ x)
            vn = torch.where(graph.graph_mask[:, None], vn, 0.0)
    return _readout(params["head"], cfg, graph, x)


def gat_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, _ = dense_from_coo(graph)
    edge = (a > 0)[:, :, None]
    x = graph.node_feat.to(cfg.dtype)
    n, h, dh = graph.n_node_pad, cfg.heads, cfg.head_dim
    for l, p in enumerate(params["layers"]):
        hh = _dense(p["w"], x).reshape(n, h, dh)
        asrc = torch.einsum("nhd,hd->nh", hh, p["a_src"])
        adst = torch.einsum("nhd,hd->nh", hh, p["a_dst"])
        logits = F.leaky_relu(asrc[None, :, :] + adst[:, None, :],
                              negative_slope=0.2)              # (dst, src, H)
        logits = torch.where(edge, logits, -torch.inf)
        # a row with no edge is all -inf: its softmax is NaN, then 0
        att = torch.where(edge, torch.softmax(logits, dim=1), 0.0)
        agg = torch.einsum("ijh,jhd->ihd", att, hh).reshape(n, h * dh)
        x = agg if l == cfg.num_layers - 1 else F.elu(agg)
        x = _mask_nodes(graph, x)
    return _readout(params["head"], cfg, graph, x)


def pna_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, e_dense = dense_from_coo(graph)
    edge = (a > 0)[:, :, None]
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    n = graph.n_node_pad
    deg = a.sum(1)
    log_deg = torch.log(deg + 1.0)
    delta = cfg.avg_log_degree
    scalers = torch.stack(
        [torch.ones_like(log_deg), log_deg / delta,
         delta / torch.clamp(log_deg, min=1e-3)], dim=-1)
    has_edge = (deg > 0)[:, None]

    for p in params["layers"]:
        e = e_dense @ p["edge_enc"]["w"] + p["edge_enc"]["b"]
        src = x[None, :, :].expand(e.shape[:2] + x.shape[-1:])
        msg = torch.relu(torch.einsum(
            "ijk,kd->ijd", torch.cat([src, e], -1), p["pre"]["w"])
            + p["pre"]["b"])                                   # (dst, src, D)
        cnt = torch.clamp(deg, min=1.0)[:, None]
        s1 = torch.einsum("ij,ijd->id", a, msg)
        mean = s1 / cnt
        s2 = torch.einsum("ij,ijd->id", a, msg * msg)
        var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
        std = torch.sqrt(var + 1e-5)
        mx = torch.where(has_edge,
                         torch.where(edge, msg, -torch.inf).amax(1), 0.0)
        mn = torch.where(has_edge,
                         torch.where(edge, msg, torch.inf).amin(1), 0.0)
        m = torch.cat([mean, std, mx, mn], -1)                  # (N, 4D)
        scaled = (m[:, None, :] * scalers[:, :, None]).reshape(n, -1)
        x = torch.relu(_dense(p["post"], torch.cat([x, scaled], -1)))
        x = _mask_nodes(graph, x)
    return _readout(params["head"], cfg, graph, x)


def dgn_dense(params, graph: GraphBatch, cfg: GNNConfig) -> torch.Tensor:
    a, _ = dense_from_coo(graph)
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    pos = graph.node_pos[:, 0]
    dpos = (pos[None, :] - pos[:, None]) * a                    # (dst, src)
    absnorm = dpos.abs().sum(1)
    w = dpos / torch.clamp(absnorm, min=1e-6)[:, None]
    deg = a.sum(1)
    for p in params["layers"]:
        cnt = torch.clamp(deg, min=1.0)[:, None]
        m_mean = (a @ x) / cnt
        m_dx = (w @ x - x * w.sum(1)[:, None]).abs()
        h = _dense(p["post"], torch.cat([x, m_mean, m_dx], -1))
        x = _mask_nodes(graph, torch.relu(h))
    return _readout(params["head"], cfg, graph, x)


DENSE_REFS = {
    "gcn": gcn_dense,
    "gin": gin_dense,
    "gin_vn": gin_vn_dense,
    "gat": gat_dense,
    "pna": pna_dense,
    "dgn": dgn_dense,
}
