"""The FlowGNN model zoo in PyTorch: GCN, GIN (paper Eq. 1), GIN with a
virtual node, GAT, PNA and DGN (paper Table II).

The twin of ``repro/core/models.py``. Parameters are plain nested dicts and
lists of tensors with the JAX layout: a dense layer is ``{"w": (d_in,
d_out), "b": (d_out,)}`` applied as ``x @ w + b``, so weights move between
the two sides without a transpose (``checkpoint/convert.py``). Every
forward is a plain Python loop over the layers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.graph import GraphBatch
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              PNA_STAT_KINDS,
                                              DataflowConfig,
                                              FusableAttention,
                                              FusableMessage, FusableUpdate,
                                              PrecomputedGraphStats,
                                              _count_pass,
                                              fused_edge_aggregate,
                                              global_pool,
                                              precompute_graph_stats,
                                              propagate, segment_aggregate,
                                              segment_softmax)

Params = Dict[str, Any]

# impls whose edge phase consumes the FusableMessage description
_FUSABLE_IMPLS = ("pipeline", "fused_layer")


@dataclass(frozen=True)
class GNNConfig:
    model: str = "gin"
    num_layers: int = 5
    hidden_dim: int = 100
    node_feat_dim: int = 9          # OGB-mol style raw features
    edge_feat_dim: int = 3
    out_dim: int = 1
    heads: int = 4                  # GAT
    head_dim: int = 16              # GAT
    pos_dim: int = 1                # DGN directional field width
    avg_log_degree: float = 1.3     # PNA's delta
    task: str = "graph"             # graph | node
    head_mlp: Tuple[int, ...] = ()  # extra hidden head layers (PNA/DGN)
    eps_init: float = 0.0           # GIN epsilon
    dtype: Any = torch.float32

    def replace(self, **kw) -> "GNNConfig":
        import dataclasses
        return dataclasses.replace(self, **kw)


# Paper Sec. VI-A model configurations.
PAPER_GNN_CONFIGS: Dict[str, GNNConfig] = {
    "gcn": GNNConfig(model="gcn", num_layers=5, hidden_dim=100),
    "gin": GNNConfig(model="gin", num_layers=5, hidden_dim=100),
    "gin_vn": GNNConfig(model="gin_vn", num_layers=5, hidden_dim=100),
    "gat": GNNConfig(model="gat", num_layers=5, hidden_dim=64, heads=4,
                     head_dim=16),
    "pna": GNNConfig(model="pna", num_layers=4, hidden_dim=80,
                     head_mlp=(40, 20)),
    "dgn": GNNConfig(model="dgn", num_layers=4, hidden_dim=100,
                     head_mlp=(50, 25)),
}


# ---------------------------------------------------------------------------
# param helpers
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
                device: torch.device) -> Params:
    scale = math.sqrt(2.0 / (d_in + d_out))
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype) * scale
    return {"w": w.to(device), "b": torch.zeros((d_out,), dtype=dtype,
                                                  device=device)}


def _dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def _mlp_init(gen, dims, dtype, device) -> list:
    return [_dense_init(gen, dims[i], dims[i + 1], dtype, device)
            for i in range(len(dims) - 1)]


def _mlp(ps: list, x: torch.Tensor, act=torch.relu) -> torch.Tensor:
    for i, p in enumerate(ps):
        x = _dense(p, x)
        if i < len(ps) - 1:
            x = act(x)
    return x


def _head_init(gen, cfg: GNNConfig, d_in: int, device) -> list:
    dims = (d_in,) + tuple(cfg.head_mlp) + (cfg.out_dim,)
    return _mlp_init(gen, dims, cfg.dtype, device)


def _readout(head, cfg: GNNConfig, graph: GraphBatch, x: torch.Tensor,
             stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    if cfg.task == "node":
        return _mlp(head, x)
    pooled = global_pool(graph, x, kind="mean", stats=stats)
    out = _mlp(head, pooled)
    return torch.where(graph.graph_mask[:, None], out, 0.0)


# ---------------------------------------------------------------------------
# GCN (symmetric norm, analytic self loop)
# ---------------------------------------------------------------------------

def gcn_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random GCN weights from ``gen`` with the reference's shapes and
    scales: one dense layer per GNN layer (node features to hidden first)."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    layers = [_dense_init(gen, cfg.node_feat_dim if l == 0 else d, d,
                          cfg.dtype, dev) for l in range(cfg.num_layers)]
    return {"layers": layers, "head": _head_init(gen, cfg, d, dev)}


def gcn_layer(p, graph: GraphBatch, x: torch.Tensor,
              dataflow: DataflowConfig, stats: PrecomputedGraphStats, *,
              last: bool, fusable: Optional[FusableMessage]) -> torch.Tensor:
    """One GCN layer. ``stats`` must carry ``inv_sqrt_deg``; ``fusable``
    holds the per-edge norm stream that every layer shares (None under
    ``impl='fused'``)."""
    inv_sqrt = stats.inv_sqrt_deg
    self_coeff = inv_sqrt * inv_sqrt        # analytic self-loop weight

    def message(src, dst, e, _inv=inv_sqrt, _g=graph):
        norm = _inv[_g.senders] * _inv[_g.receivers]
        return src * norm[:, None]

    def update(xv, m, _p=p):
        m = m + xv * self_coeff[:, None]      # analytic self loop
        return _dense(_p, m)

    fu = (FusableUpdate(w1=p["w"], b1=p["b"], self_coeff=self_coeff)
          if dataflow.impl == "fused_layer" else None)
    h = propagate(graph, x, message_fn=message, update_fn=update,
                  aggregate="sum", dataflow=dataflow, stats=stats,
                  fusable=fusable, fusable_update=fu)
    # relu on every layer but the last; relu(0) == 0 keeps the node mask
    return h if last else torch.relu(h)


def gcn_apply(params, graph: GraphBatch, cfg: GNNConfig,
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    """GCN forward; ``dataflow.scan_layers`` either way runs a Python loop."""
    x = graph.node_feat.to(cfg.dtype)
    if stats is None or stats.inv_sqrt_deg is None:
        stats = precompute_graph_stats(graph, with_self_loop_norm=True,
                                       with_graph_counts=cfg.task == "graph")
    inv_sqrt = stats.inv_sqrt_deg           # 1/sqrt(deg+1), once per graph
    # fusable phi: the symmetric norm is a per-edge scalar stream, shared
    # by every layer
    fusable = None
    if dataflow.impl in _FUSABLE_IMPLS:
        fusable = FusableMessage(
            src_weight=inv_sqrt[graph.senders] * inv_sqrt[graph.receivers])
    n_layers = cfg.num_layers
    for l, p in enumerate(params["layers"]):
        x = gcn_layer(p, graph, x, dataflow, stats, last=l == n_layers - 1,
                      fusable=fusable)
    return _readout(params["head"], cfg, graph, x, stats)


# ---------------------------------------------------------------------------
# GIN (+ edge embeddings, Eq. 1)
# ---------------------------------------------------------------------------

def gin_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random GIN weights from ``gen`` with the reference's shapes and
    scales (the two sides' random numbers differ; parity tests move the
    JAX weights across instead)."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    node_enc = _dense_init(gen, cfg.node_feat_dim, d, cfg.dtype, dev)
    return {"node_enc": node_enc, "layers": _gin_layers_init(gen, cfg, dev),
            "head": _head_init(gen, cfg, d, dev)}


def _gin_layers_init(gen, cfg: GNNConfig, dev) -> list:
    d = cfg.hidden_dim
    return [{
        "edge_enc": _dense_init(gen, cfg.edge_feat_dim, d, cfg.dtype, dev),
        "mlp": _mlp_init(gen, (d, 2 * d, d), cfg.dtype, dev),
        "eps": torch.tensor(cfg.eps_init, dtype=cfg.dtype, device=dev),
    } for _ in range(cfg.num_layers)]


def _gin_layer(p, graph: GraphBatch, x: torch.Tensor,
               dataflow: DataflowConfig,
               stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    e = _dense(p["edge_enc"], graph.edge_feat)   # per-layer bond encoder

    def message(src, dst, ee, _e=e):
        return torch.relu(src + _e)              # phi = ReLU(x_j + e_ji)

    def update(xx, m, _p=p):
        return _mlp(_p["mlp"], (1.0 + _p["eps"]) * xx + m)

    # fusable phi: the bond embedding is an additive edge-side input stream
    fusable = (FusableMessage(edge_term=e, activation="relu")
               if dataflow.impl in _FUSABLE_IMPLS else None)
    # fusable gamma: (1+eps) self term + the 2-layer MLP, in-kernel. 1+eps
    # stays a device tensor: reading it on the host would sync every layer.
    fu = None
    if dataflow.impl == "fused_layer":
        m0, m1 = p["mlp"]
        fu = FusableUpdate(w1=m0["w"], b1=m0["b"], w2=m1["w"], b2=m1["b"],
                           self_coeff=1.0 + p["eps"])
    return propagate(graph, x, message_fn=message, update_fn=update,
                     aggregate="sum", dataflow=dataflow, stats=stats,
                     fusable=fusable, fusable_update=fu)


def gin_apply(params, graph: GraphBatch, cfg: GNNConfig,
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    """GIN forward; ``dataflow.scan_layers`` either way runs a Python loop."""
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    if stats is None and cfg.task == "graph":
        stats = precompute_graph_stats(graph, with_degrees=False,
                                       with_graph_counts=True)
    for p in params["layers"]:
        x = _gin_layer(p, graph, x, dataflow, stats)
    return _readout(params["head"], cfg, graph, x, stats)


def gin_vn_init(gen: torch.Generator, cfg: GNNConfig,
                device: DeviceLike = None) -> Params:
    """Random GIN-VN weights from ``gen`` with the reference's shapes: GIN's,
    plus one (d, 2d, d) virtual-node MLP between each pair of layers."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    return {
        "node_enc": _dense_init(gen, cfg.node_feat_dim, d, cfg.dtype, dev),
        "layers": _gin_layers_init(gen, cfg, dev),
        "head": _head_init(gen, cfg, d, dev),
        "vn_mlps": [_mlp_init(gen, (d, 2 * d, d), cfg.dtype, dev)
                    for _ in range(cfg.num_layers - 1)],
    }


def gin_vn_broadcast(graph: GraphBatch, x: torch.Tensor,
                     vn: torch.Tensor) -> torch.Tensor:
    """The virtual node to all nodes of its graph."""
    x = x + vn[graph.graph_ids]
    return torch.where(graph.node_mask[:, None], x, 0.0)


def gin_vn_update(p_vn, graph: GraphBatch, x: torch.Tensor,
                  vn: torch.Tensor) -> torch.Tensor:
    """All nodes to the virtual node: the per-graph sum pool, then the MLP."""
    pooled = global_pool(graph, x, kind="sum")
    vn = _mlp(p_vn, vn + pooled)
    return torch.where(graph.graph_mask[:, None], vn, 0.0)


def gin_vn_apply(params, graph: GraphBatch, cfg: GNNConfig,
                 dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                 stats: Optional[PrecomputedGraphStats] = None
                 ) -> torch.Tensor:
    """GIN with a virtual node per packed graph. Its O(N) edges are never
    built: the pool is its incoming aggregation and the broadcast its
    outgoing messages. The last layer has no virtual-node update."""
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    if stats is None and cfg.task == "graph":
        stats = precompute_graph_stats(graph, with_degrees=False,
                                       with_graph_counts=True)
    vn = torch.zeros((graph.n_graph_pad, cfg.hidden_dim), dtype=cfg.dtype,
                     device=x.device)
    n_layers = len(params["layers"])
    for l, p in enumerate(params["layers"]):
        x = _gin_layer(p, graph, gin_vn_broadcast(graph, x, vn), dataflow,
                       stats)
        if l < n_layers - 1:
            vn = gin_vn_update(params["vn_mlps"][l], graph, x, vn)
    return _readout(params["head"], cfg, graph, x, stats)


# ---------------------------------------------------------------------------
# GAT (anisotropic; gather, then transform)
# ---------------------------------------------------------------------------

def gat_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random GAT weights from ``gen`` with the reference's shapes and
    scales: per layer a dense node transform to heads x head_dim and the
    two attention halves (heads, head_dim)."""
    dev = resolve_device(device)
    d_hid = cfg.heads * cfg.head_dim
    layers = []
    for l in range(cfg.num_layers):
        d_in = cfg.node_feat_dim if l == 0 else d_hid
        w = _dense_init(gen, d_in, d_hid, cfg.dtype, dev)
        halves = [torch.randn((cfg.heads, cfg.head_dim), generator=gen,
                              dtype=cfg.dtype) * 0.1 for _ in range(2)]
        layers.append({"w": w, "a_src": halves[0].to(dev),
                       "a_dst": halves[1].to(dev)})
    return {"layers": layers, "head": _head_init(gen, cfg, d_hid, dev)}


def gat_layer(p, graph: GraphBatch, x: torch.Tensor,
              dataflow: DataflowConfig,
              stats: Optional[PrecomputedGraphStats], *,
              last: bool) -> torch.Tensor:
    """One GAT layer; heads and head_dim come from the attention halves.

    The per-node attention halves are a multiply-reduce over the head dim,
    not an einsum, as in the reference: the reduction's order then does not
    depend on the number of rows.
    """
    heads, hd = p["a_src"].shape
    n = graph.n_node_pad
    h = _dense(p["w"], x).reshape(n, heads, hd)
    # per-node attention halves (once per node)
    alpha_src = (h * p["a_src"][None]).sum(-1)
    alpha_dst = (h * p["a_dst"][None]).sum(-1)
    if dataflow.impl in _FUSABLE_IMPLS:
        # one launch: logits, the online softmax and the weighted sum all
        # fold into the mp_pipeline edge sweep
        agg = fused_edge_aggregate(
            graph, h.reshape(n, heads * hd),
            FusableMessage(attention=FusableAttention(
                src_logits=alpha_src, dst_logits=alpha_dst)),
            kinds=("sum",), dataflow=dataflow, stats=stats)["sum"]
    else:
        logits = torch.nn.functional.leaky_relu(
            alpha_src[graph.senders] + alpha_dst[graph.receivers],
            negative_slope=0.2)                               # (E, H)
        att = segment_softmax(logits, graph.receivers, n,
                              edge_mask=graph.edge_mask,
                              dataflow=dataflow)              # (E, H)
        msg = h[graph.senders] * att[..., None]               # (E, H, Dh)
        _count_pass()         # the gather + weight message rewrite
        agg = segment_aggregate(
            msg.reshape(-1, heads * hd), graph.receivers, n, kind="sum",
            edge_mask=graph.edge_mask, dataflow=dataflow)
    out = agg if last else torch.nn.functional.elu(agg)
    return torch.where(graph.node_mask[:, None], out, 0.0)


def gat_apply(params, graph: GraphBatch, cfg: GNNConfig,
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    """GAT forward; ``dataflow.scan_layers`` either way runs a Python loop."""
    x = graph.node_feat.to(cfg.dtype)
    if stats is None and cfg.task == "graph":
        stats = precompute_graph_stats(graph, with_degrees=False,
                                       with_graph_counts=True)
    n_layers = cfg.num_layers
    for l, p in enumerate(params["layers"]):
        x = gat_layer(p, graph, x, dataflow, stats, last=l == n_layers - 1)
    return _readout(params["head"], cfg, graph, x, stats)


# ---------------------------------------------------------------------------
# PNA (mean / std / max / min times the degree scalers, Eq. 3)
# ---------------------------------------------------------------------------

def pna_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random PNA weights from ``gen`` with the reference's shapes: per layer
    an edge encoder, the pre-linear over [x_j | e] and the post layer over
    [x | 4 aggregators x 3 scalers]."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    layers = [{
        "edge_enc": _dense_init(gen, cfg.edge_feat_dim, d, cfg.dtype, dev),
        "pre": _dense_init(gen, 2 * d, d, cfg.dtype, dev),
        "post": _dense_init(gen, 12 * d + d, d, cfg.dtype, dev),
    } for _ in range(cfg.num_layers)]
    return {"node_enc": _dense_init(gen, cfg.node_feat_dim, d, cfg.dtype,
                                    dev),
            "layers": layers, "head": _head_init(gen, cfg, d, dev)}


def pna_layer(p, graph: GraphBatch, x: torch.Tensor,
              dataflow: DataflowConfig,
              stats: PrecomputedGraphStats) -> torch.Tensor:
    """One PNA layer; ``stats`` must carry ``pna_scalers`` and ``degrees``."""
    n = graph.n_node_pad
    d = p["pre"]["w"].shape[1]
    scalers = stats.pna_scalers                               # (N, 3)
    e = _dense(p["edge_enc"], graph.edge_feat)

    def message(src, dst, ee, _e=e, _p=p):
        return torch.relu(_dense(_p["pre"], torch.cat([src, _e], -1)))

    def update(xv, m, _p=p):
        # m: the 4 aggregators (N, 4D); times the 3 scalers: (N, 12D)
        scaled = (m[:, None, :] * scalers[:, :, None]).reshape(n, -1)
        return torch.relu(_dense(_p["post"], torch.cat([xv, scaled], -1)))

    # fusable phi: the pre-linear splits into a node-side transform (N rows,
    # not E) and an edge-side term, phi = relu(x@Ws[snd] + e@We + b).
    # fusable gamma: the scalers epilogue, one launch per layer.
    fusable = fu = None
    if dataflow.impl in _FUSABLE_IMPLS:
        w_pre, b_pre = p["pre"]["w"], p["pre"]["b"]
        fusable = FusableMessage(node_input=x @ w_pre[:d],
                                 edge_term=e @ w_pre[d:], bias=b_pre,
                                 activation="relu")
        if dataflow.impl == "fused_layer":
            fu = FusableUpdate(w1=p["post"]["w"], b1=p["post"]["b"],
                               scalers=scalers, out_activation="relu")
    return propagate(graph, x, message_fn=message, update_fn=update,
                     aggregate=PNA_STAT_KINDS, dataflow=dataflow,
                     stats=stats, fusable=fusable, fusable_update=fu)


def pna_apply(params, graph: GraphBatch, cfg: GNNConfig,
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    """PNA forward. One degree sweep serves the scalers and every layer's
    mean and std."""
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    if stats is None or stats.pna_scalers is None:
        stats = precompute_graph_stats(graph, pna_delta=cfg.avg_log_degree,
                                       with_graph_counts=cfg.task == "graph")
    for p in params["layers"]:
        x = pna_layer(p, graph, x, dataflow, stats)
    return _readout(params["head"], cfg, graph, x, stats)


# ---------------------------------------------------------------------------
# DGN (mean and the directional derivative along a node field)
# ---------------------------------------------------------------------------

def dgn_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random DGN weights from ``gen`` with the reference's shapes: per layer
    one post layer over [x | mean | |B_dx X|]."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    layers = [{"post": _dense_init(gen, 3 * d, d, cfg.dtype, dev)}
              for _ in range(cfg.num_layers)]
    return {"node_enc": _dense_init(gen, cfg.node_feat_dim, d, cfg.dtype,
                                    dev),
            "layers": layers, "head": _head_init(gen, cfg, d, dev)}


def dgn_lane_weights(graph: GraphBatch, stats: PrecomputedGraphStats, d: int,
                     dtype) -> torch.Tensor:
    """The layer-invariant [1 | w] per-lane weight stream (E, 2D) of DGN's
    phi."""
    e_pad = graph.n_edge_pad
    ones = torch.ones((e_pad, d), dtype=dtype, device=graph.device)
    return torch.cat([ones, stats.dgn_weights[:, None].expand(e_pad, d)
                      .to(dtype)], dim=-1)


def dgn_layer(p, graph: GraphBatch, x: torch.Tensor,
              dataflow: DataflowConfig, stats: PrecomputedGraphStats, *,
              lane_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DGN layer; ``stats`` must carry ``dgn_weights``, ``dgn_wsum`` and
    ``degrees``. ``lane_w`` shares the per-forward [1 | w] stream (built
    here when absent)."""
    d = p["post"]["w"].shape[1]
    w = stats.dgn_weights                                      # (E,)
    w_sum = stats.dgn_wsum                                     # (N,)
    if lane_w is None and dataflow.impl in _FUSABLE_IMPLS:
        lane_w = dgn_lane_weights(graph, stats, d, x.dtype)

    # the mean and the directional sum come out of one sweep over
    # [x_src | x_src * w]
    def message(src, dst, ee):
        return torch.cat([src, src * w[:, None]], dim=-1)

    def update(xv, m, _p=p):
        # m = [sum | mean] over the stacked lanes: (N, 4D)
        m_mean = m[:, 2 * d:3 * d]
        m_dx = torch.abs(m[:, d:2 * d] - xv * w_sum[:, None])  # |B_dx X|
        return torch.relu(_dense(_p["post"],
                                 torch.cat([xv, m_mean, m_dx], -1)))

    # fusable gamma: the field epilogue, one launch per layer
    fusable = fu = None
    if dataflow.impl in _FUSABLE_IMPLS:
        fusable = FusableMessage(node_input=torch.cat([x, x], dim=-1),
                                 src_weight=lane_w)
        if dataflow.impl == "fused_layer":
            fu = FusableUpdate(w1=p["post"]["w"], b1=p["post"]["b"],
                               field_wsum=w_sum, out_activation="relu")
    return propagate(graph, x, message_fn=message, update_fn=update,
                     aggregate=("sum", "mean"), dataflow=dataflow,
                     stats=stats, fusable=fusable, fusable_update=fu)


def dgn_apply(params, graph: GraphBatch, cfg: GNNConfig,
              dataflow: DataflowConfig = DEFAULT_DATAFLOW,
              stats: Optional[PrecomputedGraphStats] = None) -> torch.Tensor:
    """DGN forward: Y = [D^-1 A X ; |B_dx X|], B_dx built from each node's
    field ``node_pos``. The field weights, their sums and the degrees are
    layer-invariant and computed once."""
    x = torch.relu(_dense(params["node_enc"], graph.node_feat.to(cfg.dtype)))
    if stats is None or stats.dgn_weights is None:
        stats = precompute_graph_stats(graph, with_dgn_field=True,
                                       with_graph_counts=cfg.task == "graph")
    lane_w = None
    if dataflow.impl in _FUSABLE_IMPLS:
        lane_w = dgn_lane_weights(graph, stats, cfg.hidden_dim, x.dtype)
    for p in params["layers"]:
        x = dgn_layer(p, graph, x, dataflow, stats, lane_w=lane_w)
    return _readout(params["head"], cfg, graph, x, stats)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class GNNModel(NamedTuple):
    init: Callable[..., Params]
    apply: Callable[..., torch.Tensor]


GNN_MODELS: Dict[str, GNNModel] = {
    "gcn": GNNModel(gcn_init, gcn_apply),
    "gin": GNNModel(gin_init, gin_apply),
    "gin_vn": GNNModel(gin_vn_init, gin_vn_apply),
    "gat": GNNModel(gat_init, gat_apply),
    "pna": GNNModel(pna_init, pna_apply),
    "dgn": GNNModel(dgn_init, dgn_apply),
}


def make_gnn(cfg: GNNConfig) -> GNNModel:
    if cfg.model not in GNN_MODELS:
        raise KeyError(f"unknown GNN '{cfg.model}'; have {sorted(GNN_MODELS)}")
    return GNN_MODELS[cfg.model]
