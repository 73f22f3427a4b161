"""The FlowGNN model zoo in PyTorch; this slice ports GIN (paper Eq. 1).

The twin of ``repro/core/models.py``. Parameters are plain nested dicts and
lists of tensors with the JAX layout: a dense layer is ``{"w": (d_in,
d_out), "b": (d_out,)}`` applied as ``x @ w + b``, so weights move between
the two sides without a transpose (``checkpoint/convert.py``).

GCN, GIN-VN, GAT, PNA and DGN are not ported yet: ``make_gnn`` raises
``NotImplementedError`` for them (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.graph import GraphBatch
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig, FusableMessage,
                                              FusableUpdate,
                                              PrecomputedGraphStats,
                                              global_pool,
                                              precompute_graph_stats,
                                              propagate)

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
# GIN (+ edge embeddings, Eq. 1)
# ---------------------------------------------------------------------------

def gin_init(gen: torch.Generator, cfg: GNNConfig,
             device: DeviceLike = None) -> Params:
    """Random GIN weights from ``gen`` with the reference's shapes and
    scales (the two sides' random numbers differ; parity tests move the
    JAX weights across instead)."""
    dev = resolve_device(device)
    d = cfg.hidden_dim
    layers = []
    node_enc = _dense_init(gen, cfg.node_feat_dim, d, cfg.dtype, dev)
    for _ in range(cfg.num_layers):
        layers.append({
            "edge_enc": _dense_init(gen, cfg.edge_feat_dim, d, cfg.dtype, dev),
            "mlp": _mlp_init(gen, (d, 2 * d, d), cfg.dtype, dev),
            "eps": torch.tensor(cfg.eps_init, dtype=cfg.dtype, device=dev),
        })
    return {"node_enc": node_enc, "layers": layers,
            "head": _head_init(gen, cfg, d, dev)}


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


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class GNNModel(NamedTuple):
    init: Callable[..., Params]
    apply: Callable[..., torch.Tensor]


GNN_MODELS: Dict[str, GNNModel] = {"gin": GNNModel(gin_init, gin_apply)}
_NOT_PORTED = ("gcn", "gin_vn", "gat", "pna", "dgn")


def make_gnn(cfg: GNNConfig) -> GNNModel:
    if cfg.model in _NOT_PORTED:
        raise NotImplementedError(
            f"model '{cfg.model}' is not ported yet: ROADMAP queue 1 item 4 "
            f"(models, one per slice)")
    if cfg.model not in GNN_MODELS:
        raise KeyError(f"unknown GNN '{cfg.model}'; have "
                       f"{sorted(GNN_MODELS) + list(_NOT_PORTED)}")
    return GNN_MODELS[cfg.model]
