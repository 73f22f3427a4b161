"""Admission validation: cheap vectorized checks on arriving graphs.

The twin of ``repro/core/validate.py``. A malformed graph is rejected at
``GraphStreamEngine.submit``, before it reaches the device: an out-of-range
edge index inside a gather or ``index_add_`` is a device-side fault, not a
clean error. ``check_graph`` and ``check_budget`` return a reason string
(``None`` = admissible) so the engine can attach its request id;
``validate_graph`` raises ``InvalidGraph`` from ``check_graph``'s reason.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.errors import InvalidGraph


def _is_int_dtype(a: np.ndarray) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.integer)


def check_graph(node_feat, senders, receivers, edge_feat=None,
                node_pos=None, *, node_feat_dim: Optional[int] = None,
                edge_feat_dim: Optional[int] = None,
                pos_dim: Optional[int] = None,
                require_finite: bool = False) -> Optional[str]:
    """Why this raw COO graph is inadmissible, or ``None`` if it is fine.

    Checks shapes, index dtypes, index range, feature widths against the
    model config (``None`` skips one) and, with ``require_finite``, that
    no float payload holds NaN/Inf.
    """
    node_feat = np.asarray(node_feat)
    if node_feat.ndim != 2:
        return f"node_feat must be 2-D (nodes x features), got " \
               f"shape {node_feat.shape}"
    n_nodes = node_feat.shape[0]
    if n_nodes == 0:
        return "graph has zero nodes"
    if node_feat_dim is not None and node_feat.shape[1] != node_feat_dim:
        return (f"node_feat width {node_feat.shape[1]} != model's "
                f"node_feat_dim {node_feat_dim}")

    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    if senders.ndim != 1 or receivers.ndim != 1:
        return "senders/receivers must be 1-D edge index arrays"
    if senders.shape[0] != receivers.shape[0]:
        return (f"senders ({senders.shape[0]}) and receivers "
                f"({receivers.shape[0]}) disagree on the edge count")
    if senders.size:
        if not _is_int_dtype(senders) or not _is_int_dtype(receivers):
            return (f"edge indices must be integers, got "
                    f"{senders.dtype}/{receivers.dtype}")
        lo = min(int(senders.min()), int(receivers.min()))
        hi = max(int(senders.max()), int(receivers.max()))
        if lo < 0 or hi >= n_nodes:
            return (f"edge index out of range: [{lo}, {hi}] not within "
                    f"[0, {n_nodes})")

    n_edges = senders.shape[0]
    if edge_feat is not None:
        edge_feat = np.asarray(edge_feat)
        if edge_feat.ndim != 2 or edge_feat.shape[0] != n_edges:
            return (f"edge_feat must be ({n_edges}, D), got "
                    f"shape {edge_feat.shape}")
        if edge_feat_dim is not None and edge_feat.shape[1] != edge_feat_dim:
            return (f"edge_feat width {edge_feat.shape[1]} != model's "
                    f"edge_feat_dim {edge_feat_dim}")
    if node_pos is not None:
        node_pos = np.asarray(node_pos)
        if node_pos.ndim != 2 or node_pos.shape[0] != n_nodes:
            return (f"node_pos must be ({n_nodes}, P), got "
                    f"shape {node_pos.shape}")
        if pos_dim is not None and node_pos.shape[1] != pos_dim:
            return (f"node_pos width {node_pos.shape[1]} != model's "
                    f"pos_dim {pos_dim}")

    if require_finite:
        for name, arr in (("node_feat", node_feat), ("edge_feat", edge_feat),
                          ("node_pos", node_pos)):
            if arr is not None and not bool(np.all(np.isfinite(arr))):
                return f"{name} contains non-finite values"
    return None


def check_budget(num_nodes: int, num_edges: int, *,
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None,
                 wide_enabled: bool = False) -> Optional[str]:
    """Why this graph exceeds the single-device serving budget, or ``None``.

    The budget is the largest bucket the engine serves (``max(
    GraphStreamEngine.buckets)`` node slots, plus an optional edge bound).
    A graph over budget is admissible only under wide placement (one graph
    split across devices), which the port does not have yet (ROADMAP queue
    1 item 6): its engine always passes ``wide_enabled=False`` and raises
    ``GraphTooLarge`` from the reason, whose words name the knob as the
    reference's do.
    """
    if node_budget is not None and num_nodes > node_budget:
        return (f"graph has {num_nodes} nodes > largest single-device "
                f"bucket {node_budget}"
                + ("" if wide_enabled else
                   " and wide placement is disabled (wide=True splits it "
                   "across the executor pool)"))
    if edge_budget is not None and num_edges > edge_budget:
        return (f"graph has {num_edges} edges > single-device edge "
                f"budget {edge_budget}"
                + ("" if wide_enabled else
                   " and wide placement is disabled (wide=True splits it "
                   "across the executor pool)"))
    return None


def validate_graph(node_feat, senders, receivers, edge_feat=None,
                   node_pos=None, *, node_feat_dim: Optional[int] = None,
                   edge_feat_dim: Optional[int] = None,
                   pos_dim: Optional[int] = None,
                   require_finite: bool = False) -> None:
    """Raise ``InvalidGraph`` when :func:`check_graph` finds a reason."""
    reason = check_graph(node_feat, senders, receivers, edge_feat, node_pos,
                         node_feat_dim=node_feat_dim,
                         edge_feat_dim=edge_feat_dim, pos_dim=pos_dim,
                         require_finite=require_finite)
    if reason is not None:
        raise InvalidGraph(reason)
