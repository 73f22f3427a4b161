"""Wide placement: one oversized graph split across a gang of K executors.

The twin of ``repro/distributed/wide.py``. A graph bigger than any bucket
of the engine is split into K shards that each run the per-layer dataflow
on their own rows and exchange boundary ("halo") rows between layers: the
multi-queue scale-out of FlowGNN's MP units lifted from banks within a
device to executors within a pool (DESIGN.md §10).

Partition rule, **destination ownership**: shard k owns the contiguous
global node range [cut_k, cut_{k+1}) and *every in-edge of those nodes*, in
global edge order. So

  * every per-destination aggregate (sums, means, extrema, softmax
    denominators, degree counts) is complete on the owning shard and folds
    its edges in the single-device order;
  * the only cross-shard state is the feature rows of remote senders (the
    halo), refreshed once per layer by K-1 ring steps
    (``distributed/pipeline.py::ring_shift``); the local edge sweep and
    the update need nothing remote after that;
  * the node-side transforms (GAT's attention halves, PNA's pre-linear)
    are recomputed on the halo rows rather than shipped.

The merge algebra a *source*-partitioned split would need (sums by
addition, keyed extrema at the finite ``-BIG`` neutral, online-softmax
``(m, l, s)`` carries by the flash rescale) is here as plain torch
functions and tested against one sweep; destination ownership never needs
it on the per-layer path. The cross-shard reductions that remain (GIN-VN's
virtual-node pool, the readout) run on the gathered full node buffer in
global order.

The plan is one numpy pass over the edge stream (O(E + N) plus a sort of
the boundary senders), with no METIS-style preprocessing: the paper's
real-time, zero-preprocessing claim. The planner and the shard arrays are
the reference's line for line, so the same inputs give identical plans.

Where the reference compiles a ``shard_map`` over a mesh, the port's
runner (:class:`WideForward`) takes the gang itself (:class:`WideGang`):
the members' devices and, on a GPU, their streams. Shard i runs on member
i's stream, forked from the caller's stream by events; the ring steps and
the gathers join them. The engine captures this schedule once per
(``WideBucket``, gang) as one CUDA graph when the gang shares one card
(``core/engine.py::CapturedWideProgram``); on the CPU, and for a gang
spread over several cards, it runs eagerly.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.graph import GraphBatch, pad_bucket
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig,
                                              PrecomputedGraphStats,
                                              _uncounted,
                                              precompute_graph_stats)
from repro_torch.distributed.pipeline import ring_shift

# finite keyed-extrema neutral (the kernels' BIG)
BIG = 1e30


# ---------------------------------------------------------------------------
# partial-aggregate merge algebra (the boundary-bank contract, DESIGN.md §10)
# ---------------------------------------------------------------------------

def merge_partial_sums(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Merge additive partial aggregates (sum / sumsq / count) across
    shards: a left fold in shard order (floating-point addition does not
    reassociate, so the order is part of the contract)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def merge_partial_extrema(parts: Sequence[torch.Tensor], *,
                          kind: str) -> torch.Tensor:
    """Merge keyed max / min partial accumulators across shards. A
    destination a shard saw no edge of sits at the finite ``-BIG`` /
    ``+BIG`` neutral (never an infinity), so the merge is a plain
    elementwise extremum, and a destination empty on every shard stays at
    the neutral for the count or degree validity stream to clear."""
    if kind not in ("max", "min"):
        raise ValueError(f"kind must be max|min, got {kind!r}")
    op = torch.maximum if kind == "max" else torch.minimum
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def merge_softmax_carries(
    parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge per-shard online-softmax carries ``(m, l, s)`` per destination
    (and head) with the flash rescale::

        m'  = max(m_a, m_b)
        l'  = l_a * exp(m_a - m') + l_b * exp(m_b - m')
        s'  = s_a * exp(m_a - m') + s_b * exp(m_b - m')

    A destination with no local edge carries ``(-BIG, 0, 0)``; the
    epilogue ``s' / max(l', eps)`` comes after the merge."""
    m, l, s = parts[0]
    for m_b, l_b, s_b in parts[1:]:
        m_new = torch.maximum(m, m_b)
        r_a = torch.exp(m - m_new)
        r_b = torch.exp(m_b - m_new)
        l = l * r_a + l_b * r_b
        if s.dim() == l.dim() + 1:          # per-head values over D
            s = s * r_a[..., None] + s_b * r_b[..., None]
        else:
            s = s * r_a + s_b * r_b
        m = m_new
    return m, l, s


def softmax_carry(logits: torch.Tensor, values: torch.Tensor,
                  receivers: torch.Tensor, num_nodes: int, *,
                  edge_mask: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One local sweep giving the ``(m, l, s)`` online-softmax carry.

    logits (E,) or (E, H); values (E, D), broadcast over the heads when the
    logits have them. Masked edges give the ``(-BIG, 0, 0)`` neutral."""
    rcv = receivers.long()
    if edge_mask is None:
        edge_mask = torch.ones(logits.shape[0], dtype=torch.bool,
                               device=logits.device)
    lm = edge_mask if logits.dim() == 1 else edge_mask[:, None]
    neg = torch.where(lm, logits, torch.full_like(logits, -BIG))
    idx = rcv if logits.dim() == 1 else rcv[:, None].expand_as(neg)
    m = torch.full((num_nodes,) + tuple(logits.shape[1:]), -float("inf"),
                   dtype=logits.dtype, device=logits.device)
    m = m.scatter_reduce(0, idx, neg, reduce="amax", include_self=True)
    m = torch.clamp(m, min=-BIG)            # all-masked rows at the neutral
    e = torch.where(lm, torch.exp(logits - m[rcv]), 0.0)
    l = torch.zeros_like(m).index_add_(0, rcv, e)
    ev = (e[..., None] * values[:, None, :] if logits.dim() == 2
          else e[:, None] * values)
    s = torch.zeros((num_nodes,) + tuple(ev.shape[1:]), dtype=ev.dtype,
                    device=ev.device).index_add_(0, rcv, ev)
    return m, l, s


# ---------------------------------------------------------------------------
# shard planner (numpy; the reference's, line for line)
# ---------------------------------------------------------------------------

class WidePlanError(ValueError):
    """The graph cannot be split into K shards within the given budgets."""


@dataclass(frozen=True)
class ShardPlan:
    """Host-side (numpy) layout of one shard. Local node rows are

        [0, n_own)                          owned nodes (global [lo, lo+n_own))
        [n_own, n_own_pad)                  dead padding
        [n_own_pad + (s-1)*h_pad, ... + h)  halo rows received at ring step s
                                            (from peer (k - s) mod K), sorted
                                            by global id
        remaining rows                      dead padding
    """

    index: int
    lo: int
    n_own: int
    halo_counts: np.ndarray      # (K-1,) real halo rows per ring step
    halo_ids: Tuple[np.ndarray, ...]   # per step: global ids, sorted
    send_idx: np.ndarray         # (K-1, h_pad) owned-local rows sent at step s
    senders: np.ndarray          # (E_k,) local ids, global edge order
    receivers: np.ndarray        # (E_k,) local ids (owned), global edge order
    edge_ids: np.ndarray         # (E_k,) global edge indices


@dataclass(frozen=True)
class WideBucket:
    """The shape key of a wide program: padded geometry only, none of it a
    specific graph's cuts or halo, so one program serves every graph whose
    plan lands in the bucket (the engine's one program per bucket, extended
    to gangs). Each graph's content (features, edges, send tables, gather
    map, masks, degrees) flows in through the program's inputs."""

    k: int
    n_own_pad: int
    h_pad: int
    n_pad: int
    e_pad: int
    node_pad_full: int
    graph_pad_full: int = 1


@dataclass(frozen=True)
class WidePlan:
    k: int
    n_nodes: int
    n_edges: int
    n_own_pad: int               # uniform owned-slot count (bucket-rounded)
    h_pad: int                   # uniform halo slots per ring step (rounded)
    n_pad: int                   # uniform local node padding (incl. halo)
    e_pad: int                   # uniform local edge padding
    node_pad_full: int           # full-graph padding for the readout
    graph_pad_full: int
    shards: Tuple[ShardPlan, ...]
    degrees: np.ndarray          # (n_nodes,) exact global in-degrees (f32)
    halo_rows_per_layer: int     # total real rows exchanged per layer

    @property
    def bucket(self) -> WideBucket:
        return WideBucket(
            k=self.k, n_own_pad=self.n_own_pad, h_pad=self.h_pad,
            n_pad=self.n_pad, e_pad=self.e_pad,
            node_pad_full=self.node_pad_full,
            graph_pad_full=self.graph_pad_full)

    def halo_bytes_per_layer(self, feat_dim: int, itemsize: int = 4) -> int:
        return self.halo_rows_per_layer * feat_dim * itemsize


def plan_wide(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    k: int,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    node_pad_full: Optional[int] = None,
) -> WidePlan:
    """Split one raw COO graph into K dest-owned shards and their halo
    tables.

    One pass over the edge stream (degree histogram, per-shard selection)
    plus a sort of each shard's boundary senders: no global clustering.
    Cuts balance *in-edges* (the edge sweep is the dominant cost), subject
    to contiguity. Raises :class:`WidePlanError` when a shard exceeds the
    node or edge budget (the engine then raises ``GraphTooLarge``).
    """
    if k < 2:
        raise ValueError(f"wide placement needs k >= 2, got {k}")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    n, e = int(num_nodes), int(senders.shape[0])

    deg = np.bincount(receivers, minlength=n).astype(np.int64)
    csum = np.cumsum(deg)
    # cut after ~i*E/k in-edges, monotone and non-degenerate. Each shard's
    # owned count is also capped at the bucket of ceil(n/k): a cut that
    # overshoots the node split by one row would round n_own_pad up to the
    # NEXT bucket and double every shard's padded geometry (the lower clamp
    # keeps the remaining shards feasible under the cap: k*cap >= n).
    cap = pad_bucket(-(-n // k))
    cuts = [0]
    for i in range(1, k):
        c = int(np.searchsorted(csum, e * i / k, side="left")) + 1
        c = min(c, cuts[-1] + cap)
        c = max(c, n - (k - i) * cap)
        c = min(max(c, cuts[-1] + 1), n - (k - i))
        cuts.append(c)
    cuts.append(n)
    cuts = np.asarray(cuts, np.int64)
    owner_of = np.repeat(np.arange(k), np.diff(cuts))      # (n,)

    edge_owner = owner_of[receivers]
    shards: List[Any] = []
    halo_ids_all: List[List[np.ndarray]] = []
    for kk in range(k):
        lo, hi = int(cuts[kk]), int(cuts[kk + 1])
        eidx = np.flatnonzero(edge_owner == kk)            # global edge order
        snd_g = senders[eidx]
        # halo grouped by ring step: step s receives from (kk - s) mod k
        steps = []
        for s in range(1, k):
            src = (kk - s) % k
            sel = owner_of[snd_g] == src
            steps.append(np.unique(snd_g[sel]))            # sorted global ids
        halo_ids_all.append(steps)
        shards.append((lo, hi, eidx, snd_g, steps))

    n_own = np.diff(cuts).astype(np.int64)
    h_counts = np.array([[len(st) for st in steps]
                         for steps in halo_ids_all], np.int64)   # (k, k-1)
    # every padding bound is bucket-rounded, so that plans of same-scale
    # graphs land in the same WideBucket and share one program
    n_own_pad = pad_bucket(int(n_own.max()))
    h_pad = pad_bucket(int(max(1, h_counts.max())))
    n_pad = pad_bucket(n_own_pad + (k - 1) * h_pad)
    e_pad = pad_bucket(int(max(len(sh[2]) for sh in shards)))
    if node_budget is not None and n_pad > node_budget:
        raise WidePlanError(
            f"wide k={k}: shard needs {n_pad} node rows "
            f"(own {n_own_pad} + halo {(k - 1) * h_pad}) > budget "
            f"{node_budget}")
    if edge_budget is not None and e_pad > edge_budget:
        raise WidePlanError(
            f"wide k={k}: shard needs {e_pad} edge rows > budget "
            f"{edge_budget}")

    out: List[ShardPlan] = []
    for kk in range(k):
        lo, hi, eidx, snd_g, steps = shards[kk]
        loc = np.full(n, 0, np.int64)
        loc[lo:hi] = np.arange(hi - lo)
        for s, ids in enumerate(steps, start=1):
            loc[ids] = n_own_pad + (s - 1) * h_pad + np.arange(len(ids))
        # send table: at step s this shard feeds peer (kk + s) mod k, that
        # peer's halo block for source kk, in the same sorted global order
        send = np.zeros((k - 1, h_pad), np.int64)
        for s in range(1, k):
            dst = (kk + s) % k
            ids = halo_ids_all[dst][s - 1]     # dst's block s-1 is from kk
            send[s - 1, :len(ids)] = ids - lo  # owned-local rows
        out.append(ShardPlan(
            index=kk, lo=lo, n_own=hi - lo,
            halo_counts=h_counts[kk].copy(),
            halo_ids=tuple(steps),
            send_idx=send.astype(np.int32),
            senders=loc[snd_g].astype(np.int32),
            receivers=(receivers[eidx] - lo).astype(np.int32),
            edge_ids=eidx,
        ))

    return WidePlan(
        k=k, n_nodes=n, n_edges=e,
        n_own_pad=n_own_pad, h_pad=h_pad, n_pad=n_pad, e_pad=e_pad,
        node_pad_full=(node_pad_full if node_pad_full is not None
                       else pad_bucket(n)),
        graph_pad_full=1,
        shards=tuple(out),
        degrees=deg.astype(np.float32),
        halo_rows_per_layer=int(h_counts.sum()),
    )


# ---------------------------------------------------------------------------
# shard arrays (host -> padded local arrays)
# ---------------------------------------------------------------------------

def _shard_arrays(plan: WidePlan, sp: ShardPlan, node_feat: np.ndarray,
                  edge_feat: Optional[np.ndarray],
                  node_pos: Optional[np.ndarray],
                  pos_dim: int = 1) -> Dict[str, np.ndarray]:
    """Padded local arrays of one shard (numpy, ready to stack or ship)."""
    n_pad, e_pad = plan.n_pad, plan.e_pad
    f = node_feat.shape[1]
    if edge_feat is None:
        edge_feat = np.zeros((plan.n_edges, 1), np.float32)
    if node_pos is None:
        node_pos = np.zeros((plan.n_nodes, pos_dim), np.float32)

    nf = np.zeros((n_pad, f), np.float32)
    npos = np.zeros((n_pad, node_pos.shape[1]), np.float32)
    nmask = np.zeros((n_pad,), bool)
    deg = np.zeros((n_pad,), np.float32)

    nf[:sp.n_own] = node_feat[sp.lo:sp.lo + sp.n_own]
    npos[:sp.n_own] = node_pos[sp.lo:sp.lo + sp.n_own]
    nmask[:sp.n_own] = True
    deg[:sp.n_own] = plan.degrees[sp.lo:sp.lo + sp.n_own]
    for s, ids in enumerate(sp.halo_ids, start=1):
        r0 = plan.n_own_pad + (s - 1) * plan.h_pad
        nf[r0:r0 + len(ids)] = node_feat[ids]
        npos[r0:r0 + len(ids)] = node_pos[ids]
        nmask[r0:r0 + len(ids)] = True
        deg[r0:r0 + len(ids)] = plan.degrees[ids]

    ne = len(sp.edge_ids)
    ef = np.zeros((e_pad, edge_feat.shape[1]), np.float32)
    ef[:ne] = edge_feat[sp.edge_ids]
    snd = np.zeros((e_pad,), np.int32)
    snd[:ne] = sp.senders
    rcv = np.zeros((e_pad,), np.int32)
    rcv[:ne] = sp.receivers
    emask = np.zeros((e_pad,), bool)
    emask[:ne] = True

    return {
        "node_feat": nf, "edge_feat": ef, "node_pos": npos,
        "senders": snd, "receivers": rcv,
        "node_mask": nmask, "edge_mask": emask,
        "degrees": deg, "send_idx": sp.send_idx,
    }


def stack_shard_arrays(plan: WidePlan, node_feat: np.ndarray,
                       edge_feat: Optional[np.ndarray] = None,
                       node_pos: Optional[np.ndarray] = None,
                       ) -> Dict[str, np.ndarray]:
    """Every shard's local arrays stacked on a leading K axis, plus the two
    per-graph tables a program needs as inputs (so that one program per
    :class:`WideBucket` serves every graph in it): ``full_map`` (global row
    i of the readout buffer is row ``full_map[i]`` of the shards' owned
    rows laid end to end) and ``full_node_mask``, each repeated per
    shard."""
    per = [_shard_arrays(plan, sp, node_feat, edge_feat, node_pos)
           for sp in plan.shards]
    stacked = {key: np.stack([a[key] for a in per]) for key in per[0]}
    fmap = np.zeros((plan.node_pad_full,), np.int32)
    for kk, sp in enumerate(plan.shards):
        fmap[sp.lo:sp.lo + sp.n_own] = (
            kk * plan.n_own_pad + np.arange(sp.n_own))
    fmask = np.arange(plan.node_pad_full) < plan.n_nodes
    stacked["full_map"] = np.broadcast_to(
        fmap, (plan.k, plan.node_pad_full)).copy()
    stacked["full_node_mask"] = np.broadcast_to(
        fmask, (plan.k, plan.node_pad_full)).copy()
    return stacked


#: the torch dtype each stacked array has on a device (indices int64, as a
#: ``GraphBatch`` holds them)
WIDE_DTYPES = {"node_feat": torch.float32, "edge_feat": torch.float32,
               "node_pos": torch.float32, "senders": torch.int64,
               "receivers": torch.int64, "node_mask": torch.bool,
               "edge_mask": torch.bool, "degrees": torch.float32,
               "send_idx": torch.int64, "full_map": torch.int64,
               "full_node_mask": torch.bool}


def _to_tensor(key: str, a: np.ndarray, device: torch.device
               ) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=WIDE_DTYPES[key])


def _local_graph(arr: Dict[str, torch.Tensor], n_pad: int) -> GraphBatch:
    """One shard's local arrays as a GraphBatch (one graph, id 0)."""
    dev = arr["node_feat"].device
    return GraphBatch(
        node_feat=arr["node_feat"], edge_feat=arr["edge_feat"],
        senders=arr["senders"], receivers=arr["receivers"],
        node_mask=arr["node_mask"], edge_mask=arr["edge_mask"],
        graph_ids=torch.zeros((n_pad,), dtype=torch.int64, device=dev),
        graph_mask=torch.ones((1,), dtype=torch.bool, device=dev),
        node_pos=arr["node_pos"])


def _full_meta_graph(node_mask: torch.Tensor,
                     graph_pad_full: int = 1) -> GraphBatch:
    """Skeleton full-graph batch for the readout and the virtual node (only
    the masks and the graph ids matter)."""
    dev, n_pad = node_mask.device, node_mask.shape[0]
    return GraphBatch(
        node_feat=torch.zeros((n_pad, 1), device=dev),
        edge_feat=torch.zeros((1, 1), device=dev),
        senders=torch.zeros((1,), dtype=torch.int64, device=dev),
        receivers=torch.zeros((1,), dtype=torch.int64, device=dev),
        node_mask=node_mask,
        edge_mask=torch.zeros((1,), dtype=torch.bool, device=dev),
        graph_ids=torch.zeros((n_pad,), dtype=torch.int64, device=dev),
        graph_mask=torch.ones((graph_pad_full,), dtype=torch.bool,
                              device=dev),
        node_pos=torch.zeros((n_pad, 1), device=dev))


# ---------------------------------------------------------------------------
# per-model plumbing (encode, per-layer body, stats)
# ---------------------------------------------------------------------------

def _encode(params, cfg, node_feat: torch.Tensor) -> torch.Tensor:
    from repro_torch.core.models import _dense
    x = node_feat.to(cfg.dtype)
    if cfg.model in ("gcn", "gat"):
        return x
    return torch.relu(_dense(params["node_enc"], x))


def _make_shard_stats(cfg, graph: GraphBatch, degrees: torch.Tensor,
                      ) -> Optional[PrecomputedGraphStats]:
    """A shard's statistics with the exact *global* in-degrees injected.

    Halo rows have no local in-edges, but their degree normalisers (GCN's
    ``inv_sqrt_deg[senders]``, PNA's scalers) must be the owner's. DGN's
    field comes from the local edges: destination ownership makes every
    per-destination field statistic complete on the shard."""
    if cfg.model == "gcn":
        return precompute_graph_stats(graph, with_self_loop_norm=True,
                                      degrees=degrees)
    if cfg.model == "pna":
        return precompute_graph_stats(graph, pna_delta=cfg.avg_log_degree,
                                      degrees=degrees)
    if cfg.model == "dgn":
        return precompute_graph_stats(graph, with_dgn_field=True,
                                      degrees=degrees)
    return None


def _layer_body(params, cfg, li: int, graph: GraphBatch, x: torch.Tensor,
                dataflow: DataflowConfig,
                stats: Optional[PrecomputedGraphStats]) -> torch.Tensor:
    from repro_torch.core import models as M
    p = params["layers"][li]
    last = li == cfg.num_layers - 1
    if cfg.model == "gcn":
        return M.gcn_layer(p, graph, x, dataflow, stats, last=last)
    if cfg.model in ("gin", "gin_vn"):
        return M._gin_layer(p, graph, x, dataflow, stats)
    if cfg.model == "gat":
        return M.gat_layer(p, graph, x, dataflow, stats, last=last)
    if cfg.model == "pna":
        return M.pna_layer(p, graph, x, dataflow, stats)
    if cfg.model == "dgn":
        return M.dgn_layer(p, graph, x, dataflow, stats)
    raise KeyError(f"unknown wide model '{cfg.model}'")


# ---------------------------------------------------------------------------
# reference runner (a host loop over the shards on one device)
# ---------------------------------------------------------------------------

def wide_forward_reference(params, cfg, plan: WidePlan,
                           node_feat: np.ndarray,
                           edge_feat: Optional[np.ndarray] = None,
                           node_pos: Optional[np.ndarray] = None,
                           dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                           device: DeviceLike = None) -> torch.Tensor:
    """The wide forward as a host loop over the K shards on one device,
    the exchanges done by indexing (only each block's real rows): the
    oracle of :class:`WideForward`, with the same per-shard programs and
    exchange schedule."""
    from repro_torch.core.models import (_readout, gin_vn_broadcast,
                                         gin_vn_update)
    dev = resolve_device(device)
    k = plan.k
    arrs = [{key: _to_tensor(key, a, dev) for key, a in
             _shard_arrays(plan, sp, node_feat, edge_feat, node_pos).items()}
            for sp in plan.shards]
    graphs = [_local_graph(a, plan.n_pad) for a in arrs]
    stats = [_make_shard_stats(cfg, g, a["degrees"])
             for g, a in zip(graphs, arrs)]
    xs = [_encode(params, cfg, g.node_feat) for g in graphs]

    full = _full_meta_graph(
        torch.arange(plan.node_pad_full, device=dev) < plan.n_nodes,
        plan.graph_pad_full)
    vn = (torch.zeros((plan.graph_pad_full, cfg.hidden_dim), dtype=cfg.dtype,
                      device=dev) if cfg.model == "gin_vn" else None)

    def exchange(xs):
        new = [x.clone() for x in xs]
        for s in range(1, k):
            for j in range(k):
                dst = (j + s) % k
                cnt = int(plan.shards[dst].halo_counts[s - 1])
                if cnt == 0:
                    continue
                idx = torch.as_tensor(plan.shards[j].send_idx[s - 1, :cnt],
                                      dtype=torch.int64, device=dev)
                r0 = plan.n_own_pad + (s - 1) * plan.h_pad
                new[dst][r0:r0 + cnt] = xs[j][idx]
        return new

    def gather_full(xs):
        xf = torch.zeros((plan.node_pad_full, xs[0].shape[1]),
                         dtype=xs[0].dtype, device=dev)
        for kk, sp in enumerate(plan.shards):
            xf[sp.lo:sp.lo + sp.n_own] = xs[kk][:sp.n_own]
        return xf

    with torch.inference_mode():
        for li in range(cfg.num_layers):
            if li > 0:
                xs = exchange(xs)
            if vn is not None:
                xs = [gin_vn_broadcast(g, x, vn) for g, x in zip(graphs, xs)]
            xs = [_layer_body(params, cfg, li, g, x, dataflow, st)
                  for g, x, st in zip(graphs, xs, stats)]
            if vn is not None and li < cfg.num_layers - 1:
                vn = gin_vn_update(params["vn_mlps"][li], full,
                                   gather_full(xs), vn)
        return _readout(params["head"], cfg, full, gather_full(xs))


# ---------------------------------------------------------------------------
# the gang runner (the twin of the reference's shard_map program)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WideGang:
    """The gang a wide forward runs on, in ring order: each member's device
    and, on a GPU, its stream (None on the CPU). Member 0 leads: its shard
    runs on the caller's current stream, the readout and the virtual node
    on its device."""

    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional[torch.cuda.Stream], ...]

    @property
    def k(self) -> int:
        return len(self.devices)

    @property
    def one_card(self) -> bool:
        """Every member on one CUDA device: the gang's forward can be
        captured as one CUDA graph."""
        return (self.devices[0].type == "cuda"
                and all(d == self.devices[0] for d in self.devices))


def wide_mesh(devices: Sequence[DeviceLike],
              streams: Optional[Sequence[Optional[torch.cuda.Stream]]] = None
              ) -> WideGang:
    """The gang over ``devices`` (the reference's 1-D mesh); on a GPU each
    member gets a stream of its own unless ``streams`` names them (the
    engine passes its executors')."""
    devs = tuple(torch.device(d) for d in devices)
    if streams is None:
        streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in devs)
    if len(streams) != len(devs):
        raise ValueError("one stream per member")
    return WideGang(devs, tuple(streams))


class WideForward:
    """The wide forward of one :class:`WideBucket` on one gang: ``fn(params,
    stacked) -> out`` (``stacked``: :func:`stack_shard_arrays`), the twin of
    the reference's compiled ``shard_map`` program.

    Only the bucket's padded geometry is fixed; every graph whose plan lands
    in it runs through ``run(params, inputs)`` on tensors made by
    ``device_inputs`` (the engine's captured program keeps one set of them
    and copies each graph in). Per layer, shard i runs its layer on member
    i's stream; the K-1 ring steps gather each shard's send rows, hand them
    on (``ring_shift``) and write each into the receiver's halo block at
    ``n_own_pad + (s-1)*h_pad``; ``gather_full`` lays the shards' owned rows
    end to end on the leader and picks the full graph's rows through
    ``full_map`` (GIN-VN's virtual node, the readout). ``params`` is one
    tree or one per member. Passes over the edges are counted for shard 0
    alone: the per-shard figure, as the reference counts one traced
    shard."""

    def __init__(self, cfg, bucket, gang: WideGang,
                 dataflow: DataflowConfig = DEFAULT_DATAFLOW):
        b: WideBucket = getattr(bucket, "bucket", bucket)
        if gang.k != b.k:
            raise ValueError(f"bucket has k={b.k}, gang {gang.k} members")
        self.cfg, self.bucket, self.gang = cfg, b, gang
        self.dataflow = dataflow

    def device_inputs(self, stacked: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """``stacked`` on the gang: on one card one tensor per array with
        the K axis in front (the form a captured program keeps); else a
        tensor per array and member, on the member's device."""
        gang = self.gang
        if len(set(gang.devices)) == 1:
            dev = gang.devices[0]
            return {key: _to_tensor(key, a, dev)
                    for key, a in stacked.items()}
        out: Dict[str, Any] = {key: [] for key in stacked}
        for i, (d, st) in enumerate(zip(gang.devices, gang.streams)):
            # made on the member's stream, where its shard reads them
            with (torch.cuda.stream(st) if st is not None
                  else nullcontext()):
                for key, a in stacked.items():
                    out[key].append(_to_tensor(key, a[i], d))
        return out

    def __call__(self, params, stacked: Dict[str, np.ndarray], *,
                 ring_events: Optional[list] = None) -> torch.Tensor:
        with torch.inference_mode():
            return self.run(params, self.device_inputs(stacked),
                            ring_events=ring_events)

    def run(self, params, inputs: Dict[str, Any], *,
            ring_events: Optional[list] = None) -> torch.Tensor:
        """The schedule on ``inputs`` (``device_inputs``' form). With
        ``ring_events`` (a list; on a GPU) the members are joined around
        each ring step and a (start, end) pair of timing events is
        appended per (layer, step): the steps' own time, serialised."""
        from repro_torch.core.models import (_readout, gin_vn_broadcast,
                                             gin_vn_update)
        cfg, b, gang = self.cfg, self.bucket, self.gang
        k, devs = b.k, gang.devices
        trees = (list(params) if isinstance(params, (list, tuple))
                 else [params] * k)
        cuda = devs[0].type == "cuda"
        streams: List[Optional[torch.cuda.Stream]] = (
            [torch.cuda.current_stream(devs[0])] + list(gang.streams[1:])
            if cuda else [None] * k)
        capturing = cuda and torch.cuda.is_current_stream_capturing()
        if not cuda:
            ring_events = None
        # every tensor made here stays referenced until the schedule ends,
        # so that no block is freed and reused on one stream while another
        # stream may still read it
        keep: List[Any] = []

        def on(i):
            return (torch.cuda.stream(streams[i]) if cuda
                    else nullcontext())

        def counted(i):
            return nullcontext() if i == 0 else _uncounted()

        def fork():
            for i in range(1, k):
                streams[i].wait_stream(streams[0])

        def join():
            for i in range(1, k):
                streams[0].wait_stream(streams[i])

        full_mask = inputs["full_node_mask"][0]
        full_map = inputs["full_map"][0]
        full = _full_meta_graph(full_mask, b.graph_pad_full)
        vn = (torch.zeros((b.graph_pad_full, cfg.hidden_dim),
                          dtype=cfg.dtype, device=devs[0])
              if cfg.model == "gin_vn" else None)
        keep += [full, vn]

        def gather_full(xs):
            flat = torch.cat([x[:b.n_own_pad].to(devs[0]) for x in xs])
            return torch.where(full_mask[:, None], flat[full_map], 0.0)

        if cuda:
            fork()
        graphs, stats, xs = [], [], []
        for i in range(k):
            with on(i), counted(i):
                arr = {key: inputs[key][i] for key in
                       ("node_feat", "edge_feat", "node_pos", "senders",
                        "receivers", "node_mask", "edge_mask")}
                g = _local_graph(arr, b.n_pad)
                st = _make_shard_stats(cfg, g, inputs["degrees"][i])
                xs.append(_encode(trees[i], cfg, g.node_feat))
            graphs.append(g)
            stats.append(st)
        keep += [graphs, stats, list(xs)]

        for li in range(cfg.num_layers):
            if li > 0:
                for s in range(1, k):
                    if ring_events is not None:
                        join()
                        ring_events.append((torch.cuda.Event(
                            enable_timing=True), torch.cuda.Event(
                            enable_timing=True)))
                        ring_events[-1][0].record(streams[0])
                        fork()
                    rows = []
                    for j in range(k):
                        with on(j):
                            rows.append(xs[j].index_select(
                                0, inputs["send_idx"][j][s - 1]))
                    got = ring_shift(rows, steps=s,
                                     streams=streams if cuda else None)
                    r0 = b.n_own_pad + (s - 1) * b.h_pad
                    for i in range(k):
                        with on(i):
                            xs[i][r0:r0 + b.h_pad].copy_(got[i])
                    keep += [rows, got]
                    if ring_events is not None:
                        join()
                        ring_events[-1][1].record(streams[0])
                        fork()
            vns = None
            if vn is not None:
                # the members' streams already wait on the leader's (fork)
                vns = []
                for i in range(k):
                    with on(i):
                        vns.append(vn.to(devs[i], non_blocking=True))
                keep.append(vns)
            for i in range(k):
                with on(i), counted(i):
                    x = (xs[i] if vns is None
                         else gin_vn_broadcast(graphs[i], xs[i], vns[i]))
                    xs[i] = _layer_body(trees[i], cfg, li, graphs[i], x,
                                        self.dataflow, stats[i])
            keep.append(list(xs))
            if vn is not None and li < cfg.num_layers - 1:
                if cuda:
                    join()
                vn = gin_vn_update(trees[0]["vn_mlps"][li], full,
                                   gather_full(xs), vn)
                keep.append(vn)
                if cuda:
                    fork()
        if cuda:
            join()
        out = _readout(trees[0]["head"], cfg, full, gather_full(xs))
        if cuda and not capturing:
            # the members' later work waits for the leader's last reads of
            # their tensors, whose blocks are freed on return
            fork()
        return out


def build_wide_forward(cfg, bucket, gang: WideGang,
                       dataflow: DataflowConfig = DEFAULT_DATAFLOW
                       ) -> WideForward:
    """The wide forward of ``bucket`` (a :class:`WideBucket`, or a
    :class:`WidePlan`, whose bucket is taken) on ``gang``
    (:func:`wide_mesh`): ``fn(params, stacked) -> out`` on the leader's
    device (a graph task's (1, out_dim), a node task's (node_pad_full,
    out_dim))."""
    return WideForward(cfg, bucket, gang, dataflow)
