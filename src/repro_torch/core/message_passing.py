"""FlowGNN's generic message-passing step (paper Eq. 2), in PyTorch.

    x_i^{l+1} = gamma( x_i^l,  A_{j in N(i)}  phi(x_i^l, x_j^l, e_{j,i}^l) )

The twin of ``repro/core/message_passing.py``, holding what the six models
of the zoo need:

  * ``propagate`` with every arm of the reference: ``impl='fused'``,
    ``'twopass'`` and ``'unfused'`` (gather, ``message_fn``, the plain
    aggregation, ``update_fn``; PyTorch runs eagerly, so the (E, D) message
    is materialised under all three, which is what the reference's
    ``twopass`` forces and its ``unfused`` ladder floor does); ``'banked'``
    (the same, with ``banked_segment_sum`` for the sums); ``'kernel'`` (the
    same, with every aggregation one launch of the ``mp_scatter``,
    ``mp_scatter_multi`` or ``seg_softmax`` kernel); ``'pipeline'``, where a
    ``FusableMessage`` runs the whole edge phase as one launch of the
    ``mp_pipeline`` kernel (``fused_edge_aggregate``) before ``update_fn``;
    and ``'fused_layer'``, where a ``FusableUpdate`` runs the whole layer
    as one launch of the ``layer_fused`` kernel in one of its three
    epilogues (self term: GIN, GIN-VN, GCN; degree scalers: PNA;
    directional field: DGN) and any other fusable layer keeps the
    ``mp_pipeline`` edge phase;
  * ``fused_edge_aggregate``, GAT's in-sweep softmax (``FusableAttention``)
    included, with ``_derive_kinds`` for the statistics derived from the
    kernels' raw accumulators (mean / var / std, empty max / min at 0);
  * the aggregation unit: ``segment_aggregate`` for every kind of
    ``AGG_KINDS``, ``segment_multi_aggregate`` (the single-pass stacked
    moment sweep, max and min one sweep each; one kernel launch for all
    under ``'kernel'``), ``segment_softmax`` (three sweeps; two under
    ``'kernel'``) and ``banked_segment_sum``;
  * ``PrecomputedGraphStats`` / ``precompute_graph_stats`` for degrees,
    GCN's self-loop norm, PNA's degree scalers, DGN's directional field and
    the per-graph node counts of the readout;
  * ``DataflowConfig``, ``FusableMessage``, ``FusableAttention`` and
    ``FusableUpdate`` with the reference's field names;
  * ``count_edge_passes``: the paper's passes-over-the-edge-stream figure.
    PyTorch runs eagerly, so a pass is counted each time a sweep is issued.

Every kernel is called as an attribute of ``repro_torch.kernels.ops`` at
call time, so a caller may wrap it there.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.core.graph import GraphBatch
from repro_torch.kernels import ops as kops

# The neutral fill of a masked edge per aggregation kind.
_NEUTRAL = {
    "sum": 0.0,
    "mean": 0.0,
    "max": -float("inf"),
    "min": float("inf"),
    "std": 0.0,
    "var": 0.0,
}

# The aggregation kinds of the reference, in its order.
AGG_KINDS = tuple(_NEUTRAL)

# The multi-statistic bundle the scalers epilogue consumes, in the concat
# order PNA's update expects (Eq. 3).
PNA_STAT_KINDS = ("mean", "std", "max", "min")


# ---------------------------------------------------------------------------
# Edge-pass accounting: each segment reduction, kernel launch or full
# per-edge rewrite of the x-dependent message stream counts as one pass.
# ---------------------------------------------------------------------------

@dataclass
class EdgePassStats:
    passes: int = 0


class _EdgePassScope(threading.local):
    """Per-thread active counter (None when no block is open)."""

    def __init__(self):
        self.active: Optional[EdgePassStats] = None


_EDGE_PASS_SCOPE = _EdgePassScope()


def _count_pass(n: int = 1) -> None:
    st = _EDGE_PASS_SCOPE.active
    if st is not None:
        st.passes += n


@contextmanager
def count_edge_passes():
    """Count edge-stream sweeps issued inside the block (this thread only).

    Nesting in one thread raises: a nested block would silently steal the
    outer block's sweeps.
    """
    if _EDGE_PASS_SCOPE.active is not None:
        raise RuntimeError(
            "count_edge_passes() does not nest: a counting block is "
            "already open in this thread")
    st = EdgePassStats()
    _EDGE_PASS_SCOPE.active = st
    try:
        yield st
    finally:
        _EDGE_PASS_SCOPE.active = None


@contextmanager
def _uncounted():
    """Suspend pass counting (one fused launch = one pass, whatever the
    plain version issues internally)."""
    st = _EDGE_PASS_SCOPE.active
    _EDGE_PASS_SCOPE.active = None
    try:
        yield
    finally:
        _EDGE_PASS_SCOPE.active = st


@dataclass(frozen=True)
class PrecomputedGraphStats:
    """Graph-level statistics computed once per forward and shared by every
    layer. Fields a model does not ask for stay None.

      degrees            (N,)     masked in-degree per destination node
      inv_sqrt_deg       (N,)     1/sqrt(degree + 1), GCN's self-loop norm
      pna_scalers        (N, 3)   PNA's [identity, amplification,
                                  attenuation] degree scalers (Eq. 3)
      dgn_weights        (E,)     DGN's normalised directional field weight
                                  per edge
      dgn_wsum           (N,)     per-destination sum of ``dgn_weights``
                                  (the layer-invariant part of |B_dx X|)
      graph_node_counts  (G_pad,) valid nodes per packed graph (mean readout)
    """

    degrees: Optional[torch.Tensor] = None
    inv_sqrt_deg: Optional[torch.Tensor] = None
    pna_scalers: Optional[torch.Tensor] = None
    dgn_weights: Optional[torch.Tensor] = None
    dgn_wsum: Optional[torch.Tensor] = None
    graph_node_counts: Optional[torch.Tensor] = None


def _seg_sum(v: torch.Tensor, index: torch.Tensor,
             num_segments: int) -> torch.Tensor:
    """Sum the rows of ``v`` into ``num_segments`` rows by ``index``."""
    out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(0, index, v)


def precompute_graph_stats(
    graph: GraphBatch,
    *,
    with_degrees: bool = True,
    with_self_loop_norm: bool = False,
    pna_delta: Optional[float] = None,
    with_dgn_field: bool = False,
    with_graph_counts: bool = False,
    degrees: Optional[torch.Tensor] = None,
) -> PrecomputedGraphStats:
    """Compute the per-graph statistics bundle (one sweep per family).

    ``pna_delta`` is PNA's normalisation constant (``cfg.avg_log_degree``).
    The sweeps over the edge stream are counted: one for the degrees, two
    for DGN's field (the |dpos| normaliser, then the weight sums).

    ``degrees`` (N,) skips the degree sweep and its count: wide placement
    (``distributed/wide.py``) injects each shard's exact *global*
    in-degrees, since halo rows have no local in-edges but their degree
    normalisers (GCN's ``inv_sqrt_deg[senders]``, PNA's scalers) must be
    the owner's. In-degrees are small integers, exact in float32, so the
    injected values equal what the owning shard's sweep gives.
    """
    n = graph.n_node_pad
    emask = graph.edge_mask
    need_deg = with_degrees or with_self_loop_norm or pna_delta is not None
    if need_deg and degrees is None:
        _count_pass()
        degrees = _seg_sum(emask.to(torch.float32), graph.receivers, n)
    elif not need_deg:
        degrees = None
    inv_sqrt_deg = torch.rsqrt(degrees + 1.0) if with_self_loop_norm else None
    pna_scalers = None
    if pna_delta is not None:
        log_deg = torch.log(degrees + 1.0)
        pna_scalers = torch.stack([
            torch.ones_like(log_deg),
            log_deg / pna_delta,
            pna_delta / torch.clamp(log_deg, min=1e-3),
        ], dim=-1)
    dgn_weights = dgn_wsum = None
    if with_dgn_field:
        pos = graph.node_pos[:, 0]
        dpos = pos[graph.senders] - pos[graph.receivers]
        _count_pass()
        absnorm = _seg_sum(torch.where(emask, dpos.abs(), 0.0),
                           graph.receivers, n)
        dgn_weights = dpos / torch.clamp(absnorm[graph.receivers], min=1e-6)
        _count_pass()
        dgn_wsum = _seg_sum(torch.where(emask, dgn_weights, 0.0),
                            graph.receivers, n)
    graph_node_counts = None
    if with_graph_counts:
        # node-stream sweep (not an edge pass): valid nodes per packed graph
        graph_node_counts = _seg_sum(graph.node_mask.to(torch.float32),
                                     graph.graph_ids, graph.n_graph_pad)
    return PrecomputedGraphStats(
        degrees=degrees, inv_sqrt_deg=inv_sqrt_deg, pna_scalers=pna_scalers,
        dgn_weights=dgn_weights, dgn_wsum=dgn_wsum,
        graph_node_counts=graph_node_counts)


@dataclass(frozen=True)
class DataflowConfig:
    """The reference's dataflow knobs, with its field names and defaults.

    ``impl`` selects the layer implementation (see ``propagate``): the
    plain arms ``'fused'``, ``'twopass'``, ``'unfused'`` and ``'banked'``,
    ``'kernel'`` (one ``mp_scatter`` / ``mp_scatter_multi`` /
    ``seg_softmax`` launch per aggregation), ``'pipeline'`` (one
    ``mp_pipeline`` launch per fusable edge phase) and ``'fused_layer'``
    (one ``layer_fused`` launch per layer with a ``FusableUpdate``, else
    the ``mp_pipeline`` edge phase). ``single_pass`` picks the multi-kind
    aggregation of the arms that materialise the message: one multi-kind
    sweep (True) or one sweep family per kind (False).
    ``scan_layers`` is accepted for parity and means a plain Python loop
    over the layers either way. The tile knobs (``node_tile``,
    ``num_banks``, ``apply_tile``, ``scatter_tile``, ``edge_tile``) describe
    the TPU kernels' grids; they are still accepted and change nothing on
    the card. ``rows_per_block`` is their CUDA counterpart: how many
    destination rows one block of each GNN kernel owns (``layer_fused``,
    ``mp_pipeline``, ``mp_scatter``, ``mp_scatter_multi``,
    ``seg_softmax``), ``None`` letting each kernel pick its own launch
    shape. Outputs are bitwise the same for any value; the engine's
    autotune varies it per bucket.
    """

    node_tile: int = 8
    num_banks: int = 4
    apply_tile: int = 128
    scatter_tile: int = 128
    edge_tile: int = 128
    # twopass | unfused | fused | banked | kernel | pipeline | fused_layer
    impl: str = "fused"
    single_pass: bool = True
    scan_layers: bool = True
    rows_per_block: Optional[int] = None

    def replace(self, **kw) -> "DataflowConfig":
        import dataclasses
        return dataclasses.replace(self, **kw)


DEFAULT_DATAFLOW = DataflowConfig()


@dataclass(frozen=True)
class FusableAttention:
    """GAT's edge softmax, folded into the ``mp_pipeline`` sweep:

        logit_e = leaky_relu( src_logits[senders[e]]
                              + dst_logits[receivers[e]], slope )   # (H,)
        weight  = softmax over each destination's incoming edges, per head

      src_logits  (N, H)  per-node source attention half
      dst_logits  (N, H)  per-node destination attention half
      slope       float   leaky_relu negative slope (GAT uses 0.2)
    """

    src_logits: torch.Tensor
    dst_logits: torch.Tensor
    slope: float = 0.2


@dataclass(frozen=True)
class FusableMessage:
    """A phi the fused kernels apply in-register:

        phi_e = act( node_input[senders[e]] * src_weight[e]
                     + edge_term[e] + bias )

      node_input  (N, D)   gather buffer (defaults to ``x``)
      src_weight  (E,), (E, D) or (E, H)  per-edge weight on the gathered row
      edge_term   (E, D)   additive per-edge term (edge embeddings)
      bias        (D,)     additive bias
      activation  'none' | 'relu'
      attention   ``FusableAttention``: the in-sweep softmax weighting of
                  phi (GAT); aggregation ``('sum',)`` only, and not with
                  ``src_weight``
    """

    node_input: Optional[torch.Tensor] = None
    src_weight: Optional[torch.Tensor] = None
    edge_term: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    activation: str = "none"
    attention: Optional[FusableAttention] = None


@dataclass(frozen=True)
class FusableUpdate:
    """A gamma the ``layer_fused`` kernel runs in its epilogue, in one of
    three forms. The self term (GIN, GIN-VN, GCN):

        x' = act_out( mlp( m + self_coeff * x ) )

    the degree scalers (``scalers`` set; PNA's Eq. 3), with ``m`` the four
    statistics ``PNA_STAT_KINDS`` derived from the kernel's accumulators:

        x' = act_out( mlp( concat(x, s_0 * m, ..., s_{S-1} * m) ) )

    and the directional field (``field_wsum`` set; DGN), over the stacked
    [x | x·w] gather buffer of width 2·D_x:

        x' = act_out( mlp( concat(x, s1[:, :D_x] / deg,
                                  |s1[:, D_x:] - x * field_wsum|) ) )

      self_coeff  scalar tensor or (N,)  weight on the self term (None drops
                                        it): GIN's 1+eps, GCN's self-loop norm
      scalers     (N, S)    per-node degree scalers; the aggregation kinds
                            must be ``PNA_STAT_KINDS`` and ``stats.degrees``
                            present
      field_wsum  (N,)      per-destination field-weight sums; the kinds
                            must be ('sum', 'mean'), ``stats.degrees``
                            present and the phi must gather ``node_input``
      w1, b1      (D_in, D_ff), (D_ff,)  first dense layer: D_in = D (self),
                            D_x + S·4·D (scalers) or 3·D_x (field)
      w2, b2      (D_ff, D_out), (D_out,)  optional second layer, ReLU between
      out_activation  'none' | 'relu'
    """

    w1: torch.Tensor
    b1: torch.Tensor
    self_coeff: Optional[Union[torch.Tensor, float]] = None
    scalers: Optional[torch.Tensor] = None
    field_wsum: Optional[torch.Tensor] = None
    w2: Optional[torch.Tensor] = None
    b2: Optional[torch.Tensor] = None
    out_activation: str = "none"


# ---------------------------------------------------------------------------
# The plain aggregation unit over raw COO destinations
# ---------------------------------------------------------------------------

def _masked(msg: torch.Tensor, edge_mask: torch.Tensor,
            kind: str) -> torch.Tensor:
    m = edge_mask[:, None] if msg.ndim == 2 else edge_mask
    return torch.where(m, msg, _NEUTRAL[kind])


def _seg_extreme(v: torch.Tensor, index: torch.Tensor, num_segments: int,
                 reduce: str) -> torch.Tensor:
    """Segment max (``reduce='amax'``) or min (``'amin'``) of the rows of
    ``v``; segments no row reaches hold -inf / +inf."""
    fill = _NEUTRAL["max" if reduce == "amax" else "min"]
    out = torch.full((num_segments,) + tuple(v.shape[1:]), fill,
                     dtype=v.dtype, device=v.device)
    idx = index if v.ndim == 1 else index[:, None].expand_as(v)
    return out.scatter_reduce(0, idx, v, reduce, include_self=False)


def segment_aggregate(msg: torch.Tensor, receivers: torch.Tensor,
                      num_nodes: int, *, kind: str = "sum",
                      edge_mask: Optional[torch.Tensor] = None,
                      dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                      degrees: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Aggregate per-edge messages ``msg`` (E, D) into per-node rows (N, D)
    by ``kind``; masked edges contribute nothing and empty destinations
    give 0. Works on raw (unsorted) COO.

    mean / var / std divide by ``degrees`` (masked in-degrees) when given,
    else by a count swept here. Under ``impl='kernel'`` a sum is one
    ``mp_scatter`` launch and every other kind one ``mp_scatter_multi``
    launch (through ``segment_multi_aggregate``); under ``'banked'`` a sum
    is ``banked_segment_sum``.
    """
    if kind not in AGG_KINDS:
        raise ValueError(f"unknown aggregation '{kind}'")
    if edge_mask is None:
        edge_mask = torch.ones(msg.shape[0], dtype=torch.bool,
                               device=msg.device)
    if dataflow.impl in ("kernel", "banked") and kind == "sum":
        _count_pass()
        if dataflow.impl == "kernel":
            return kops.mp_scatter(
                msg, receivers, edge_mask, num_nodes,
                node_tile=dataflow.node_tile, edge_tile=dataflow.edge_tile,
                num_banks=dataflow.num_banks,
                rows_per_block=dataflow.rows_per_block)
        return banked_segment_sum(msg, receivers, num_nodes,
                                  num_banks=dataflow.num_banks,
                                  edge_mask=edge_mask)
    if dataflow.impl == "kernel":
        return segment_multi_aggregate(
            msg, receivers, num_nodes, kinds=(kind,), edge_mask=edge_mask,
            dataflow=dataflow, degrees=degrees)[kind]
    msgm = _masked(msg, edge_mask, kind)
    if kind == "sum":
        _count_pass()
        return _seg_sum(msgm, receivers, num_nodes)
    if kind in ("max", "min"):
        _count_pass()
        out = _seg_extreme(msgm, receivers, num_nodes,
                           "amax" if kind == "max" else "amin")
        return torch.where(torch.isfinite(out), out, 0.0)

    # mean / var / std need degrees
    if degrees is None:
        _count_pass()
        degrees = _seg_sum(edge_mask.to(msg.dtype), receivers, num_nodes)
    denom = torch.clamp(degrees, min=1.0)[:, None]
    _count_pass()
    s1 = _seg_sum(msgm, receivers, num_nodes)
    mean = s1 / denom
    if kind == "mean":
        return mean
    _count_pass()
    s2 = _seg_sum(msgm * msgm, receivers, num_nodes)
    var = torch.clamp(s2 / denom - mean * mean, min=0.0)
    if kind == "var":
        return var
    return torch.sqrt(var + 1e-5)


def segment_multi_aggregate(msg: torch.Tensor, receivers: torch.Tensor,
                            num_nodes: int, *, kinds: Sequence[str],
                            edge_mask: Optional[torch.Tensor] = None,
                            dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                            degrees: Optional[torch.Tensor] = None
                            ) -> Dict[str, torch.Tensor]:
    """All requested statistics with one sweep for the moments.

    The moment statistics are stacked into one widened sum,
    ``[msg | msg*msg | 1 1] -> [s1 | s2 | count]``, and mean / var / std
    derived from it (``_derive_kinds``); max and min take one sweep each.
    Masked edges go to an extra segment past the last row, which is then
    dropped (under ``'banked'`` they are zeroed and the sum is
    ``banked_segment_sum``). Under ``impl='kernel'`` every statistic comes
    out of one ``mp_scatter_multi`` launch. Accumulates in float32 and
    returns ``{kind: (N, D)}`` in ``msg.dtype``; ``degrees`` (masked
    in-degrees) replaces the count.
    """
    kinds = tuple(kinds)
    if not kinds:
        raise ValueError("kinds must be non-empty")
    for k in kinds:
        if k not in AGG_KINDS:
            raise ValueError(f"unknown aggregation '{k}'")
    if msg.ndim != 2:
        raise ValueError(f"segment_multi_aggregate expects 2-D messages, "
                         f"got {tuple(msg.shape)}")
    if edge_mask is None:
        edge_mask = torch.ones(msg.shape[0], dtype=torch.bool,
                               device=msg.device)
    want_moments = any(k in ("mean", "var", "std") for k in kinds)
    want_sumsq = any(k in ("var", "std") for k in kinds)
    need_count = want_moments and degrees is None
    if dataflow.impl == "kernel":
        got = kops.mp_scatter_multi(
            msg, receivers, edge_mask, num_nodes,
            want_sum="sum" in kinds or want_moments, want_sumsq=want_sumsq,
            want_count=need_count, want_max="max" in kinds,
            want_min="min" in kinds, node_tile=dataflow.node_tile,
            edge_tile=dataflow.edge_tile, num_banks=dataflow.num_banks,
            rows_per_block=dataflow.rows_per_block)
        _count_pass()                  # one edge stream, all statistics
        s1, s2 = got.get("sum"), got.get("sumsq")
        cnt = got["count"][:, 0] if need_count else None
        mx, mn = got.get("max"), got.get("min")
    else:
        s1, s2, cnt, mx, mn = _plain_multi(
            msg, receivers, num_nodes, kinds, edge_mask, dataflow,
            want_moments=want_moments, want_sumsq=want_sumsq,
            need_count=need_count)
    deg = degrees if degrees is not None else cnt
    return _derive_kinds(
        kinds, s1=s1, s2=s2, deg=deg, mx=mx, mn=mn,
        mx_valid=None if mx is None else torch.isfinite(mx),
        mn_valid=None if mn is None else torch.isfinite(mn),
        out_dtype=msg.dtype)


def _plain_multi(msg, receivers, num_nodes, kinds, edge_mask, dataflow, *,
                 want_moments, want_sumsq, need_count):
    """The raw accumulators of ``segment_multi_aggregate``'s plain arms:
    (s1, s2, count, max, min), each None when not asked for."""
    msgf = msg.to(torch.float32)
    banked = dataflow.impl == "banked"
    if banked:
        # banks route edges by their bank-local row; masked edges are zeroed
        recv_m, n_seg = receivers, num_nodes
        msgf = torch.where(edge_mask[:, None], msgf, 0.0)
    else:
        # masked edges land in segment num_nodes, dropped below
        recv_m = torch.where(edge_mask, receivers, num_nodes)
        n_seg = num_nodes + 1
    parts = {}
    if "sum" in kinds or want_moments:
        parts["s1"] = msgf
    if want_sumsq:
        parts["s2"] = msgf * msgf
    if need_count:
        # two count columns keep the stacked width even, as the reference
        parts["cnt"] = torch.ones((msg.shape[0], 2), dtype=torch.float32,
                                  device=msg.device)
    got = {}
    if parts:
        stacked = torch.cat(list(parts.values()), dim=-1)
        if banked:
            agg = banked_segment_sum(stacked, recv_m, num_nodes,
                                     num_banks=dataflow.num_banks,
                                     edge_mask=edge_mask)
        else:
            agg = _seg_sum(stacked, recv_m, n_seg)[:num_nodes]
        _count_pass()                  # the single moment sweep
        got = dict(zip(parts, torch.split(
            agg, [p.shape[1] for p in parts.values()], dim=-1)))
    ext = {}
    for kind, reduce in (("max", "amax"), ("min", "amin")):
        if kind in kinds:
            _count_pass()
            v = _masked(msgf, edge_mask, kind) if banked else msgf
            ext[kind] = _seg_extreme(v, recv_m, n_seg, reduce)[:num_nodes]
    cnt = got["cnt"][:, 0] if need_count else None
    return got.get("s1"), got.get("s2"), cnt, ext.get("max"), ext.get("min")


def banked_segment_sum(msg: torch.Tensor, receivers: torch.Tensor,
                       num_nodes: int, *, num_banks: int,
                       edge_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The dest-banked MP-unit layout: destination rows split into
    ``num_banks`` contiguous banks, each summing only the unmasked edges it
    owns into its own rows (the reference's kernel oracle). ``msg`` is
    (E, D), or (E,) and then the result is (N,). Raises ``ValueError`` when
    ``num_nodes`` does not divide into the banks."""
    if msg.ndim not in (1, 2):
        raise ValueError(f"banked_segment_sum expects (E,) or (E, D) "
                         f"messages, got shape {tuple(msg.shape)}")
    squeeze = msg.ndim == 1
    if squeeze:
        msg = msg[:, None]
    if edge_mask is None:
        edge_mask = torch.ones(msg.shape[0], dtype=torch.bool,
                               device=msg.device)
    if num_nodes % num_banks != 0:
        raise ValueError("num_nodes must divide into banks (pad the batch)")
    bank = num_nodes // num_banks
    msgm = torch.where(edge_mask[:, None], msg, 0.0)
    banks = []
    for b in range(num_banks):
        local = receivers - b * bank
        own = (local >= 0) & (local < bank) & edge_mask
        banks.append(_seg_sum(torch.where(own[:, None], msgm, 0.0),
                              torch.clamp(local, 0, bank - 1), bank))
    out = torch.cat(banks, dim=0)
    return out[:, 0] if squeeze else out


def segment_softmax(logits: torch.Tensor, receivers: torch.Tensor,
                    num_nodes: int, *,
                    edge_mask: Optional[torch.Tensor] = None,
                    dataflow: Optional[DataflowConfig] = None
                    ) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT attention weights).

    logits: (E,) or (E, H); returns normalised weights of the same shape,
    0 for masked edges. Three sweeps (segment max, segment sum of the
    exponentials, the normalising gathers), counted as three passes; under
    ``impl='kernel'`` the one launch of ``seg_softmax`` (statistics, then
    the weights), counted as two passes, as the reference counts its two
    kernels.
    """
    if edge_mask is None:
        edge_mask = torch.ones(logits.shape[0], dtype=torch.bool,
                               device=logits.device)
    if dataflow is not None and dataflow.impl == "kernel":
        _count_pass(2)
        return kops.seg_softmax(logits, receivers, edge_mask, num_nodes,
                                edge_tile=dataflow.edge_tile,
                                num_banks=dataflow.num_banks,
                                rows_per_block=dataflow.rows_per_block)
    m = edge_mask if logits.ndim == 1 else edge_mask[:, None]
    neg = torch.where(m, logits, -torch.inf)
    _count_pass()
    seg_max = _seg_extreme(neg, receivers, num_nodes, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = torch.where(m, logits - seg_max[receivers], -torch.inf)
    e = torch.where(m, torch.exp(shifted), 0.0)
    _count_pass()
    denom = torch.clamp(_seg_sum(e, receivers, num_nodes), min=1e-16)
    _count_pass()
    return e / denom[receivers]


def fused_edge_aggregate(
    graph: GraphBatch,
    x: torch.Tensor,
    fusable: FusableMessage,
    *,
    kinds: Sequence[str],
    dataflow: DataflowConfig = DEFAULT_DATAFLOW,
    stats: Optional[PrecomputedGraphStats] = None,
) -> Dict[str, torch.Tensor]:
    """The fused gather-phi-scatter edge phase: one pass, no (E, D) buffer.

    One ``mp_pipeline`` launch on the card (its plain version for CPU
    tensors), at ``dataflow.rows_per_block``; the requested kinds are
    derived from its raw accumulators. Returns ``{kind: (N, D) tensor}``.
    """
    kinds = tuple(kinds)
    if not kinds:
        raise ValueError("kinds must be non-empty")
    for k in kinds:
        if k not in AGG_KINDS:
            raise ValueError(f"unknown aggregation '{k}'")
    if fusable.attention is not None:
        if kinds != ("sum",):
            raise ValueError(
                f"attention-fused aggregation requires kinds=('sum',), "
                f"got {kinds}")
        if fusable.src_weight is not None:
            raise ValueError(
                "attention and src_weight are mutually exclusive")
    y = x if fusable.node_input is None else fusable.node_input
    degrees = stats.degrees if stats is not None else None
    _count_pass()                 # the whole edge phase is one launch
    with _uncounted():
        return _pipeline_kernel_stats(graph, y, fusable, kinds, degrees,
                                      y.dtype, dataflow.rows_per_block)


def _pipeline_kernel_stats(graph, y, fusable, kinds, degrees, out_dtype,
                           rows_per_block) -> Dict[str, torch.Tensor]:
    """Run mp_pipeline and derive the requested kinds from its raw
    accumulators."""
    from repro_torch.kernels.mp_pipeline import BIG

    want_moments = any(k in ("mean", "var", "std") for k in kinds)
    want = {
        "sum": "sum" in kinds or want_moments,
        "sumsq": any(k in ("var", "std") for k in kinds),
        "max": "max" in kinds,
        "min": "min" in kinds,
        # count doubles as empty-destination validity for max/min when no
        # precomputed degrees are shared
        "count": degrees is None and (want_moments or "max" in kinds
                                      or "min" in kinds),
    }
    att = fusable.attention
    raw = kops.mp_pipeline(
        y, graph.senders, graph.receivers, graph.edge_mask,
        graph.n_node_pad, stats=tuple(s for s, w in want.items() if w),
        src_weight=fusable.src_weight, edge_term=fusable.edge_term,
        bias=fusable.bias, activation=fusable.activation,
        att_src=None if att is None else att.src_logits,
        att_dst=None if att is None else att.dst_logits,
        att_slope=0.2 if att is None else att.slope,
        rows_per_block=rows_per_block)
    deg = degrees if degrees is not None else raw.get("count")
    if deg is not None and deg.ndim == 2:
        deg = deg[:, 0]
    mx, mn = raw.get("max"), raw.get("min")
    # keyed accumulators are finite: empty destinations sit at the -+BIG
    # neutral and validity comes from the count/degrees stream
    nonempty = None if deg is None else (deg > 0)[:, None]
    return _derive_kinds(
        kinds, s1=raw.get("sum"), s2=raw.get("sumsq"), deg=deg, mx=mx, mn=mn,
        mx_valid=None if mx is None else nonempty & (mx > -BIG),
        mn_valid=None if mn is None else nonempty & (mn < BIG),
        out_dtype=out_dtype)


def _derive_kinds(kinds, *, s1, s2, deg, mx, mn, mx_valid, mn_valid,
                  out_dtype) -> Dict[str, torch.Tensor]:
    """Derive the requested statistics from raw f32 accumulators: the
    reference's moment algebra (mean/var/std epsilon) and its
    empty-destination rule (``mx_valid`` / ``mn_valid`` false gives 0)."""
    out: Dict[str, torch.Tensor] = {}
    if any(k in ("mean", "var", "std") for k in kinds):
        rdenom = (1.0 / torch.clamp(deg, min=1.0).to(torch.float32))[:, None]
        mean = s1 * rdenom
    if any(k in ("var", "std") for k in kinds):
        var = torch.clamp(s2 * rdenom - mean * mean, min=0.0)
    for k in kinds:
        if k == "sum":
            out[k] = s1.to(out_dtype)
        elif k == "mean":
            out[k] = mean.to(out_dtype)
        elif k == "var":
            out[k] = var.to(out_dtype)
        elif k == "std":
            out[k] = torch.sqrt(var + 1e-5).to(out_dtype)
        elif k == "max":
            out[k] = torch.where(mx_valid, mx, 0.0).to(out_dtype)
        elif k == "min":
            out[k] = torch.where(mn_valid, mn, 0.0).to(out_dtype)
    return out


def propagate(
    graph: GraphBatch,
    x: torch.Tensor,
    *,
    message_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                         torch.Tensor],
    update_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    aggregate: Union[str, Sequence[str]] = "sum",
    edge_feat: Optional[torch.Tensor] = None,
    dataflow: DataflowConfig = DEFAULT_DATAFLOW,
    stats: Optional[PrecomputedGraphStats] = None,
    fusable: Optional[FusableMessage] = None,
    fusable_update: Optional[FusableUpdate] = None,
) -> torch.Tensor:
    """One message-passing layer.

    message_fn(x_src, x_dst, e)  -> (E, D)      # phi
    aggregate                    -> kind(s)     # A
    update_fn(x, m)              -> (N, D_out)  # gamma

    With a ``FusableMessage`` under ``impl='pipeline'`` the edge phase is
    one ``mp_pipeline`` launch (``fused_edge_aggregate``), then
    ``update_fn``. Under ``impl='fused_layer'`` a ``FusableUpdate`` makes
    the whole layer one ``layer_fused`` launch, under the reference's
    guards: the self form with kinds ('sum',) and no attention, the
    scalers form with ``PNA_STAT_KINDS`` and shared degrees, the field
    form with ('sum', 'mean'), shared degrees and a ``node_input``. Any
    other fusable layer keeps the ``mp_pipeline`` edge phase. Each is its
    plain PyTorch version for CPU tensors. Without a fusable description,
    or under any other impl, the gather / phi / aggregation / update
    sequence runs; several kinds go through ``segment_multi_aggregate``
    (``single_pass``) or one ``segment_aggregate`` each, which launch the
    scatter kernels under ``'kernel'`` and bank the sums under
    ``'banked'``. ``'twopass'`` and ``'unfused'`` are this sequence as it
    is: PyTorch runs eagerly, so the (E, D) message is materialised before
    the aggregation under every impl here, which is all the reference's
    ``twopass`` barrier forces. All end with the ``node_mask`` gate.
    """
    kinds = (aggregate,) if isinstance(aggregate, str) else tuple(aggregate)
    if dataflow.impl in ("pipeline", "fused_layer") and fusable is not None:
        fu = fusable_update
        if _one_launch_layer(dataflow, fusable, fu, kinds, stats):
            _count_pass()                 # the whole layer is one launch
            with _uncounted():
                out = kops.layer_fused(
                    x, graph.senders, graph.receivers, graph.edge_mask,
                    graph.n_node_pad, w1=fu.w1, b1=fu.b1,
                    node_input=fusable.node_input,
                    src_weight=fusable.src_weight,
                    edge_term=fusable.edge_term, phi_bias=fusable.bias,
                    phi_activation=fusable.activation,
                    self_coeff=fu.self_coeff, scalers=fu.scalers,
                    field_wsum=fu.field_wsum,
                    degrees=(None if fu.scalers is None
                             and fu.field_wsum is None else stats.degrees),
                    w2=fu.w2, b2=fu.b2, out_activation=fu.out_activation,
                    rows_per_block=dataflow.rows_per_block)
            return torch.where(graph.node_mask[:, None], out, 0.0)
        agg = fused_edge_aggregate(graph, x, fusable, kinds=kinds,
                                   dataflow=dataflow, stats=stats)
        m = (agg[kinds[0]] if len(kinds) == 1 else
             torch.cat([agg[k] for k in kinds], dim=-1))
        out = update_fn(x, m)
        return torch.where(graph.node_mask[:, None], out, 0.0)
    ef = graph.edge_feat if edge_feat is None else edge_feat
    src = x[graph.senders]
    dst = x[graph.receivers]
    msg = message_fn(src, dst, ef)
    _count_pass()                 # the gather + phi (E, D) message rewrite
    degrees = stats.degrees if stats is not None else None
    if len(kinds) == 1:
        m = segment_aggregate(msg, graph.receivers, graph.n_node_pad,
                              kind=kinds[0], edge_mask=graph.edge_mask,
                              dataflow=dataflow, degrees=degrees)
    elif dataflow.single_pass:
        agg = segment_multi_aggregate(
            msg, graph.receivers, graph.n_node_pad, kinds=kinds,
            edge_mask=graph.edge_mask, dataflow=dataflow, degrees=degrees)
        m = torch.cat([agg[k] for k in kinds], dim=-1)
    else:
        # one sweep family per kind (the reference's Fig. 9 ablation)
        m = torch.cat([
            segment_aggregate(msg, graph.receivers, graph.n_node_pad,
                              kind=k, edge_mask=graph.edge_mask,
                              dataflow=dataflow, degrees=degrees)
            for k in kinds], dim=-1)
    out = update_fn(x, m)
    return torch.where(graph.node_mask[:, None], out, 0.0)


def _one_launch_layer(dataflow: DataflowConfig, fusable: FusableMessage,
                      fu: Optional[FusableUpdate], kinds,
                      stats: Optional[PrecomputedGraphStats]) -> bool:
    """Whether ``propagate`` runs the layer as one ``layer_fused`` launch:
    the guards of the reference's three ``fused_layer`` arms."""
    if dataflow.impl != "fused_layer" or fu is None:
        return False
    has_degrees = stats is not None and stats.degrees is not None
    if fu.scalers is not None:
        return kinds == PNA_STAT_KINDS and has_degrees
    if fu.field_wsum is not None:
        return (kinds == ("sum", "mean") and has_degrees
                and fusable.node_input is not None)
    return kinds == ("sum",) and fusable.attention is None


def global_pool(graph: GraphBatch, x: torch.Tensor, *, kind: str = "mean",
                stats: Optional[PrecomputedGraphStats] = None
                ) -> torch.Tensor:
    """Graph-level readout: pool node rows per packed graph, (G_pad, D)."""
    xm = torch.where(graph.node_mask[:, None], x, 0.0)
    s = _seg_sum(xm, graph.graph_ids, graph.n_graph_pad)
    if kind == "sum":
        return s
    if stats is not None and stats.graph_node_counts is not None:
        cnt = stats.graph_node_counts.to(x.dtype)
    else:
        cnt = _seg_sum(graph.node_mask.to(x.dtype), graph.graph_ids,
                       graph.n_graph_pad)
    return s / torch.clamp(cnt, min=1.0)[:, None]
