"""Graph containers: raw COO edge lists, padded, in arrival order.

The twin of ``repro/core/graph.py``. Graphs arrive as raw COO edge lists and
are never sorted or partitioned. Padding convention:

  * padded nodes/edges are masked out via ``node_mask`` / ``edge_mask``;
  * padded edges point at node 0 and are neutralised by the mask in every
    aggregation;
  * several small graphs may be packed into one batch; ``graph_ids`` maps
    each node to its graph for the readout.

Indices are int64 (``index_add_`` and friends want int64), converted once
when the batch is built. ``build_graph_batch`` pads into fresh arrays and
copies each to the device; ``BatchStaging`` pads into one (pinned) host
buffer and copies it whole, for the engine's captured programs. Both pad
through ``pad_graph_into``, so the two layouts cannot drift.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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

    def num_nodes(self) -> torch.Tensor:
        """The real nodes, as a 0-d int32 tensor."""
        return self.node_mask.sum(dtype=torch.int32)

    def num_edges(self) -> torch.Tensor:
        """The real edges, as a 0-d int32 tensor."""
        return self.edge_mask.sum(dtype=torch.int32)

    def in_degrees(self) -> torch.Tensor:
        """Per-node in-degree (N_pad,) float32, computed on the fly. A
        receiver outside [0, N_pad) counts nowhere, as
        ``jax.ops.segment_sum`` drops it (``index_add_`` would raise)."""
        n, rcv = self.n_node_pad, self.receivers
        keep = self.edge_mask & (rcv >= 0) & (rcv < n)
        out = torch.zeros(n, dtype=torch.float32, device=self.device)
        return out.index_add_(0, torch.where(keep, rcv, 0),
                              keep.to(torch.float32))


# the nine arrays of a GraphBatch, in the order of a staging buffer's layout
BATCH_FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_pos",
                "graph_ids", "node_mask", "edge_mask", "graph_mask")
# where each array of a staging buffer starts: a multiple of this many bytes
STAGING_ALIGN = 256


def batch_layout(node_pad: int, edge_pad: int, graph_pad: int,
                 node_width: int, edge_width: int, pos_width: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """The shape and numpy dtype of each padded array of a batch, by name
    (in ``BATCH_FIELDS`` order)."""
    f32, i64, b = np.dtype(np.float32), np.dtype(np.int64), np.dtype(bool)
    return {"node_feat": ((node_pad, node_width), f32),
            "edge_feat": ((edge_pad, edge_width), f32),
            "senders": ((edge_pad,), i64), "receivers": ((edge_pad,), i64),
            "node_pos": ((node_pad, pos_width), f32),
            "graph_ids": ((node_pad,), i64), "node_mask": ((node_pad,), b),
            "edge_mask": ((edge_pad,), b), "graph_mask": ((graph_pad,), b)}


def pad_graph_into(out: Dict[str, np.ndarray], node_feat: np.ndarray,
                   senders: np.ndarray, receivers: np.ndarray, *,
                   edge_feat: Optional[np.ndarray] = None,
                   graph_offsets: Optional[np.ndarray] = None,
                   node_pos: Optional[np.ndarray] = None) -> None:
    """Write raw COO arrays (host-side numpy) into the nine padded arrays
    ``out`` (shapes and dtypes of :func:`batch_layout`), every element of
    them: the padding rows too, so that ``out`` may hold an earlier, larger
    graph. ``edge_feat`` / ``node_pos`` left out are zeros.

    ``graph_offsets``: node-index boundaries between packed graphs,
    e.g. [0, n0, n0+n1, ...]; defaults to a single graph.
    """
    node_pad, edge_pad = out["node_feat"].shape[0], out["senders"].shape[0]
    graph_pad = out["graph_mask"].shape[0]
    n, e = node_feat.shape[0], senders.shape[0]
    if n > node_pad or e > edge_pad:
        raise ValueError(f"graph ({n} nodes, {e} edges) exceeds padding "
                         f"({node_pad}, {edge_pad})")
    if graph_offsets is None:
        graph_offsets = np.array([0, n])
    n_graphs = len(graph_offsets) - 1
    if n_graphs > graph_pad:
        raise ValueError(f"{n_graphs} graphs exceed graph_pad={graph_pad}")

    def put(name, value, count):
        a = out[name]
        a[:count] = 0 if value is None else value
        a[count:] = 0

    put("node_feat", node_feat, n)
    put("edge_feat", edge_feat, e)
    put("senders", senders, e)
    put("receivers", receivers, e)
    put("node_pos", node_pos, n)
    out["node_mask"][:n] = True
    out["node_mask"][n:] = False
    out["edge_mask"][:e] = True
    out["edge_mask"][e:] = False
    gids = out["graph_ids"]
    gids[:n] = 0
    for g in range(n_graphs):
        gids[graph_offsets[g]:graph_offsets[g + 1]] = g
    # padded nodes pool into the last (masked) graph slot if it exists, else
    # 0; node_mask keeps them out of the readout either way
    gids[n:] = min(n_graphs, graph_pad - 1)
    out["graph_mask"][:n_graphs] = True
    out["graph_mask"][n_graphs:] = False


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
    e.g. [0, n0, n0+n1, ...]; defaults to a single graph. Each array is
    padded on the host (:func:`pad_graph_into`) and copied on its own.
    """
    dev = resolve_device(device)
    layout = batch_layout(
        node_pad, edge_pad, graph_pad, node_feat.shape[1],
        1 if edge_feat is None else edge_feat.shape[1],
        pos_dim if node_pos is None else node_pos.shape[1])
    arrays = {name: np.empty(shape, dtype)
              for name, (shape, dtype) in layout.items()}
    pad_graph_into(arrays, node_feat, senders, receivers, edge_feat=edge_feat,
                   graph_offsets=graph_offsets, node_pos=node_pos)
    return GraphBatch(**{name: torch.from_numpy(a).to(dev)
                         for name, a in arrays.items()})


class BatchStaging:
    """One bucket's padded batch in ``slots`` host buffers and one device
    buffer of the same layout, so that a graph reaches the device in one
    copy.

    The nine arrays of a ``GraphBatch`` (:func:`batch_layout`) lie in each
    buffer at offsets aligned to ``STAGING_ALIGN`` bytes. ``stage`` pads a
    raw graph (or packed graphs, with their ``graph_offsets``) straight into
    numpy views of one host slot (pinned when ``pin``, as a CUDA device
    wants for an asynchronous copy); ``upload`` enqueues the one copy of a
    slot's used extent on the current stream; ``batch`` is a ``GraphBatch``
    of views into the device buffer, the same tensors every time (what a
    captured CUDA graph reads). A host slot may be written again once its
    copy has run: several slots let the host pad the next batch while the
    copy of the one before is still queued.
    """

    def __init__(self, node_pad: int, edge_pad: int, graph_pad: int,
                 widths: Tuple[int, int, int], device: DeviceLike = None, *,
                 pin: bool = False, slots: int = 1):
        dev = resolve_device(device)
        layout = batch_layout(node_pad, edge_pad, graph_pad, *widths)
        offsets, end = {}, 0
        for name, (shape, dtype) in layout.items():
            start = -(-end // STAGING_ALIGN) * STAGING_ALIGN
            offsets[name] = start
            end = start + int(np.prod(shape)) * dtype.itemsize
        self.nbytes = end
        self.hosts = [torch.empty(end, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(slots)]
        self.device_buf = torch.empty(end, dtype=torch.uint8, device=dev)
        self.slot_arrays: List[Dict[str, np.ndarray]] = [
            {} for _ in range(slots)]
        fields = {}
        for name, (shape, dtype) in layout.items():
            size = int(np.prod(shape)) * dtype.itemsize
            at = slice(offsets[name], offsets[name] + size)
            for host, arrays in zip(self.hosts, self.slot_arrays):
                arrays[name] = host.numpy()[at].view(dtype).reshape(shape)
            fields[name] = self.device_buf[at].view(
                _TORCH_DTYPES[dtype]).view(shape)
        self.batch = GraphBatch(**fields)

    def stage(self, node_feat: np.ndarray, senders: np.ndarray,
              receivers: np.ndarray, *,
              edge_feat: Optional[np.ndarray] = None,
              graph_offsets: Optional[np.ndarray] = None,
              node_pos: Optional[np.ndarray] = None, slot: int = 0) -> None:
        """Pad a raw graph into host slot ``slot`` (every byte of the
        layout's arrays is written)."""
        pad_graph_into(self.slot_arrays[slot], node_feat, senders, receivers,
                       edge_feat=edge_feat, graph_offsets=graph_offsets,
                       node_pos=node_pos)

    def upload(self, slot: int = 0) -> None:
        """Enqueue host slot ``slot``'s copy to the device buffer."""
        self.device_buf[:self.nbytes].copy_(self.hosts[slot][:self.nbytes],
                                            non_blocking=True)


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int64): torch.int64, np.dtype(bool): torch.bool}


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
