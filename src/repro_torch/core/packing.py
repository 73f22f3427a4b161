"""Adaptive graph packing for the multi-queue serving engine.

The twin of ``repro/core/packing.py``. The paper's Fig. 7 serves batch
sizes 1..1024 with one dataflow by packing arriving graphs into one padded
batch; here that is a serving-path policy:

  * ``GraphPacker`` keeps a small set of *open batches* and first-fits each
    arriving graph into the first batch with room (node budget, edge budget,
    graph-count budget). A batch is flushed — handed back to the caller as a
    ``PackedBatch`` — when it is full or when its oldest graph has waited
    longer than ``max_wait_s``.
  * Flush shapes are bucketed: ``node_pad``/``edge_pad`` come from the
    engine's bucket table (``pad_bucket``), and ``graph_pad`` is pinned to
    ``max_batch``, so the number of distinct programs (one captured CUDA
    graph each on a GPU) stays small however full each batch happens to be.
  * A batch reaches the device through ``graph_offsets``:
    ``PackedBatch.build`` pads it into a fresh ``GraphBatch``,
    ``PackedBatch.stage`` into one slot of a program's pinned
    ``BatchStaging``. Per-graph results are recovered from the slot order
    (graph-level tasks) or ``PackedBatch.node_span_of`` (node-level).

The packer is free of threads, clocks and device code: the engine owns time
(it passes ``now`` into ``poll``) and owns dispatch, so the flush policy is
testable alone.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.core.graph import (BatchStaging, GraphBatch,
                                    build_graph_batch, concat_raw_graphs,
                                    pad_bucket)

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


@dataclass
class PackItem:
    """One arriving graph plus the caller's opaque payload (e.g. a Future)."""

    node_feat: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    edge_feat: Optional[np.ndarray] = None
    node_pos: Optional[np.ndarray] = None
    payload: Any = None
    t_arrival: float = field(default_factory=time.perf_counter)

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


@dataclass
class PackedBatch:
    """A flushed batch: items in pack order plus the padded bucket shapes.

    ``attempts``/``requeues`` are the reference's retry bookkeeping, kept so
    that ``subset``/``split`` carry it; the port's engine does not retry yet.
    ``dispatch_id`` is the engine's in-flight registry key for the current
    placement.
    """

    items: List[PackItem]
    node_pad: int
    edge_pad: int
    graph_pad: int
    attempts: int = 0
    requeues: int = 0
    dispatch_id: Optional[int] = None

    @property
    def num_graphs(self) -> int:
        return len(self.items)

    @property
    def bucket(self) -> Tuple[int, int, int]:
        return (self.node_pad, self.edge_pad, self.graph_pad)

    def graph_offsets(self) -> np.ndarray:
        offs = np.zeros(len(self.items) + 1, dtype=np.int64)
        for i, it in enumerate(self.items):
            offs[i + 1] = offs[i] + it.num_nodes
        return offs

    def node_span_of(self, slot: int) -> Tuple[int, int]:
        """(start, end) node rows of graph ``slot`` inside the packed batch."""
        offs = self.graph_offsets()
        return int(offs[slot]), int(offs[slot + 1])

    def subset(self, items: List[PackItem]) -> "PackedBatch":
        """A batch holding ``items`` in the SAME bucket as this one, so that
        the bucket's program is reused and every surviving graph's output
        stays bitwise what it was (a graph's answer does not depend on its
        co-packed neighbours)."""
        sub = PackedBatch(items=list(items), node_pad=self.node_pad,
                          edge_pad=self.edge_pad, graph_pad=self.graph_pad)
        sub.attempts = self.attempts
        return sub

    def rebucket(self, buckets: Tuple[int, ...]) -> "PackedBatch":
        """Re-seal to the tightest node/edge bucket for this content.

        The preempt path serves a chunk-sized head at once; at the parent's
        pads it would cost a full batch's device time (the work scales with
        ``node_pad``), so the head re-buckets. ``graph_pad`` is kept so that
        program families stay shared.
        """
        n = sum(it.num_nodes for it in self.items)
        e = sum(it.num_edges for it in self.items)
        sub = PackedBatch(items=list(self.items),
                          node_pad=pad_bucket(max(n, 1), buckets),
                          edge_pad=pad_bucket(max(e, 1), buckets),
                          graph_pad=self.graph_pad)
        sub.attempts = self.attempts
        return sub

    def split(self) -> Tuple["PackedBatch", "PackedBatch"]:
        """Bisect into two halves in pack order; halves keep this batch's
        bucket shapes and inherit ``attempts``."""
        if self.num_graphs < 2:
            raise ValueError("cannot split a single-graph batch")
        mid = self.num_graphs // 2
        return self.subset(self.items[:mid]), self.subset(self.items[mid:])

    def build(self, *, pos_dim: int = 1,
              device: DeviceLike = None) -> GraphBatch:
        """Concatenate and pad into a ``GraphBatch`` on ``device`` (one copy
        per array: the CPU path and the eager forward)."""
        raw = concat_raw_graphs(self.items)
        return build_graph_batch(
            raw["node_feat"], raw["senders"], raw["receivers"],
            edge_feat=raw["edge_feat"], node_pad=self.node_pad,
            edge_pad=self.edge_pad, graph_offsets=raw["graph_offsets"],
            graph_pad=self.graph_pad, node_pos=raw["node_pos"],
            pos_dim=pos_dim, device=device)

    def stage(self, staging: BatchStaging, slot: int = 0) -> None:
        """Concatenate and pad into host slot ``slot`` of ``staging`` (a
        buffer of this batch's bucket), with the graphs' offsets: what a
        captured program uploads in one copy."""
        raw = concat_raw_graphs(self.items)
        staging.stage(raw["node_feat"], raw["senders"], raw["receivers"],
                      edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
                      graph_offsets=raw["graph_offsets"], slot=slot)


class _OpenBatch:
    __slots__ = ("items", "n_nodes", "n_edges", "deadline", "pinned")

    def __init__(self, deadline: float,
                 pinned: Optional[Tuple[int, int, int]] = None):
        self.items: List[PackItem] = []
        self.n_nodes = 0
        self.n_edges = 0
        self.deadline = deadline
        # a preempted remainder re-entering the packer: seal to EXACTLY
        # these (node_pad, edge_pad, graph_pad) — the parent batch's sealed
        # bucket — and accept no new items, so the bucket's program is
        # reused and survivors stay bitwise what they were
        self.pinned = pinned

    def add(self, item: PackItem) -> None:
        self.items.append(item)
        self.n_nodes += item.num_nodes
        self.n_edges += item.num_edges


class GraphPacker:
    """First-fit packing of arriving graphs into bucketed open batches.

    Parameters
    ----------
    max_batch : graphs per packed batch (== ``graph_pad`` of every flush).
    max_wait_s : deadline from a batch's FIRST graph arrival to its flush;
        the engine polls expired batches out. 0 disables waiting entirely.
    buckets : the node/edge bucket table used for flush shapes.
    max_nodes / max_edges : capacity of one open batch (defaults
        ``64 * max_batch`` and ``256 * max_batch``: small streaming graphs,
        the paper's molecule / HEP regime); a single oversized graph still
        gets its own batch.
    """

    def __init__(self, *, max_batch: int = 8, max_wait_s: float = 2e-3,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.buckets = tuple(buckets)
        self.max_nodes = (max_nodes if max_nodes is not None
                          else 64 * max_batch)
        self.max_edges = (max_edges if max_edges is not None
                          else 256 * max_batch)
        self._open: List[_OpenBatch] = []

    # -- state ------------------------------------------------------------

    @property
    def open_batches(self) -> int:
        return len(self._open)

    @property
    def pending_graphs(self) -> int:
        return sum(len(b.items) for b in self._open)

    def next_deadline(self) -> Optional[float]:
        return min((b.deadline for b in self._open), default=None)

    # -- packing ----------------------------------------------------------

    def _fits(self, b: _OpenBatch, item: PackItem) -> bool:
        return (b.pinned is None      # readmitted remainders are closed
                and len(b.items) < self.max_batch
                and b.n_nodes + item.num_nodes <= self.max_nodes
                and b.n_edges + item.num_edges <= self.max_edges)

    def _seal(self, b: _OpenBatch) -> PackedBatch:
        if b.pinned is not None:
            node_pad, edge_pad, graph_pad = b.pinned
        else:
            node_pad = pad_bucket(max(b.n_nodes, 1), self.buckets)
            edge_pad = pad_bucket(max(b.n_edges, 1), self.buckets)
            graph_pad = self.max_batch
        return PackedBatch(items=b.items, node_pad=node_pad,
                           edge_pad=edge_pad, graph_pad=graph_pad)

    def add(self, item: PackItem, now: Optional[float] = None
            ) -> List[PackedBatch]:
        """Route one graph; return any batches that became full."""
        now = time.perf_counter() if now is None else now
        target = None
        for b in self._open:                      # first fit, arrival order
            if self._fits(b, item):
                target = b
                break
        if target is None:
            target = _OpenBatch(deadline=now + self.max_wait_s)
            self._open.append(target)
        target.add(item)
        flushed = []
        # only the count budget forces an eager flush: the node/edge budgets
        # are "no further typical graph fits" heuristics, resolved lazily by
        # _fits
        if len(target.items) >= self.max_batch:
            self._open.remove(target)
            flushed.append(self._seal(target))
        return flushed

    def poll(self, now: Optional[float] = None) -> List[PackedBatch]:
        """Flush every open batch whose deadline has expired."""
        now = time.perf_counter() if now is None else now
        expired = [b for b in self._open if b.deadline <= now]
        for b in expired:
            self._open.remove(b)
        return [self._seal(b) for b in expired]

    def readmit(self, pb: PackedBatch, now: Optional[float] = None) -> None:
        """Re-enter a preempted remainder (the scheduler's preempt path).

        The remainder becomes an open batch *closed* to new items and
        *pinned* to the parent's sealed bucket. Its deadline is ``now``, so
        the next ``poll`` returns it at once: preemption reorders service,
        it never parks work. Inserted at the front so ``flush_oldest``
        favours it."""
        now = time.perf_counter() if now is None else now
        b = _OpenBatch(deadline=now, pinned=pb.bucket)
        for it in pb.items:
            b.add(it)
        self._open.insert(0, b)

    def flush_all(self) -> List[PackedBatch]:
        """Flush every open batch regardless of deadline (drain/shutdown)."""
        out = [self._seal(b) for b in self._open]
        self._open = []
        return out

    def shed(self, expired: Callable[[PackItem], bool]) -> List[PackItem]:
        """Remove (and return) every open item matching ``expired``.
        Emptied open batches are discarded; survivors keep their flush
        deadline."""
        shed: List[PackItem] = []
        for b in list(self._open):
            keep = [it for it in b.items if not expired(it)]
            if len(keep) == len(b.items):
                continue
            shed.extend(it for it in b.items if expired(it))
            if not keep:
                self._open.remove(b)
                continue
            b.items = keep
            b.n_nodes = sum(it.num_nodes for it in keep)
            b.n_edges = sum(it.num_edges for it in keep)
        return shed

    def flush_oldest(self) -> Optional[PackedBatch]:
        """Flush the batch with the earliest deadline (idle-device path)."""
        if not self._open:
            return None
        b = min(self._open, key=lambda ob: ob.deadline)
        self._open.remove(b)
        return self._seal(b)
