"""Multi-tenant batch scheduler: named priority queues over ``GraphPacker``.

The twin of ``repro/core/scheduler.py``. FlowGNN's frontend is a bank of
independent queues draining into parallel processing elements with no
global synchronization; this module is the queue bank, the scheduling half
of the serving stack (the processing elements are ``core/executor.py``).

  * Each **tenant queue** (``QueueConfig``) owns its own ``GraphPacker``
    with its own ``max_wait`` deadline, batch-size budget and a
    weighted-fair *weight*: a latency-sensitive queue can flush at 1 ms /
    max_batch 2 while a bulk queue packs 10 ms / max_batch 64 batches,
    against the same bucket table (so programs are shared wherever
    ``graph_pad`` agrees).
  * **Weighted-fair draining.** Flushed batches wait in per-queue ready
    lists; ``next_batch`` pops from the ready queue with the smallest
    *virtual time* and advances it by ``num_graphs / weight`` (start-time
    weighted fair queueing). A bulk tenant with a deep backlog cannot
    starve a latency tenant. Queues that go idle re-enter floored to the
    system virtual time: no banked credit bursts, and no stale-low virtual
    time monopolizing service after a long idle spell.

Like ``GraphPacker``, the scheduler is free of threads, clocks and device
code: the engine owns time (``now`` flows into ``add``/``poll``) and owns
the lock under which every method is called.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.errors import UnknownQueue
from repro_torch.core.packing import (DEFAULT_BUCKETS, GraphPacker,
                                      PackedBatch, PackItem)


@dataclass(frozen=True)
class QueueConfig:
    """One tenant queue of the serving frontend.

    name       : queue handle used by ``GraphStreamEngine.submit(queue=)``.
    weight     : weighted-fair share. Draining charges each served batch
                 ``num_graphs / weight`` of virtual time, so a weight-8
                 queue gets ~8x the graph throughput of a weight-1 queue
                 while both are backlogged — and neither ever starves.
    max_wait_ms: flush deadline from a batch's FIRST graph arrival
                 (``None`` inherits the engine default).
    max_batch  : graphs per packed batch == the flushed ``graph_pad``
                 (``None`` inherits the engine default; queues sharing a
                 ``max_batch`` share compiled programs).
    max_nodes / max_edges : per-open-batch capacity overrides.
    max_pending: admission backpressure for THIS tenant — ``submit``
                 blocks once this many of its graphs are outstanding
                 (``None`` inherits the engine default). Admission is
                 per-queue, so a bulk tenant pinned at its cap never
                 blocks a latency tenant's submissions.
    priority   : a latency tenant. While a priority queue has work waiting
                 (or arrived within the preempt horizon), popped batches of
                 NON-priority queues are split down to the preempt chunk.
                 The served head re-buckets to its own content — its device
                 quantum is proportional to the chunk, not the parent batch
                 — while the remainder re-enters its packer pinned to the
                 sealed bucket (no recompile once the window closes). Both
                 sides stay bitwise-stable under the §2 pad-parity
                 contract, and the priority tenant's p99 is bounded by a
                 chunk's device time, not a full bulk batch's.
    """

    name: str
    weight: float = 1.0
    max_wait_ms: Optional[float] = None
    max_batch: Optional[int] = None
    max_nodes: Optional[int] = None
    max_edges: Optional[int] = None
    max_pending: Optional[int] = None
    priority: bool = False

    def __post_init__(self):
        if not self.name:
            raise ValueError("queue name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"queue '{self.name}' weight must be > 0")


class _TenantQueue:
    __slots__ = ("cfg", "packer", "ready", "vtime")

    def __init__(self, cfg: QueueConfig, packer: GraphPacker):
        self.cfg = cfg
        self.packer = packer
        self.ready: List[PackedBatch] = []
        self.vtime = 0.0


class BatchScheduler:
    """Named multi-tenant queues with weighted-fair draining.

    All methods must be called under one external lock (the engine's
    condition variable); nothing here blocks or sleeps.
    """

    def __init__(self, queues: Sequence[QueueConfig], *,
                 default_max_batch: int = 8,
                 default_max_wait_s: float = 2e-3,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 default_max_nodes: Optional[int] = None,
                 default_max_edges: Optional[int] = None,
                 preempt_chunk: Optional[int] = None,
                 preempt_horizon_s: float = 0.0):
        if not queues:
            raise ValueError("at least one queue is required")
        if preempt_chunk is not None and preempt_chunk < 1:
            raise ValueError("preempt_chunk must be >= 1")
        # priority preemption (DESIGN.md §5): while a priority tenant has
        # work waiting — or submitted within the last ``preempt_horizon_s``
        # — a popped non-priority batch is served only ``preempt_chunk``
        # graphs at a time. The served head re-buckets to its own content
        # (a chunk must COST a chunk — at the parent's pads it would cost
        # a full batch of device time); the remainder readmits to its
        # packer pinned to the sealed bucket, so when the window closes
        # the leftover dispatches on the already-compiled parent program.
        # ``None`` disables splitting entirely.
        self._preempt_chunk = preempt_chunk
        self._buckets = tuple(buckets)
        self._preempt_horizon_s = max(0.0, preempt_horizon_s)
        self._preempt_until = float("-inf")
        self.preempt_splits = 0        # batches split (engine stats mirror)
        self.preempted_graphs = 0      # graphs deferred by those splits
        # system virtual time: the virtual start time of the last service.
        # Re-entering queues are floored to it, so a long-idle tenant can
        # neither bank credit NOR keep a stale-low vtime through a moment
        # when every other ready list happens to be empty (a min over
        # currently-ready queues would grant it an unbounded catch-up
        # window against a busy-but-momentarily-drained tenant).
        self._vsys = 0.0
        self._queues: Dict[str, _TenantQueue] = {}
        for qc in queues:
            if qc.name in self._queues:
                raise ValueError(f"duplicate queue name '{qc.name}'")
            max_batch = (qc.max_batch if qc.max_batch is not None
                         else default_max_batch)
            max_wait_s = (qc.max_wait_ms * 1e-3 if qc.max_wait_ms is not None
                          else default_max_wait_s)
            packer = GraphPacker(
                max_batch=max_batch, max_wait_s=max_wait_s, buckets=buckets,
                max_nodes=(qc.max_nodes if qc.max_nodes is not None
                           else default_max_nodes),
                max_edges=(qc.max_edges if qc.max_edges is not None
                           else default_max_edges))
            self._queues[qc.name] = _TenantQueue(qc, packer)
        self._has_priority = any(qc.priority for qc in queues)

    # -- introspection ----------------------------------------------------

    @property
    def queue_names(self) -> Tuple[str, ...]:
        return tuple(self._queues)

    @property
    def open_batches(self) -> int:
        return sum(q.packer.open_batches for q in self._queues.values())

    @property
    def ready_batches(self) -> int:
        return sum(len(q.ready) for q in self._queues.values())

    @property
    def pending_graphs(self) -> int:
        """Graphs held here (open or ready), i.e. not yet handed out."""
        return sum(q.packer.pending_graphs + sum(b.num_graphs for b in q.ready)
                   for q in self._queues.values())

    @property
    def priority_ready(self) -> bool:
        """A priority tenant has a flushed batch waiting. The placer's
        preempt gate (engine §5): while the window is open, non-priority
        claims must not stack in an executor's FIFO pipeline ahead of a
        priority batch — or the claim depth, not the preempt chunk,
        becomes the tail-latency bound."""
        return any(q.cfg.priority and q.ready for q in self._queues.values())

    def graph_pads(self) -> Tuple[int, ...]:
        """Distinct flushed ``graph_pad`` values across queues (for warmup)."""
        return tuple(sorted({q.packer.max_batch
                             for q in self._queues.values()}))

    def next_deadline(self) -> Optional[float]:
        return min((d for q in self._queues.values()
                    if (d := q.packer.next_deadline()) is not None),
                   default=None)

    # -- intake -----------------------------------------------------------

    def add(self, queue: str, item: PackItem,
            now: Optional[float] = None) -> None:
        """Route one graph into its tenant's packer; full batches become
        ready immediately."""
        q = self._queues.get(queue)
        if q is None:
            raise UnknownQueue(
                f"unknown queue '{queue}'; have {sorted(self._queues)}")
        now = time.perf_counter() if now is None else now
        if q.cfg.priority and self._preempt_chunk is not None:
            # a latency arrival opens (or extends) the preempt window: bulk
            # batches popped inside it are chunked even if this request is
            # briefly the only priority work visible
            self._preempt_until = max(self._preempt_until,
                                      now + self._preempt_horizon_s)
        self._push_ready(q, q.packer.add(item, now=now))

    def poll(self, now: Optional[float] = None) -> int:
        """Flush every open batch whose deadline expired; count them."""
        now = time.perf_counter() if now is None else now
        moved = 0
        for q in self._queues.values():
            flushed = q.packer.poll(now)
            self._push_ready(q, flushed)
            moved += len(flushed)
        return moved

    def shed(self, expired: Callable[[PackItem], bool]
             ) -> List[Tuple[str, PackItem]]:
        """Deadline shedding before dispatch (DESIGN.md §8): remove every
        held graph matching ``expired`` — from open packer batches AND
        already-flushed ready batches — and return them with their queue
        names so the engine can fail their futures. Ready batches keep
        their sealed bucket shapes (result parity for the survivors);
        emptied ones vanish without charging virtual time."""
        out: List[Tuple[str, PackItem]] = []
        for q in self._queues.values():
            for it in q.packer.shed(expired):
                out.append((q.cfg.name, it))
            kept: List[PackedBatch] = []
            for pb in q.ready:
                dead = [it for it in pb.items if expired(it)]
                if dead:
                    out.extend((q.cfg.name, it) for it in dead)
                    live = [it for it in pb.items if not expired(it)]
                    if not live:
                        continue
                    pb = pb.subset(live)
                kept.append(pb)
            q.ready = kept
        return out

    def _push_ready(self, q: _TenantQueue, batches: List[PackedBatch]) -> None:
        if not batches:
            return
        if not q.ready:
            # re-entering service: no banked credit from the idle period —
            # a queue idle for a second must not burst ahead of everyone
            q.vtime = max(q.vtime, self._vsys)
        q.ready.extend(batches)

    # -- draining ---------------------------------------------------------

    def preempt_active(self, now: float) -> bool:
        """True while non-priority pops must be chunked: a priority tenant
        has work waiting here, or submitted within the horizon (its batch
        may already be on a device — keeping bulk quanta small until the
        window closes is what bounds the NEXT priority arrival's wait)."""
        if self._preempt_chunk is None or not self._has_priority:
            return False
        if now <= self._preempt_until:
            return True
        return any(q.cfg.priority
                   and (q.ready or q.packer.pending_graphs)
                   for q in self._queues.values())

    def _maybe_preempt(self, q: _TenantQueue, pb: PackedBatch,
                       now: Optional[float]) -> PackedBatch:
        """Split a popped non-priority batch down to the preempt chunk;
        the remainder readmits to the packer pinned to the sealed bucket
        (``GraphPacker.readmit``) and re-flushes on the next poll. The
        served head re-buckets to its own content (``rebucket``): its
        device quantum is proportional to the chunk, not the parent —
        that proportionality is what bounds the priority tenant's wait.
        Virtual time is charged only for what is actually served, so
        fairness accounting is exact across the split."""
        chunk = self._preempt_chunk
        if (now is None or q.cfg.priority or chunk is None
                or not self.preempt_active(now)):
            return pb
        if pb.num_graphs <= chunk:
            # the final remainder of a split (or a small fresh seal) still
            # re-buckets: at the pinned parent pads a chunk-sized leftover
            # would cost a FULL batch's device time mid-window. Fresh small
            # seals are already content-tight, so this is a no-op for them;
            # pinned remainders popped after the window closes keep their
            # parent bucket (the no-recompile path).
            return pb.rebucket(self._buckets)
        head = pb.subset(pb.items[:chunk]).rebucket(self._buckets)
        rest = pb.subset(pb.items[chunk:])
        q.packer.readmit(rest, now=now)
        self.preempt_splits += 1
        self.preempted_graphs += rest.num_graphs
        return head

    def next_batch(self, now: Optional[float] = None
                   ) -> Optional[Tuple[str, PackedBatch]]:
        """Weighted-fair pop: the ready queue with the smallest virtual
        time serves next (ties broken by name for determinism). With
        ``now``, non-priority batches popped during an active preempt
        window are chunked (``None`` — e.g. drain — never splits)."""
        backlogged = [q for q in self._queues.values() if q.ready]
        if not backlogged:
            return None
        q = min(backlogged, key=lambda t: (t.vtime, t.cfg.name))
        pb = q.ready.pop(0)
        pb = self._maybe_preempt(q, pb, now)
        self._vsys = max(self._vsys, q.vtime)
        q.vtime += pb.num_graphs / q.cfg.weight
        return q.cfg.name, pb

    def flush_oldest_open(self, now: Optional[float] = None
                          ) -> Optional[Tuple[str, PackedBatch]]:
        """Seal + return the open batch with the earliest deadline across
        all queues (the idle-executor eager-flush path). Ready batches take
        precedence — call ``next_batch`` first. Chunked under an active
        preempt window exactly like ``next_batch``."""
        best: Optional[_TenantQueue] = None
        for q in self._queues.values():
            d = q.packer.next_deadline()
            if d is None:
                continue
            if best is None or d < best.packer.next_deadline():
                best = q
        if best is None:
            return None
        pb = best.packer.flush_oldest()
        pb = self._maybe_preempt(best, pb, now)
        best.vtime = max(best.vtime, self._vsys)
        self._vsys = max(self._vsys, best.vtime)
        best.vtime += pb.num_graphs / best.cfg.weight
        return best.cfg.name, pb

    def flush_all(self) -> List[Tuple[str, PackedBatch]]:
        """Drain/shutdown: every open AND ready batch, fair-ordered."""
        for q in self._queues.values():
            self._push_ready(q, q.packer.flush_all())
        out = []
        while (nxt := self.next_batch()) is not None:
            out.append(nxt)
        return out
