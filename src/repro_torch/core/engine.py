"""Multi-queue streaming inference engine (the serving facade), in PyTorch.

The twin of ``repro/core/engine.py``: a thin facade over the paper's
decomposition, a bank of independent queues draining into parallel
processing elements.

  * a ``BatchScheduler`` (``core/scheduler.py``): named tenant queues with
    weighted-fair draining, each over its own ``GraphPacker`` with its own
    ``max_wait`` deadline and batch budgets;
  * a ``DeviceExecutor`` pool (``core/executor.py``): one executor per
    device of ``devices``, each with its parameters on its device, its own
    per-bucket programs and its own dispatch/complete thread pair; a placer
    thread hands each flushed batch to the executor with the least backlog;
  * this facade: ``submit`` validates a graph, queues it in its tenant's
    packer and returns a ``Future`` that resolves the moment its batch
    completes (``drain`` is backpressure, not a results barrier);
    ``process`` is ``submit(...).result()``.

Each bucket ``(node_pad, edge_pad, graph_pad)`` (``graph_pad`` is the
queue's ``max_batch``) is served by one program per executor, built on the
bucket's first batch (``_ensure_program``; ``_make_run`` is the forward it
runs). On a CUDA device the program is the forward captured once in a
``torch.cuda.CUDAGraph`` (``CapturedProgram``), fed through a ring of
pinned slots; on the CPU it is the eager forward on a batch built afresh
(``EagerProgram``).

Threads. ``submit`` runs on the caller's thread and touches no device. The
placer thread pops batches from the scheduler and places them. Each
executor's dispatch thread is the only thread that enqueues work on its
stream or builds its programs; its complete thread only waits on the event
recorded after a batch's copy-out and reads the pinned output. Programs are
built one at a time (``_compile_lock``), and a build on a GPU first drains
its executor's pipe, so no thread of the executor makes a CUDA call during
the capture; the capture runs in ``thread_local`` mode, so that other
executors' threads may keep waiting on their events meanwhile.

Result parity is part of the contract: the same graph gives the same
output whichever queue it entered through and whichever executor served
it, and a graph's output does not depend on what it was packed with.

Not ported yet (ROADMAP queue 1 item 4): per-request deadlines, retries and
bisection, output validation, the watchdog and respawn (4(c)); autotune
(4(b)); defense (4(d)); drift retune and eviction (4(e)); wide placement
(item 6). A failed batch fails its futures with ``BatchFailed``
(``ExecutorDead`` when its executor died), the cause chained.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.errors import (BatchFailed, EngineClosed, EngineError,
                                     ExecutorDead, GraphTooLarge,
                                     InvalidGraph, InvalidRequest,
                                     UnknownQueue)
from repro_torch.core.executor import CompletedBatch, DeviceExecutor
from repro_torch.core.graph import BatchStaging, GraphBatch, pad_bucket
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import GNNConfig, make_gnn
from repro_torch.core.packing import PackedBatch, PackItem
from repro_torch.core.scheduler import BatchScheduler, QueueConfig
from repro_torch.core.validate import check_budget, check_graph

BucketKey = Tuple[int, int, int]        # (node_pad, edge_pad, graph_pad)
# a program's key: its bucket and the widths of node_feat, edge_feat and
# node_pos it was built for
ProgramKey = Tuple[BucketKey, Tuple[int, int, int]]

DEFAULT_QUEUE = "default"


@dataclass
class StreamStats:
    """Per-graph latency plus queue/device breakdowns.

    ``latencies_s`` / ``queue_wait_s`` have one entry per *graph*:
    ``submit`` to the answer on the host, and ``submit`` to the start of
    its batch's dispatch. ``device_s`` / ``batch_sizes`` have one entry per
    *batch*: on a GPU the span between CUDA events recorded around the
    replay of the bucket's captured graph (batches on one executor's stream
    never overlap, so spans sum without double counting); on the CPU the
    marginal host time of the forward. ``sum(batch_sizes) / sum(device_s)``
    is ``throughput_gps``, graphs per second of forward span (across a
    pool, the per-device average). ``by_queue`` / ``by_device`` hold the
    same stats sliced per tenant queue and per executor; ``aggregate_gps``
    in ``summary()`` is the pool's wall figure (graphs over the span from
    the first dispatch to the last completion). ``failed`` counts futures
    resolved with an error; ``preemptions`` counts bulk batches split by a
    priority tenant's preempt window.
    """

    latencies_s: List[float] = field(default_factory=list)
    queue_wait_s: List[float] = field(default_factory=list)
    device_s: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    t_first_dispatch: Optional[float] = None
    t_last_done: Optional[float] = None
    by_queue: Dict[str, "StreamStats"] = field(default_factory=dict)
    by_device: Dict[str, "StreamStats"] = field(default_factory=dict)
    failed: int = 0
    preemptions: int = 0

    def record_batch(self, *, latencies: Sequence[float],
                     queue_waits: Sequence[float], device_s: float,
                     batch_size: int, t_dispatch: float, t_done: float,
                     queue: Optional[str] = None,
                     device: Optional[str] = None) -> None:
        self.latencies_s.extend(latencies)
        self.queue_wait_s.extend(queue_waits)
        self.device_s.append(device_s)
        self.batch_sizes.append(batch_size)
        if self.t_first_dispatch is None or t_dispatch < self.t_first_dispatch:
            self.t_first_dispatch = t_dispatch
        if self.t_last_done is None or t_done > self.t_last_done:
            self.t_last_done = t_done
        for name, table in ((queue, self.by_queue), (device, self.by_device)):
            if name is not None:
                table.setdefault(name, StreamStats()).record_batch(
                    latencies=latencies, queue_waits=queue_waits,
                    device_s=device_s, batch_size=batch_size,
                    t_dispatch=t_dispatch, t_done=t_done)

    def record_failure(self, *, queue: Optional[str] = None,
                       failed: int = 0) -> None:
        self.failed += failed
        if queue is not None:
            self.by_queue.setdefault(queue, StreamStats()).record_failure(
                failed=failed)

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.latencies_s:
            arr = np.array(self.latencies_s)
            out.update({
                "count": float(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            })
            if self.queue_wait_s:
                qw = np.array(self.queue_wait_s)
                out["queue_wait_mean_ms"] = float(qw.mean() * 1e3)
                out["queue_wait_p99_ms"] = float(np.percentile(qw, 99) * 1e3)
            if self.device_s and sum(self.device_s) > 0:
                # graphs per second of forward span, not batches/s and not
                # inflated by per-graph queue waits
                out["device_mean_ms"] = float(np.mean(self.device_s) * 1e3)
                out["throughput_gps"] = float(
                    sum(self.batch_sizes) / sum(self.device_s))
                out["mean_batch_size"] = float(np.mean(self.batch_sizes))
            else:
                out["throughput_gps"] = float(arr.size / arr.sum())
            if (self.t_first_dispatch is not None
                    and self.t_last_done is not None
                    and self.t_last_done > self.t_first_dispatch):
                out["aggregate_gps"] = float(
                    sum(self.batch_sizes)
                    / (self.t_last_done - self.t_first_dispatch))
        if self.failed:
            out["failed"] = int(self.failed)
        if self.preemptions:
            out["preemptions"] = int(self.preemptions)
        if self.latencies_s and self.by_queue:
            out["queues"] = {name: s.summary()
                             for name, s in sorted(self.by_queue.items())}
        if self.latencies_s and self.by_device:
            out["devices"] = {name: s.summary()
                              for name, s in sorted(self.by_device.items())}
        return out


@dataclass
class _Request:
    """Engine-side payload attached to each PackItem. ``req_id`` keys the
    engine's request registry, the single authority over whether a future
    is still outstanding: resolution is exactly once on every path."""

    future: Future
    record: bool
    req_id: int = -1
    queue: str = DEFAULT_QUEUE


@dataclass
class _Inflight:
    """One placed batch in the engine's in-flight registry: a completion
    whose entry is gone (abandoned at a drain timeout or close) is
    dropped."""

    queue: str
    batch: PackedBatch
    ex: DeviceExecutor


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None
             ) -> None:
    """Resolve a submission future, tolerating caller-side cancellation."""
    if not fut.set_running_or_notify_cancel():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


class GraphStreamEngine:
    """One program per bucket and executor: scheduler -> executor pool."""

    def __init__(self, cfg: GNNConfig, params,
                 dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                 buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024),
                 *,
                 max_batch: int = 8,
                 max_wait_ms: float = 2.0,
                 max_nodes_per_batch: Optional[int] = None,
                 max_edges_per_batch: Optional[int] = None,
                 eager_flush: bool = True,
                 max_pending: int = 4096,
                 queues: Optional[Sequence[QueueConfig]] = None,
                 preempt: bool = True,
                 preempt_chunk: int = 4,
                 preempt_horizon_ms: float = 20.0,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None,
                 validate_inputs: bool = True,
                 require_finite: bool = False):
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        devs = ([resolve_device(d) for d in devices] if devices is not None
                else [resolve_device(device)])
        if not devs:
            raise ValueError("at least one device is required")
        self.cfg = cfg
        self.dataflow = dataflow
        self.buckets = tuple(buckets)
        self.model = make_gnn(cfg)
        self.stats = StreamStats()
        # passes over the edge stream per bucket, recorded when the bucket's
        # program first runs its forward (the paper's headline dataflow
        # property)
        self.edge_passes: Dict[BucketKey, int] = {}
        self._validate_inputs = bool(validate_inputs)
        self._require_finite = bool(require_finite)

        queue_cfgs = (tuple(queues) if queues is not None
                      else (QueueConfig(DEFAULT_QUEUE),))
        self._scheduler = BatchScheduler(
            queue_cfgs,
            default_max_batch=max_batch,
            default_max_wait_s=max_wait_ms * 1e-3,
            buckets=self.buckets,
            default_max_nodes=max_nodes_per_batch,
            default_max_edges=max_edges_per_batch,
            preempt_chunk=(int(preempt_chunk) if preempt else None),
            preempt_horizon_s=preempt_horizon_ms * 1e-3)
        self._eager_flush = eager_flush
        # admission backpressure is PER TENANT: a bulk queue pinned at its
        # cap must not block a latency queue's submissions
        self._queue_caps = {qc.name: (qc.max_pending
                                      if qc.max_pending is not None
                                      else max_pending)
                            for qc in queue_cfgs}
        self._pending_by_queue = {qc.name: 0 for qc in queue_cfgs}

        # executor pool: one per device, the parameters on each device once
        on_device: Dict[str, Any] = {}
        for d in devs:
            on_device.setdefault(str(d), _to_device(params, d))
        self._executors = [self._make_executor(d, i, on_device[str(d)])
                           for i, d in enumerate(devs)]
        self.device = devs[0]
        self.params = on_device[str(devs[0])]
        # programs are built one at a time (a capture must not overlap
        # another build)
        self._compile_lock = threading.RLock()

        # async machinery (threads started lazily on first submit)
        self._cv = threading.Condition()
        self._pending = 0          # submitted graphs not yet completed
        self._drain_requested = False
        self._closed = False
        self._stopped = False
        self._placer: Optional[threading.Thread] = None
        self._req_seq = 0                         # next request id
        self._requests: Dict[int, _Request] = {}  # outstanding futures
        self._dispatch_seq = 0
        self._inflight: Dict[int, _Inflight] = {}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def _compiled(self) -> Dict[ProgramKey, Any]:
        """The executors' program caches merged: a program key appears once
        it is built on at least one executor."""
        merged: Dict[ProgramKey, Any] = {}
        for ex in self._executors:
            merged.update(ex.compiled)
        return merged

    compiled = _compiled

    def submit(self, node_feat: np.ndarray, senders: np.ndarray,
               receivers: np.ndarray, edge_feat: Optional[np.ndarray] = None,
               node_pos: Optional[np.ndarray] = None,
               record: bool = True, queue: Optional[str] = None,
               deadline: Optional[float] = None) -> Future:
        """Enqueue one arriving graph; the Future resolves to ITS prediction.

        Graph-level tasks resolve to a ``(out_dim,)`` vector, node-level
        tasks to the graph's ``(n_nodes, out_dim)`` rows. The future
        resolves the moment its batch completes, whichever executor served
        it. ``queue`` names the tenant queue (``QueueConfig``); ``None``
        routes to the first configured queue, which also serves
        ``process`` / ``warmup``; an unknown name raises ``UnknownQueue``.
        Blocks (backpressure) while THIS tenant's ``max_pending`` graphs are
        outstanding. A malformed graph raises ``InvalidGraph``, one over
        the largest bucket ``GraphTooLarge``. ``deadline`` is not supported
        yet and raises ``InvalidRequest``. The latency recorded for the
        graph runs from the call to its answer on the host.
        """
        t_arrival = time.perf_counter()
        if edge_feat is None and self.cfg.edge_feat_dim != 1:
            raise InvalidRequest("model expects edge features")
        if deadline is not None:
            raise InvalidRequest("per-request deadlines are not supported "
                                 "by this engine yet")
        if self._closed:        # don't spin up worker threads just to reject
            raise EngineClosed("engine is closed")
        if queue is None:
            queue = self._scheduler.queue_names[0]
        elif queue not in self._scheduler.queue_names:
            raise UnknownQueue(f"unknown queue '{queue}'; "
                               f"have {sorted(self._scheduler.queue_names)}")
        with self._cv:
            req_id = self._req_seq
            self._req_seq += 1
        if self._validate_inputs:
            # edge_feat_dim 1 means "model takes no edge features": any
            # provided width is legal there (it is ignored)
            reason = check_graph(
                node_feat, senders, receivers, edge_feat, node_pos,
                node_feat_dim=self.cfg.node_feat_dim,
                edge_feat_dim=(self.cfg.edge_feat_dim
                               if self.cfg.edge_feat_dim != 1 else None),
                pos_dim=self.cfg.pos_dim,
                require_finite=self._require_finite)
            if reason is not None:
                raise InvalidGraph(reason, request_ids=(req_id,))
        n = int(np.asarray(node_feat).shape[0])
        e = int(np.asarray(senders).shape[0])
        # the port has no wide placement: a graph over budget is refused
        reason = check_budget(n, e, node_budget=max(self.buckets),
                              wide_enabled=False)
        if reason is not None:
            raise GraphTooLarge(reason, request_ids=(req_id,))
        fut: Future = Future()
        req = _Request(future=fut, record=record, req_id=req_id, queue=queue)
        item = PackItem(
            node_feat=np.asarray(node_feat, np.float32),
            senders=np.asarray(senders), receivers=np.asarray(receivers),
            edge_feat=(None if edge_feat is None
                       else np.asarray(edge_feat, np.float32)),
            node_pos=(None if node_pos is None
                      else np.asarray(node_pos, np.float32)),
            payload=req, t_arrival=t_arrival)
        self._ensure_threads()
        cap = self._queue_caps[queue]
        with self._cv:
            self._cv.wait_for(lambda: (self._pending_by_queue[queue] < cap
                                       or self._closed))
            if self._closed:
                raise EngineClosed("engine is closed")
            self._pending += 1
            self._pending_by_queue[queue] += 1
            self._requests[req_id] = req
            self._scheduler.add(queue, item, now=item.t_arrival)
            self._cv.notify_all()
        return fut

    def process(self, node_feat: np.ndarray, senders: np.ndarray,
                receivers: np.ndarray, edge_feat: Optional[np.ndarray] = None,
                node_pos: Optional[np.ndarray] = None,
                record: bool = True) -> np.ndarray:
        """Synchronous serving: submit one graph, wait for its result."""
        return self.submit(node_feat, senders, receivers, edge_feat, node_pos,
                           record=record).result()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Flush all open batches and wait until every submission completes.

        With ``timeout``, drain is bounded even if an executor wedges: on
        expiry every still-outstanding future fails with ``ExecutorDead``,
        then ``TimeoutError`` is raised. Completions arriving after the
        timeout are ignored through the request registry.
        """
        with self._cv:
            if self._placer is None:            # nothing ever submitted
                return
            self._drain_requested = True
            self._cv.notify_all()
            done = self._cv.wait_for(lambda: self._pending == 0, timeout)
            self._drain_requested = False
            victims = ([] if done else self._abandon_outstanding_locked())
        if not done:
            exc = ExecutorDead(
                "drain timed out; outstanding work abandoned",
                request_ids=tuple(r.req_id for r in victims))
            for req in victims:
                _resolve(req.future, exc=exc)
            raise TimeoutError("drain timed out")

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, stop the worker threads, and reject further submissions.

        Idempotent, and safe after a worker crash. With ``timeout`` each
        join/stop is bounded; work still outstanding after the budget fails
        with ``ExecutorDead`` instead of stranding its caller.
        """
        with self._cv:
            self._closed = True
            already_stopped = self._stopped
            self._stopped = True
            self._cv.notify_all()
        if self._placer is not None and not already_stopped:
            self._placer.join(timeout)
            for ex in self._executors:
                ex.stop(timeout=timeout)
        with self._cv:
            victims = self._abandon_outstanding_locked()
        if victims:
            exc = ExecutorDead(
                "engine closed before completion",
                request_ids=tuple(r.req_id for r in victims))
            for req in victims:
                _resolve(req.future, exc=exc)

    def _abandon_outstanding_locked(self) -> List[_Request]:
        """Pop EVERY outstanding request (scheduler-held and in-flight) so
        its future can be failed; late completions of abandoned work become
        registry misses and are dropped. Called under ``self._cv``;
        resolution happens outside it."""
        self._scheduler.flush_all()
        self._inflight.clear()
        victims = list(self._requests.values())
        self._requests.clear()
        for req in victims:
            self._pending -= 1
            self._pending_by_queue[req.queue] -= 1
        if victims:
            self.stats.record_failure(failed=len(victims))
        self._cv.notify_all()
        return victims

    def __enter__(self) -> "GraphStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def warmup(self, node_feat, senders, receivers, edge_feat=None,
               node_pos=None) -> None:
        """Serve one representative graph without recording it, so that its
        bucket's first-run costs (on a GPU the capture of its program) are
        paid before traffic arrives."""
        self.process(node_feat, senders, receivers, edge_feat, node_pos,
                     record=False)

    def warmup_all(self, pairs: Optional[List[Tuple[int, int]]] = None
                   ) -> List[BucketKey]:
        """Build (and run once) every configured bucket's program on EVERY
        executor. ``pairs`` lists the (node_pad, edge_pad) combinations; the
        default pairs each node bucket with the next edge bucket up
        (``(b, 2b)``), the shape a sparse stream (E ~ 2N) lands in. Buckets
        are prepared for every distinct per-queue ``graph_pad``. Returns
        the bucket keys."""
        if pairs is None:
            pairs = [(b, pad_bucket(2 * b, self.buckets))
                     for b in self.buckets]
        keys = []
        for node_pad, edge_pad in pairs:
            for graph_pad in self._scheduler.graph_pads():
                key = (node_pad, edge_pad, graph_pad)
                for ex in self._executors:
                    ex.warm(key, self._synthetic_batch(*key))
                keys.append(key)
        return keys

    # ------------------------------------------------------------------
    # placer thread: weighted-fair drain -> least-backlog placement
    # ------------------------------------------------------------------

    def _ensure_threads(self) -> None:
        if self._placer is not None:
            return
        with self._cv:
            if self._placer is not None:
                return
            for ex in self._executors:
                ex.start()
            self._placer = threading.Thread(
                target=self._place_loop, name="flowgnn-placer", daemon=True)
            self._placer.start()

    def _place_loop(self) -> None:
        try:
            self._place_loop_inner()
        except BaseException as exc:   # never leave submitters hanging
            self._fail_scheduled(exc)
            raise

    def _place_loop_inner(self) -> None:
        while True:
            picked = None          # (queue_name, pb)
            with self._cv:
                while picked is None:
                    now = time.perf_counter()
                    self._scheduler.poll(now)
                    has_cap = any(ex.has_capacity for ex in self._executors)
                    # pop from the scheduler only while some executor has
                    # pipeline room: excess backlog queues HERE, where
                    # weighted fairness applies, not FIFO in an inbox.
                    # Pipeline restraint: while the preempt window is open,
                    # non-priority batches are claimed only when some
                    # executor is idle, so that claimed chunks do not stack
                    # ahead of the next priority arrival. A completion
                    # always wakes this loop, so restraint never deadlocks.
                    restrained = (has_cap
                                  and self._scheduler.preempt_active(now)
                                  and not self._scheduler.priority_ready
                                  and not any(ex.idle for ex in
                                              self._executors
                                              if not ex.dead))
                    if has_cap and not restrained:
                        picked = self._scheduler.next_batch(now)
                        if picked is not None:
                            self.stats.preemptions = (
                                self._scheduler.preempt_splits)
                            break
                    if self._drain_requested or self._closed:
                        if self._scheduler.open_batches:
                            self._scheduler.poll(float("inf"))
                            continue
                        if self._closed and not self._scheduler.ready_batches:
                            return
                        # ready batches remain, no capacity: wait below
                    elif (self._eager_flush and has_cap
                            and self._scheduler.open_batches
                            and any(ex.idle for ex in self._executors)):
                        # an executor is idle: serving the oldest open batch
                        # NOW beats waiting out its deadline (under load,
                        # batches fill while every device is busy)
                        picked = self._scheduler.flush_oldest_open(now)
                        if picked is not None:
                            self.stats.preemptions = (
                                self._scheduler.preempt_splits)
                        break
                    wake = self._next_wake_locked()
                    self._cv.wait(timeout=None if wake is None
                                  else max(wake - now, 0.0))
            if picked is not None:
                self._place(*picked)

    def _next_wake_locked(self) -> Optional[float]:
        """Earliest reason for the placer to wake on its own: a packer
        flush deadline (submissions and completions notify)."""
        return self._scheduler.next_deadline()

    def _place(self, queue_name: str, pb: PackedBatch) -> None:
        """Least-backlog placement across executors with pipeline room
        (ties: lowest index); a dead executor is never chosen while an
        alive one exists."""
        with self._cv:
            cands = ([ex for ex in self._executors if ex.has_capacity]
                     or [ex for ex in self._executors if not ex.dead])
            if not cands:          # whole pool dead: nothing can run this
                reqs = self._take_requests_locked(pb)
                self.stats.record_failure(queue=queue_name, failed=len(reqs))
            else:
                ex = min(cands, key=lambda e: (e.backlog, e.index))
                pb.dispatch_id = self._dispatch_seq
                self._dispatch_seq += 1
                self._inflight[pb.dispatch_id] = _Inflight(
                    queue=queue_name, batch=pb, ex=ex)
        if not cands:
            exc = ExecutorDead("no live executor to run batch",
                               request_ids=tuple(r.req_id for r in reqs))
            for req in reqs:
                _resolve(req.future, exc=exc)
            return
        ex.submit(queue_name, pb)

    def _take_requests_locked(self, pb: PackedBatch) -> List[_Request]:
        """Pop every still-outstanding request of ``pb`` (under cv)."""
        out: List[_Request] = []
        for it in pb.items:
            req = self._requests.pop(it.payload.req_id, None)
            if req is None:
                continue
            self._pending -= 1
            self._pending_by_queue[req.queue] -= 1
            out.append(req)
        if out:
            self._cv.notify_all()
        return out

    def _fail_scheduled(self, exc: BaseException) -> None:
        """Placer died: close the engine and fail everything not yet on an
        executor (in-flight batches still complete normally)."""
        with self._cv:
            self._closed = True
            victims: List[_Request] = []
            for _, pb in self._scheduler.flush_all():
                victims.extend(self._take_requests_locked(pb))
            if victims:
                self.stats.record_failure(failed=len(victims))
            self._cv.notify_all()
        for req in victims:
            _resolve(req.future, exc=exc)

    # ------------------------------------------------------------------
    # executor callbacks (dispatch threads / complete threads)
    # ------------------------------------------------------------------

    def _make_executor(self, device, index: int, params) -> DeviceExecutor:
        return DeviceExecutor(
            device=device, index=index, params=params,
            program_fn=self._ensure_program,
            unpack_fn=self._unpack,
            on_complete=self._handle_completion,
            on_fatal=self._handle_fatal)

    def _handle_completion(self, ex: DeviceExecutor,
                           done: CompletedBatch) -> None:
        pb = done.batch
        with self._cv:
            if pb.dispatch_id is not None:
                if self._inflight.pop(pb.dispatch_id, None) is None:
                    return      # superseded (drain timeout / close)
        if done.err is None:
            self._complete_ok(ex, done)
        else:
            self._complete_err(ex, done)

    def _complete_ok(self, ex: DeviceExecutor, done: CompletedBatch) -> None:
        pb = done.batch
        resolved = []          # (future, result)
        with self._cv:
            lat, qw = [], []
            for i, it in enumerate(pb.items):
                req = self._requests.pop(it.payload.req_id, None)
                if req is None:
                    continue   # resolved elsewhere (abandoned)
                self._pending -= 1
                self._pending_by_queue[req.queue] -= 1
                if req.record:
                    lat.append(done.t_ready - it.t_arrival)
                    qw.append(done.t_build_start - it.t_arrival)
                resolved.append((req.future, done.results[i]))
            if lat:
                self.stats.record_batch(
                    latencies=lat, queue_waits=qw, device_s=done.device_s,
                    batch_size=len(lat), t_dispatch=done.t_dispatch,
                    t_done=done.t_ready, queue=done.queue, device=ex.label)
            self._cv.notify_all()
        for fut, res in resolved:
            _resolve(fut, res)

    def _complete_err(self, ex: DeviceExecutor, done: CompletedBatch) -> None:
        """A failed batch is terminal for now (retries and bisection are
        ROADMAP queue 1 item 4(c)): every future of it fails with
        ``BatchFailed``, or ``ExecutorDead`` when its executor died, the
        cause chained."""
        err = done.err
        is_death = (isinstance(err, ExecutorDead)
                    or not isinstance(err, Exception))
        with self._cv:
            reqs = self._take_requests_locked(done.batch)
            if not reqs:
                return
            ids = tuple(r.req_id for r in reqs)
            failure: EngineError
            if is_death:
                failure = ExecutorDead(f"executor died: {err}",
                                       request_ids=ids,
                                       executor_index=ex.index)
            else:
                failure = BatchFailed(f"batch failed: {err}",
                                      request_ids=ids,
                                      executor_index=ex.index)
            failure.__cause__ = err
            self.stats.record_failure(queue=done.queue, failed=len(reqs))
        for req in reqs:
            _resolve(req.future, exc=failure)

    def _handle_fatal(self, ex: DeviceExecutor, exc: BaseException) -> None:
        """An executor's worker loop died: the executor fails what it held
        and leaves the rotation. When no executor is left, the engine
        closes and fails everything outstanding."""
        with self._cv:
            if any(not e.dead for e in self._executors):
                self._cv.notify_all()
                return
            self._closed = True
            victims = self._abandon_outstanding_locked()
        failure = ExecutorDead("every executor died",
                               request_ids=tuple(r.req_id for r in victims))
        failure.__cause__ = exc
        for req in victims:
            _resolve(req.future, exc=failure)

    def _split_outputs(self, pb: PackedBatch, out_np: np.ndarray
                       ) -> List[np.ndarray]:
        """Per-graph rows of the packed output, copied so that buffers
        detach: a node-level task's rows by ``graph_offsets``, a
        graph-level task's by slot."""
        if self.cfg.task == "node":
            offs = pb.graph_offsets()
            return [np.array(out_np[offs[i]:offs[i + 1]])
                    for i in range(pb.num_graphs)]
        return [np.array(out_np[i]) for i in range(pb.num_graphs)]

    def _unpack(self, pb: PackedBatch, out_np: np.ndarray
                ) -> List[np.ndarray]:
        return self._split_outputs(pb, out_np)

    # ------------------------------------------------------------------
    # one program per bucket and executor
    # ------------------------------------------------------------------

    def _make_run(self, df: DataflowConfig):
        """The forward under ``df`` as a callable on (params, batch): the
        twin of the reference's ``_make_run`` (a jitted program there; here
        the eager forward, which a ``CapturedProgram`` captures)."""
        apply = self.model.apply
        cfg = self.cfg

        def run(params, graph: GraphBatch) -> torch.Tensor:
            with torch.inference_mode():
                return apply(params, graph, cfg, df)
        return run

    def _widths(self, pb: PackedBatch) -> Tuple[int, int, int]:
        """The staged widths of node_feat, edge_feat and node_pos of a
        batch (1 for absent edge features, ``pos_dim`` for absent
        positions), as ``concat_raw_graphs`` and the padding give them."""
        edge = next((it.edge_feat.shape[1] for it in pb.items
                     if it.edge_feat is not None), 1)
        pos = next((it.node_pos.shape[1] for it in pb.items
                    if it.node_pos is not None), self.cfg.pos_dim)
        return (pb.items[0].node_feat.shape[1], edge, pos)

    def _ensure_program(self, ex: DeviceExecutor, key: BucketKey,
                        graph: PackedBatch):
        """The program for ``key`` on executor ``ex``, built on the first
        sight of the bucket from its first batch ``graph``: the twin of the
        reference's ``_ensure_program``, without autotune, the breaker and
        eviction (ROADMAP queue 1 item 4 (b), (d), (e)). Runs on ``ex``'s
        dispatch thread (or the caller's before the threads start), in
        ``ex.on_device()``."""
        pkey = (key, self._widths(graph))
        prog = ex.compiled.get(pkey)
        if prog is not None:
            return prog
        with self._compile_lock:
            prog = ex.compiled.get(pkey)
            if prog is not None:
                return prog
            run = self._make_run(self.dataflow)
            if ex.device.type == "cuda":
                ex.quiesce()
                if ex.pool is None:
                    ex.pool = torch.cuda.graph_pool_handle()
                staging = BatchStaging(*key, pkey[1], ex.device, pin=True,
                                       slots=CapturedProgram.SLOTS)
                prog = CapturedProgram(run, ex.params, staging, graph,
                                       pool=ex.pool, stream=ex.stream)
                self.edge_passes.setdefault(key, prog.edge_passes)
            else:
                prog = EagerProgram(run, ex.params, key, pkey[1], ex.device,
                                    passes=self.edge_passes)
            ex.compiled[pkey] = prog
            return prog

    def _synthetic_batch(self, node_pad: int, edge_pad: int,
                         graph_pad: int) -> PackedBatch:
        """Minimal real content sealed to a bucket (for warmup)."""
        item = PackItem(
            node_feat=np.zeros((2, self.cfg.node_feat_dim), np.float32),
            senders=np.array([0], np.int32), receivers=np.array([1], np.int32),
            edge_feat=(np.zeros((1, self.cfg.edge_feat_dim), np.float32)
                       if self.cfg.edge_feat_dim != 1 else None))
        return PackedBatch(items=[item], node_pad=node_pad,
                           edge_pad=edge_pad, graph_pad=graph_pad)


class EagerProgram:
    """A bucket's program on the CPU: ``enqueue`` builds a fresh batch
    (``PackedBatch.build``), ``wait`` runs the eager forward on it, so that
    on an executor the forward runs on the complete thread while the
    dispatch thread builds the next batch. The bucket's passes over the
    edges are counted on its first forward into ``passes``."""

    def __init__(self, run, params, key: BucketKey,
                 widths: Tuple[int, int, int], device: torch.device, *,
                 passes: Dict[BucketKey, int]):
        self.run, self.params, self.key = run, params, key
        self.pos_dim = widths[2]
        self.device = device
        self.passes = passes
        self.edge_passes: Optional[int] = None

    def enqueue(self, pb: PackedBatch) -> GraphBatch:
        return pb.build(pos_dim=self.pos_dim, device=self.device)

    def wait(self, batch: GraphBatch) -> Tuple[np.ndarray, None]:
        """The forward's output on the host; no device span (the executor
        takes the marginal host time)."""
        if self.edge_passes is None:
            with count_edge_passes() as ps:
                out = self.run(self.params, batch)
            self.edge_passes = ps.passes
            self.passes.setdefault(self.key, ps.passes)
        else:
            out = self.run(self.params, batch)
        return out.cpu().numpy(), None

    def release(self, ticket) -> None:
        """Nothing to release: each batch has its own tensors."""


class _Slot:
    """One ring slot of a captured program: a pinned input (in the
    program's ``BatchStaging``) and a pinned output, the events recorded
    after its upload, around its replay and after its copy-out, and
    whether a batch holds it."""

    def __init__(self):
        self.uploaded = torch.cuda.Event()
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.done = torch.cuda.Event()
        self.free = True


class CapturedProgram:
    """A bucket's program on a CUDA device: its forward captured once in a
    ``torch.cuda.CUDAGraph`` and replayed for each batch.

    Built from the bucket's first batch on its executor's stream: the batch
    is staged, the forward runs once eagerly on a side stream (it loads the
    kernels, sets their attributes, fills their launch caches and warms the
    allocator), then is captured on the static batch of ``staging`` into
    ``pool`` (one pool per executor), in ``thread_local`` capture mode.

    A batch is served in two halves. ``enqueue`` (the dispatch thread)
    takes the next slot of a ring of ``SLOTS``, pads the batch into the
    slot's pinned input (``stage``), and on ``stream`` enqueues the one copy
    to the card (``upload``), the replay between two CUDA events
    (``replay``) and the copy of the static output into the slot's pinned
    output (``copy_out``), each followed by an event. ``wait`` (the complete
    thread) waits on the copy-out's event, reads the output and frees the
    slot. Before a slot's input is padded again, the event after the copy
    that last read it is waited on.

    The ring has as many slots as an executor holds batches
    (``DeviceExecutor.PIPELINE_DEPTH``: one being built, two on the staging
    pipe, one completing), so the batch that last used a slot has always
    been waited for before the slot comes round again; ``enqueue`` raises
    if it has not.

    The pool. Every program of an executor shares ``pool``, so one
    program's static output may lie in blocks that another's replay uses
    for temporaries. That is safe because each replay's copy-out is
    enqueued on the executor's stream right after the replay, before
    anything else on that stream, and only the executor's dispatch thread
    enqueues there: the next replay of any program of the pool runs after
    the copy has read the output. (Executors do not share pools.)

    The kernel wrappers count their launches in Python where they enqueue
    them: the warm-up run and the capture each count one forward's, and a
    replay counts nothing. What a replay runs is read from the graph itself
    (``graph``: kept with its node list, in debug mode, so that
    ``CUDAGraph.debug_dump`` can write its kernel nodes) or from the
    profiler's device events.
    """

    SLOTS = DeviceExecutor.PIPELINE_DEPTH

    def __init__(self, run, params, staging: BatchStaging, pb: PackedBatch,
                 *, pool, stream: torch.cuda.Stream):
        self.staging = staging
        self.stream = stream
        dev = staging.device_buf.device
        self._slots = [_Slot() for _ in staging.hosts]
        self._next = 0
        with torch.cuda.stream(stream):
            pb.stage(staging, 0)
            staging.upload(0)
            side = torch.cuda.Stream(dev)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                run(params, staging.batch)
            stream.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.graph.enable_debug_mode()
            with count_edge_passes() as ps, torch.cuda.graph(
                    self.graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                self.out = run(params, staging.batch)
            self.graph.instantiate()
        self.edge_passes = ps.passes
        self.out_host = [torch.empty(self.out.shape, dtype=self.out.dtype,
                                     pin_memory=True)
                         for _ in self._slots]
        torch.cuda.synchronize(dev)

    def enqueue(self, pb: PackedBatch) -> int:
        """Stage ``pb`` into the next slot and enqueue its upload, replay
        and copy-out on ``stream``; the slot is the ticket."""
        slot = self._next
        if not self._slots[slot].free:
            raise RuntimeError(f"ring slot {slot} is still held by an "
                               f"unfinished batch")
        self._slots[slot].free = False
        self._next = (slot + 1) % len(self._slots)
        try:
            self.stage(pb, slot)
            with torch.cuda.stream(self.stream):
                self.upload(slot)
                self.replay(slot)
                self.copy_out(slot)
        except BaseException:
            self.release(slot)
            raise
        return slot

    def wait(self, slot: int) -> Tuple[np.ndarray, float]:
        """The batch's output on the host and its replay's span (s); frees
        the slot."""
        s = self._slots[slot]
        try:
            s.done.synchronize()
            out = self.out_host[slot].numpy().copy()
            span = s.start.elapsed_time(s.end) * 1e-3
        finally:
            s.free = True
        return out, span

    def release(self, slot: int) -> None:
        """Free a slot whose batch will not be waited for."""
        self._slots[slot].free = True

    # the steps of ``enqueue``, each a method so that it can be timed
    # alone; upload, replay and copy_out enqueue on the current stream

    def stage(self, pb: PackedBatch, slot: int) -> None:
        """Pad ``pb`` into the slot's pinned input, once the copy that last
        read it has run."""
        self._slots[slot].uploaded.synchronize()
        pb.stage(self.staging, slot)

    def upload(self, slot: int) -> None:
        """Enqueue the slot's one copy to the card."""
        self.staging.upload(slot)
        self._slots[slot].uploaded.record()

    def replay(self, slot: int) -> None:
        """Launch the captured forward between the slot's two events."""
        s = self._slots[slot]
        s.start.record()
        self.graph.replay()
        s.end.record()

    def copy_out(self, slot: int) -> None:
        """Enqueue the static output's copy into the slot's pinned output."""
        self.out_host[slot].copy_(self.out, non_blocking=True)
        self._slots[slot].done.record()


def _to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    return params.to(device)
