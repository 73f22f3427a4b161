"""Multi-queue streaming inference engine (the serving facade), in PyTorch.

The twin of ``repro/core/engine.py``: a thin facade over the paper's
decomposition, a bank of independent queues draining into parallel
processing elements.

  * a ``BatchScheduler`` (``core/scheduler.py``): named tenant queues with
    weighted-fair draining, each over its own ``GraphPacker`` with its own
    ``max_wait`` deadline and batch budgets;
  * a ``DeviceExecutor`` pool (``core/executor.py``): one executor per
    entry of ``devices`` (two entries may name one device), each with its
    own parameter replica, its own per-bucket programs and its own
    dispatch/complete thread pair; a placer thread hands each flushed batch
    to the executor with the least backlog;
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

Failure semantics (DESIGN.md §8). Every submission is held in a request
registry, so that its future resolves exactly once whatever path fires. A
failed batch is retried with bounded exponential backoff on another
executor, then bisected (``PackedBatch.split``: the halves keep the
parent's pads, so the bucket's program serves them and no program is
built) until the poison graph is alone and only its future fails
(``PoisonGraph``); a non-finite output is quarantined by the NaN gate;
a dead executor's work is re-placed on the survivors and the executor is
optionally respawned; ``submit(deadline=)`` sheds expired work before
dispatch (``DeadlineExceeded``) and an in-flight watchdog reclaims
batches stuck inside an executor. Chaos is injected, seeded, through
``core/faults.py``.

Defense in depth (DESIGN.md §9, layers 2 and 3). Each bucket serves on a
degradation ladder ``fused_layer`` / ``kernel`` -> ``pipeline`` ->
single-pass ``fused`` -> ``unfused``; a NaN-gate quarantine, a program
that fails to build (on the CPU), or a shadow audit's mismatch demotes the
bucket one rung (its programs are dropped and built again at the new
rung), and after a quiet cooldown it is probed one rung up. On a GPU the
ladder ends at ``pipeline``, the lowest rung that runs a hand-written
kernel, and a capture that raises fails its batch instead of demoting:
the card never serves the plain forms. Shadow audits re-run sampled
batches on the CPU under the unfused mirror, from the batch's host arrays
and a host copy of the parameters that served it. ``update_params`` swaps
the weights under live traffic: a dispatch pins its executor's ``(params,
version)``; on a GPU the executor copies a new version into the one tree
of weights all its captured programs read, on its stream before the first
replay of that version, so that no bucket is captured again and none
serves stale weights; a canary holds the new weights to the CPU mirror
first and rolls back on failure (``ParamUpdateFailed``).

Autotune and overload (DESIGN.md §5). With ``autotune=True`` a bucket's
first batch times a few candidate dataflows (``_candidate_dataflows``: on
the CPU the reference's (num_banks, edge_tile, impl) grid; on a GPU the
impls ``fused_layer`` / ``pipeline`` / the configured one, each at a few
``rows_per_block``) and the winner serves the bucket on every executor
(on a GPU the winner's capture itself is kept); winners persist in a JSON
cache keyed by the workload, torch and the device (``autotune_cache``).
The winner is rung 0 of the breaker's ladder. Each bucket's traffic is
folded into running stats (``_BucketLoad``); when its device time or batch
fill drifts out of the envelope it was tuned in, the winner is dropped and
the next batch tunes again (``drift_*``, ``max_retunes``). Each executor
keeps at most ``max_cached_programs`` programs, evicting the least
recently used (its graph, pool share and pinned ring go with it); an
evicted bucket stays servable from its cached winner.

Wide placement (DESIGN.md §10). With ``wide=True`` a graph over the
largest bucket is planned at ``submit`` (``distributed/wide.py::plan_wide``,
one O(E) numpy pass; ``GraphTooLarge`` when no ``wide_k``-way split fits a
bucket), waits in the wide queue until ``wide_k`` executors are idle at once
(all or nothing, outside the priority tenant's preempt window), and runs as
``wide_k`` destination-owned shards that exchange their halo rows once per
layer. The gang answers through the same future, registry, stats
(``by_device["wide[K]"]``) and fault semantics as narrow traffic: a member's
death requeues the whole request, a transient failure retries up to
``max_retries`` (``BatchFailed`` after), a non-finite answer is
``PoisonGraph``. On a card the wide forward of each (``WideBucket``, gang) is
one CUDA graph (``CapturedWideProgram``) that reads the leader's resident
weights; on the CPU, or over several cards, it runs eagerly
(``EagerWideProgram``).
"""

from __future__ import annotations

import gc
import heapq
import itertools
import json
import os
import queue as queue_lib
import threading
import time
from concurrent.futures import Future
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.errors import (BatchFailed, DeadlineExceeded,
                                     EngineClosed, EngineError,
                                     ExecutorDead, GraphTooLarge,
                                     InvalidGraph, InvalidRequest,
                                     ParamUpdateFailed, PoisonGraph,
                                     UnknownQueue)
from repro_torch.core.executor import (CompletedBatch, DeviceExecutor,
                                      _tensors)
from repro_torch.core.faults import FaultInjector
from repro_torch.core.graph import (BatchStaging, GraphBatch,
                                    build_graph_batch, pad_bucket)
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import GNNConfig, make_gnn
from repro_torch.core.packing import PackedBatch, PackItem
from repro_torch.core.scheduler import BatchScheduler, QueueConfig
from repro_torch.core.validate import check_budget, check_graph
from repro_torch.distributed.sharding import (params_compatible,
                                              replicate_params)
from repro_torch.distributed.wide import (WideForward, WidePlan,
                                          WidePlanError, build_wide_forward,
                                          plan_wide, stack_shard_arrays,
                                          wide_mesh)

BucketKey = Tuple[int, int, int]        # (node_pad, edge_pad, graph_pad)
# a program's key: its bucket and the widths of node_feat, edge_feat and
# node_pos it was built for
ProgramKey = Tuple[BucketKey, Tuple[int, int, int]]

DEFAULT_QUEUE = "default"

CPU = torch.device("cpu")


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
    the first dispatch to the last completion). ``preemptions`` counts
    bulk batches split by a priority tenant's preempt window.

    Failure accounting (DESIGN.md §8): ``retries`` counts batch
    re-placements (transient retry, executor-death requeue, each bisection
    half), ``quarantined`` graphs failed as poison (retries exhausted or a
    non-finite output), ``shed_deadline`` graphs dropped before dispatch
    because their deadline passed, ``failed`` futures resolved with an
    error for any reason; ``executor_deaths`` / ``respawns`` track
    supervision, and ``pool_degraded`` is true from the first death until
    a respawn restores the whole pool.

    Load accounting (DESIGN.md §5): ``retunes`` drift-triggered autotune
    searches, ``program_evictions`` programs dropped by an executor's LRU
    cap; neither is a failure.

    Defense accounting (DESIGN.md §9): ``invalid_rejects`` graphs refused
    at admission, ``audits`` / ``audit_mismatches`` / ``audit_dropped`` the
    shadow auditor, ``breaker_trips`` / ``breaker_probes`` the ladder's
    demotions and cooldown probes, ``param_updates`` / ``param_rollbacks``
    hot reloads promoted and refused. ``summary()`` reports them, globally
    and per queue, also when no latency was recorded.
    """

    latencies_s: List[float] = field(default_factory=list)
    queue_wait_s: List[float] = field(default_factory=list)
    device_s: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)
    t_first_dispatch: Optional[float] = None
    t_last_done: Optional[float] = None
    by_queue: Dict[str, "StreamStats"] = field(default_factory=dict)
    by_device: Dict[str, "StreamStats"] = field(default_factory=dict)
    retries: int = 0
    quarantined: int = 0
    shed_deadline: int = 0
    failed: int = 0
    executor_deaths: int = 0
    respawns: int = 0
    pool_degraded: bool = False
    preemptions: int = 0
    retunes: int = 0
    program_evictions: int = 0
    invalid_rejects: int = 0
    audits: int = 0
    audit_mismatches: int = 0
    audit_dropped: int = 0
    breaker_trips: int = 0
    breaker_probes: int = 0
    param_updates: int = 0
    param_rollbacks: int = 0

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

    def record_failure(self, *, queue: Optional[str] = None, retries: int = 0,
                       quarantined: int = 0, shed: int = 0, failed: int = 0
                       ) -> None:
        self.retries += retries
        self.quarantined += quarantined
        self.shed_deadline += shed
        self.failed += failed
        if queue is not None:
            self.by_queue.setdefault(queue, StreamStats()).record_failure(
                retries=retries, quarantined=quarantined, shed=shed,
                failed=failed)

    @property
    def _has_failures(self) -> bool:
        return bool(self.retries or self.quarantined or self.shed_deadline
                    or self.failed or self.executor_deaths or self.respawns
                    or self.pool_degraded)

    @property
    def _has_load_events(self) -> bool:
        return bool(self.preemptions or self.retunes
                    or self.program_evictions)

    @property
    def _has_defense_events(self) -> bool:
        return bool(self.invalid_rejects or self.audits
                    or self.audit_mismatches or self.audit_dropped
                    or self.breaker_trips or self.breaker_probes
                    or self.param_updates or self.param_rollbacks)

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
        self._failure_summary(out)
        self._load_summary(out)
        self._defense_summary(out)
        if self.by_queue and (self.latencies_s or self._has_failures):
            out["queues"] = {name: s.summary()
                             for name, s in sorted(self.by_queue.items())}
        if self.latencies_s and self.by_device:
            out["devices"] = {name: s.summary()
                              for name, s in sorted(self.by_device.items())}
        return out

    def _failure_summary(self, out: Dict[str, Any]) -> None:
        if not self._has_failures:
            return
        out["retries"] = int(self.retries)
        out["quarantined_graphs"] = int(self.quarantined)
        out["shed_deadline"] = int(self.shed_deadline)
        out["failed"] = int(self.failed)
        out["executor_deaths"] = int(self.executor_deaths)
        out["respawns"] = int(self.respawns)
        out["pool_degraded"] = bool(self.pool_degraded)

    def _load_summary(self, out: Dict[str, Any]) -> None:
        if not self._has_load_events:
            return
        out["preemptions"] = int(self.preemptions)
        out["retunes"] = int(self.retunes)
        out["program_evictions"] = int(self.program_evictions)

    def _defense_summary(self, out: Dict[str, Any]) -> None:
        if not self._has_defense_events:
            return
        out["invalid_graphs"] = int(self.invalid_rejects)
        out["audits"] = int(self.audits)
        out["audit_mismatches"] = int(self.audit_mismatches)
        out["audit_dropped"] = int(self.audit_dropped)
        out["breaker_trips"] = int(self.breaker_trips)
        out["breaker_probes"] = int(self.breaker_probes)
        out["param_updates"] = int(self.param_updates)
        out["param_rollbacks"] = int(self.param_rollbacks)


@dataclass
class _Request:
    """Engine-side payload attached to each PackItem. ``req_id`` keys the
    engine's request registry, the single authority over whether a future
    is still outstanding: resolution is exactly once on every path.
    ``deadline_t`` is an absolute ``perf_counter`` deadline (``None``: no
    deadline); ``dispatched`` is true while the graph is on an executor,
    where it can no longer be shed."""

    future: Future
    record: bool
    req_id: int = -1
    queue: str = DEFAULT_QUEUE
    deadline_t: Optional[float] = None
    dispatched: bool = False


@dataclass
class _Inflight:
    """One placed batch in the engine's in-flight registry: a completion
    whose entry is gone (reclaimed by the watchdog, abandoned at a drain
    timeout or close) is dropped."""

    queue: str
    batch: PackedBatch
    ex: DeviceExecutor
    t_placed: float


@dataclass
class _WideRequest:
    """One oversized graph waiting for (or holding) a gang of ``wide_k``
    executors. It bypasses the packer (an oversized graph is its own batch)
    but shares the request registry, the per-queue admission caps and the
    stats with narrow traffic. ``plan`` is made at ``submit``, where a
    graph no split fits is refused, so the placer only looks for a gang.
    ``attempts`` counts transient failures against ``max_retries``;
    ``requeues`` counts gang deaths against the requeue budget."""

    req: _Request
    plan: WidePlan
    node_feat: np.ndarray
    edge_feat: Optional[np.ndarray]
    node_pos: Optional[np.ndarray]
    t_arrival: float
    attempts: int = 0
    requeues: int = 0


@dataclass
class _BucketLoad:
    """A bucket's running traffic stats, which drive drift retunes (§5).

    EWMAs (window ``drift_window`` batches) of the batch fill, the device
    time (``CompletedBatch.device_s``: the replay's span on a GPU, the
    marginal host time on the CPU) and the gap between completions are held
    to the envelope the bucket was tuned in: ``tuned_device_s`` is the
    winner's best time in the same units, ``tuned_fill`` the fill of the
    first batch served after (re)tuning. When the device time grows past
    ``drift_device_factor`` times the tuned one, or the fill leaves
    [tuned / ``drift_fill_factor``, tuned x ``drift_fill_factor``], the
    winner is dropped and the next batch tunes again, at most
    ``max_retunes`` times a bucket and ``drift_cooldown_s`` apart."""

    batches: int = 0
    graphs: int = 0
    ewma_fill: Optional[float] = None
    ewma_device_s: Optional[float] = None
    ewma_gap_s: Optional[float] = None
    last_seen_t: Optional[float] = None
    tuned_fill: Optional[float] = None
    tuned_device_s: Optional[float] = None
    batches_since_tune: int = 0
    last_tune_t: float = float("-inf")
    retunes: int = 0
    last_reason: Optional[str] = None


#: the ladder's floor on the CPU: the unfused mirror, the program the
#: shadow auditor holds every batch to, so a bucket at the floor cannot
#: fail an audit
_JNP_RUNG = 3
#: the ladder's floor on a GPU: the pipeline, the lowest rung that still
#: runs a hand-written kernel (``mp_pipeline``); the rungs below it are
#: plain PyTorch, which the card never serves
_KERNEL_RUNG = 1


@dataclass
class _BucketHealth:
    """A bucket's circuit-breaker ledger (DESIGN.md §9).

    ``level`` is how many rungs BELOW its tuned winner (the configured
    dataflow when untuned) the bucket serves on (0: healthy). A trip (a NaN-gate quarantine, a program that
    fails to build, an audit mismatch) demotes one rung down the ladder
    ``fused_layer -> pipeline -> single-pass fused -> unfused``. After
    ``breaker_cooldown_s`` without a trip the breaker half-opens: it
    promotes one rung and marks the bucket ``probing``, which sends its
    next completions through the auditor; a clean audit confirms, a
    mismatch demotes again. ``probes`` is bounded by
    ``breaker_max_probes``."""

    level: int = 0
    trips: int = 0
    probes: int = 0
    probing: bool = False
    last_trip_t: float = float("-inf")
    last_reason: Optional[str] = None


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None
             ) -> None:
    """Resolve a submission future, tolerating caller-side cancellation."""
    if not fut.set_running_or_notify_cancel():
        return
    if exc is not None:
        fut.set_exception(exc)
    else:
        fut.set_result(result)


# captures in flight in this process (of any engine), and whether the
# collector was on when the first of them began
_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_on = False


@contextmanager
def _no_gc():
    """The cyclic garbage collector off while the block runs. A capture
    must not run it: a collection on the capturing thread may free a dead
    engine's captured graph, a call the capture forbids, which invalidates
    the capture and leaves the pool recording. The collector is
    process-wide, so it comes back on only when the last block of any
    thread has left."""
    global _gc_holds, _gc_was_on
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_on = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_on:
                gc.enable()


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in _tensors(tree)
               if t.is_floating_point())


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
                 autotune: bool = False,
                 autotune_cache: Optional[str] = None,
                 max_autotune: int = 5,
                 max_pending: int = 4096,
                 queues: Optional[Sequence[QueueConfig]] = None,
                 preempt: bool = True,
                 preempt_chunk: int = 4,
                 preempt_horizon_ms: float = 20.0,
                 max_cached_programs: Optional[int] = 128,
                 drift_window: int = 32,
                 drift_device_factor: float = 3.0,
                 drift_fill_factor: float = 2.0,
                 drift_cooldown_s: float = 2.0,
                 max_retunes: int = 2,
                 devices: Optional[Sequence[DeviceLike]] = None,
                 device: DeviceLike = None,
                 max_retries: int = 1,
                 retry_backoff_ms: float = 1.0,
                 retry_backoff_max_ms: float = 50.0,
                 validate_outputs: bool = True,
                 inflight_timeout_s: Optional[float] = None,
                 respawn_executors: bool = False,
                 fault_injector: Optional[FaultInjector] = None,
                 validate_inputs: bool = True,
                 require_finite: bool = False,
                 audit_sample_rate: float = 0.0,
                 audit_rtol: float = 1e-3,
                 audit_atol: float = 1e-5,
                 audit_seed: int = 0,
                 breaker: bool = True,
                 breaker_cooldown_s: float = 1.0,
                 breaker_max_probes: int = 2,
                 wide: bool = False,
                 wide_k: Optional[int] = None):
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

        # failure semantics (DESIGN.md §8)
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self._max_retries = int(max_retries)
        self._retry_backoff_s = max(0.0, retry_backoff_ms) * 1e-3
        self._retry_backoff_max_s = max(0.0, retry_backoff_max_ms) * 1e-3
        self._validate_outputs = bool(validate_outputs)
        self._inflight_timeout_s = inflight_timeout_s
        self._respawn = bool(respawn_executors)
        self._faults = fault_injector

        # defense in depth (DESIGN.md §9)
        self._validate_inputs = bool(validate_inputs)
        self._require_finite = bool(require_finite)
        if not 0.0 <= audit_sample_rate <= 1.0:
            raise ValueError("audit_sample_rate must be in [0, 1]")
        self._audit_rate = float(audit_sample_rate)
        self._audit_rtol = float(audit_rtol)
        self._audit_atol = float(audit_atol)
        self._breaker = bool(breaker)
        self._breaker_cooldown_s = max(0.0, float(breaker_cooldown_s))
        self._breaker_max_probes = max(0, int(breaker_max_probes))
        self._floor = (_KERNEL_RUNG if any(d.type == "cuda" for d in devs)
                       else _JNP_RUNG)
        self._bucket_health: Dict[BucketKey, _BucketHealth] = {}
        self._served_impl: Dict[BucketKey, str] = {}
        # the shadow auditor: a bounded hand-off queue and its own rng
        # (sampling happens under self._cv, in completion order)
        self._audit_q: Optional[queue_lib.Queue] = (
            queue_lib.Queue(maxsize=32) if self._audit_rate > 0 else None)
        self._audit_thread: Optional[threading.Thread] = None
        self._audit_rng = np.random.default_rng(int(audit_seed))
        self._audit_ref = None         # the CPU mirror, made on first use
        self._audits_enqueued = 0
        self._audits_done = 0
        #: host seconds the auditor spent judging batches
        self.audit_seconds = 0.0
        # versioned params: a dispatch pins its executor's (params,
        # version); the host copies of the last two versions serve audits
        # (of batches of either version) and respawns
        self._param_version = 0
        self._params_by_version: Dict[int, Any] = {
            0: replicate_params(params, [CPU])[0]}
        self._update_lock = threading.Lock()
        self._canary_run = None        # the default dataflow's forward

        # executor pool: one parameter replica per executor, also where two
        # executors share a device (each copies into its own programs'
        # tensors on its own stream)
        self._executors = [
            self._make_executor(d, i, p)
            for i, (d, p) in enumerate(zip(devs,
                                           replicate_params(params, devs)))]
        # executors taken out of the pool (dead): kept, so that their
        # programs and graph pool are never freed while a wedged stream of
        # theirs may still run them
        self._dead_executors: List[DeviceExecutor] = []
        # executor-death requeues are bounded apart from poison retries:
        # one hop per surviving executor plus slack
        self._max_requeues = 2 * len(devs) + 2

        # wide placement (DESIGN.md §10): one oversized graph split across
        # a gang of ``wide_k`` executors. State under self._cv, except the
        # programs (under the compile lock, like the narrow ones)
        self._wide_enabled = bool(wide)
        self._wide_k = int(wide_k) if wide_k is not None else len(devs)
        if self._wide_enabled:
            if self._wide_k < 2:
                raise ValueError("wide placement needs wide_k >= 2")
            if self._wide_k > len(devs):
                raise ValueError(f"wide_k={self._wide_k} exceeds the pool "
                                 f"size {len(devs)}")
        self._wide_queue: List[_WideRequest] = []
        self._wide_reserved: set = set()       # executor indices gang-held
        self._wide_running = 0
        self._wide_programs: Dict[Tuple[Any, ...], Any] = {}
        self.device = devs[0]
        self.params = self._executors[0].params
        # programs are built one at a time (a capture must not overlap
        # another build, or a canary)
        self._compile_lock = threading.RLock()

        # autotune: the winner of each bucket, shared by the pool (programs
        # stay per executor); the timings of the buckets tuned here
        self._autotune = bool(autotune)
        self._autotune_cache = autotune_cache
        self._max_autotune = max(1, int(max_autotune))
        self._tuned: Dict[BucketKey, DataflowConfig] = {}
        self._tune_log: Dict[BucketKey, Dict[str, Any]] = {}
        self._load_autotune_cache()

        # drift retune (per-bucket stats under self._cv) and LRU eviction of
        # programs (under the compile lock)
        if max_cached_programs is not None and max_cached_programs < 1:
            raise ValueError("max_cached_programs must be >= 1 or None")
        self._max_cached_programs = max_cached_programs
        self._drift_window = max(1, int(drift_window))
        self._drift_device_factor = float(drift_device_factor)
        self._drift_fill_factor = max(1.0, float(drift_fill_factor))
        self._drift_cooldown_s = max(0.0, float(drift_cooldown_s))
        self._max_retunes = max(0, int(max_retunes))
        self._bucket_load: Dict[BucketKey, _BucketLoad] = {}
        self._evict_log: Dict[BucketKey, int] = {}
        self._touch = itertools.count(1)   # engine-wide LRU touch sequence

        # async machinery (threads started lazily on first submit)
        self._cv = threading.Condition()
        self._pending = 0          # submitted graphs not yet completed
        self._drain_requested = False
        self._closed = False
        self._stopped = False
        self._placer: Optional[threading.Thread] = None
        self._req_seq = 0                         # next request id
        self._requests: Dict[int, _Request] = {}  # outstanding futures
        self._retry_heap: List[Tuple[float, int, str, PackedBatch,
                                     Optional[int]]] = []
        self._retry_seq = 0
        self._dispatch_seq = 0
        self._inflight: Dict[int, _Inflight] = {}
        self._deadline_heap: List[Tuple[float, int]] = []
        self._deadlines_used = False
        self._supervised: set = set()             # id(ex) already handled
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def queue_names(self) -> Tuple[str, ...]:
        return self._scheduler.queue_names

    @property
    def num_devices(self) -> int:
        return len(self._executors)

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
        outstanding. A malformed graph raises ``InvalidGraph``; one over
        the largest bucket ``GraphTooLarge``, unless ``wide=True`` and a
        ``wide_k``-way split of it fits a bucket, when it is served by a
        gang of executors. ``deadline`` is a budget in
        seconds from this call: a graph whose deadline passes before it is
        dispatched is shed and its future fails with ``DeadlineExceeded``
        (shed work never reaches a device); the admission wait is bounded
        by the remaining budget. The latency recorded for the graph runs
        from the call to its answer on the host.
        """
        t_arrival = time.perf_counter()
        if edge_feat is None and self.cfg.edge_feat_dim != 1:
            raise InvalidRequest("model expects edge features")
        if deadline is not None and deadline <= 0:
            raise InvalidRequest("deadline must be > 0 seconds")
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
        if self._faults is not None:
            self._faults.on_submit(req_id)       # may raise InjectedOOM
            # a "buggy client" corrupts its arrays BEFORE admission, which
            # must then refuse them
            node_feat, senders, receivers, edge_feat = (
                self._faults.corrupt_input(req_id, node_feat, senders,
                                           receivers, edge_feat))
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
                with self._cv:
                    self.stats.invalid_rejects += 1
                raise InvalidGraph(reason, request_ids=(req_id,))
        # the single-device budget gate (DESIGN.md §10): a graph no bucket
        # holds is servable only split across a gang of executors
        n = int(np.asarray(node_feat).shape[0])
        e = int(np.asarray(senders).shape[0])
        node_budget = max(self.buckets)
        reason = check_budget(n, e, node_budget=node_budget,
                              wide_enabled=self._wide_enabled)
        wide_plan: Optional[WidePlan] = None
        if reason is not None:
            if not self._wide_enabled:
                with self._cv:
                    self.stats.invalid_rejects += 1
                raise GraphTooLarge(reason, request_ids=(req_id,))
            try:
                wide_plan = plan_wide(
                    np.asarray(senders), np.asarray(receivers), n,
                    k=self._wide_k, node_budget=node_budget)
            except WidePlanError as exc:
                with self._cv:
                    self.stats.invalid_rejects += 1
                raise GraphTooLarge(
                    f"graph does not fit a {self._wide_k}-shard wide split: "
                    f"{exc}", request_ids=(req_id,)) from exc
        fut: Future = Future()
        req = _Request(future=fut, record=record, req_id=req_id, queue=queue,
                       deadline_t=(None if deadline is None
                                   else t_arrival + deadline))
        node_feat = np.asarray(node_feat, np.float32)
        edge_feat = (None if edge_feat is None
                     else np.asarray(edge_feat, np.float32))
        node_pos = (None if node_pos is None
                    else np.asarray(node_pos, np.float32))
        item = (None if wide_plan is not None else PackItem(
            node_feat=node_feat, senders=np.asarray(senders),
            receivers=np.asarray(receivers), edge_feat=edge_feat,
            node_pos=node_pos, payload=req, t_arrival=t_arrival))
        self._ensure_threads()
        cap = self._queue_caps[queue]
        with self._cv:
            def admitted():
                return self._pending_by_queue[queue] < cap or self._closed
            if req.deadline_t is None:
                self._cv.wait_for(admitted)
            else:
                # the deadline clock started at the call: the admission
                # wait is bounded by what is left of the budget
                self._cv.wait_for(admitted, timeout=max(
                    req.deadline_t - time.perf_counter(), 0.0))
            if self._closed:
                raise EngineClosed("engine is closed")
            expired = req.deadline_t is not None and (
                self._pending_by_queue[queue] >= cap
                or time.perf_counter() >= req.deadline_t)
            if expired:
                # the budget burned at backpressure: never admitted
                self.stats.record_failure(queue=queue, shed=1, failed=1)
            else:
                self._pending += 1
                self._pending_by_queue[queue] += 1
                self._requests[req_id] = req
                if req.deadline_t is not None:
                    self._deadlines_used = True
                    heapq.heappush(self._deadline_heap,
                                   (req.deadline_t, req_id))
                if wide_plan is not None:
                    self._wide_queue.append(_WideRequest(
                        req=req, plan=wide_plan, node_feat=node_feat,
                        edge_feat=edge_feat, node_pos=node_pos,
                        t_arrival=t_arrival))
                else:
                    self._scheduler.add(queue, item, now=item.t_arrival)
            self._cv.notify_all()
        if expired:
            _resolve(fut, exc=DeadlineExceeded(
                "deadline expired at admission backpressure",
                request_ids=(req_id,)))
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
            self._watchdog_stop.set()
            if self._audit_thread is not None:
                self._audit_q.put(None)        # sentinel: drain then exit
                self._audit_thread.join(timeout)
            with self._cv:
                dead = list(self._dead_executors)
            for ex in dead:      # a wedged thread is left behind, bounded
                ex.stop(timeout=1.0 if timeout is None
                        else min(timeout, 1.0))
        with self._cv:
            victims = self._abandon_outstanding_locked()
        if victims:
            exc = ExecutorDead(
                "engine closed before completion",
                request_ids=tuple(r.req_id for r in victims))
            for req in victims:
                _resolve(req.future, exc=exc)

    def _abandon_outstanding_locked(self) -> List[_Request]:
        """Pop EVERY outstanding request (scheduler-held, retrying and
        in-flight) so its future can be failed; late completions of
        abandoned work become registry misses and are dropped. Called under
        ``self._cv``; resolution happens outside it."""
        self._scheduler.flush_all()
        self._retry_heap.clear()
        self._inflight.clear()
        self._wide_queue.clear()
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
        executor; with ``autotune`` each bucket is tuned first, on a
        synthetic batch (two nodes, one edge) as in the reference, by the
        first executor that builds it. ``pairs`` lists the (node_pad, edge_pad) combinations; the
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

    def autotune_report(self) -> Dict[str, Dict[str, Any]]:
        """Per bucket (``"NxExG"``): the dataflow it serves at rung 0
        (``num_banks``, ``edge_tile``, ``impl``, ``rows_per_block``) and
        where it came from (``source``: ``autotuned`` here, ``cache``, or
        ``default``); for a bucket tuned here the tune's log
        (``candidates_us``: each candidate's best time, ``winner``,
        ``best_us``, ``device``: the executor that tuned it, ``failed``:
        candidates that raised, ``captures``: programs built to tune it,
        ``tune_ms``); its traffic envelope (``load``: batches, graphs, EWMA
        fill and device µs, arrival rate, retunes and the last one's
        reason); ``evictions`` of its programs; once its breaker has
        tripped or probed, the breaker's ledger (``level``, ``trips``,
        ``probes``, ``probing``, ``last_reason``, ``serving_impl``: the
        impl of the rung it serves on). Evicted buckets stay in the
        report."""
        report: Dict[str, Dict[str, Any]] = {}
        with self._compile_lock:
            keys = ({k for k, _ in self._compiled} | set(self._tuned)
                    | set(self._tune_log) | set(self._bucket_load)
                    | set(self._evict_log) | set(self._bucket_health))
            for key in keys:
                df = self._base_df(key)
                entry: Dict[str, Any] = {
                    "num_banks": df.num_banks, "edge_tile": df.edge_tile,
                    "impl": df.impl, "rows_per_block": df.rows_per_block,
                    "source": ("autotuned" if key in self._tune_log else
                               "cache" if key in self._tuned else "default")}
                if key in self._tune_log:
                    entry.update(self._tune_log[key])
                load = self._bucket_load.get(key)
                if load is not None and load.batches:
                    entry["load"] = {
                        "batches": int(load.batches),
                        "graphs": int(load.graphs),
                        "ewma_fill": (None if load.ewma_fill is None
                                      else round(load.ewma_fill, 3)),
                        "ewma_device_us": (
                            None if load.ewma_device_s is None
                            else round(load.ewma_device_s * 1e6, 1)),
                        "arrival_hz": (
                            None if not load.ewma_gap_s
                            else round(1.0 / load.ewma_gap_s, 2)),
                        "retunes": int(load.retunes),
                        "last_retune_reason": load.last_reason,
                    }
                ev = self._evict_log.get(key)
                if ev:
                    entry["evictions"] = int(ev)
                health = self._bucket_health.get(key)
                if health is not None and (health.trips or health.probes):
                    entry["breaker"] = {
                        "level": int(health.level),
                        "trips": int(health.trips),
                        "probes": int(health.probes),
                        "probing": bool(health.probing),
                        "last_reason": health.last_reason,
                        "serving_impl": self._effective_df(key, df).impl,
                    }
                report["x".join(map(str, key))] = entry
        return report

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
            if self._audit_q is not None and self._audit_thread is None:
                self._audit_thread = threading.Thread(
                    target=self._audit_loop, name="flowgnn-auditor",
                    daemon=True)
                self._audit_thread.start()
            if self._inflight_timeout_s is not None:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, name="flowgnn-watchdog",
                    daemon=True)
                self._watchdog.start()

    def _place_loop(self) -> None:
        try:
            self._place_loop_inner()
        except BaseException as exc:   # never leave submitters hanging
            self._fail_scheduled(exc)
            raise

    def _place_loop_inner(self) -> None:
        while True:
            picked = None          # (queue_name, pb, executor to avoid)
            to_fail: List[Tuple[_Request, BaseException]] = []
            with self._cv:
                while picked is None:
                    now = time.perf_counter()
                    self._scheduler.poll(now)
                    to_fail.extend(self._shed_scheduler_locked(now))
                    if to_fail:
                        break          # resolve outside the lock, re-enter
                    # wide gang scheduling (DESIGN.md §10): all-or-nothing
                    # reservation of wide_k idle executors; without one the
                    # request stays queued while narrow traffic flows, and
                    # every completion wakes this loop to try again
                    if self._wide_queue:
                        alive = sum(1 for ex in self._executors
                                    if not ex.dead)
                        if alive < self._wide_k and not self._respawn:
                            # the pool shrank below wide_k for good
                            to_fail.extend(self._fail_wide_queue_locked(
                                f"pool has {alive} live executors "
                                f"< wide_k={self._wide_k}"))
                            break
                        gang = self._try_reserve_gang_locked(now)
                        if gang is not None:
                            wreq = self._wide_queue.pop(0)
                            self._wide_running += 1
                            threading.Thread(
                                target=self._run_wide, args=(wreq, gang),
                                name="flowgnn-wide", daemon=True).start()
                            continue
                    free = [ex for ex in self._executors
                            if ex.index not in self._wide_reserved]
                    has_cap = any(ex.has_capacity for ex in free)
                    # due retries jump the fairness queue: they are old work
                    # that has been charged already
                    if (has_cap and self._retry_heap
                            and self._retry_heap[0][0] <= now):
                        _, _, qn, pb, excl = heapq.heappop(self._retry_heap)
                        picked = (qn, pb, excl)
                        break
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
                                  and not any(ex.idle for ex in free
                                              if not ex.dead))
                    if has_cap and not restrained:
                        nxt = self._scheduler.next_batch(now)
                        if nxt is not None:
                            picked = (nxt[0], nxt[1], None)
                            self.stats.preemptions = (
                                self._scheduler.preempt_splits)
                            break
                    if self._drain_requested or self._closed:
                        if self._scheduler.open_batches:
                            self._scheduler.poll(float("inf"))
                            continue
                        if (self._closed
                                and not self._scheduler.ready_batches
                                and not self._retry_heap
                                and not self._wide_queue
                                and not self._wide_running):
                            return
                        # ready or retrying batches remain, no capacity (or
                        # a retry not yet due): wait below
                    elif (self._eager_flush and has_cap
                            and self._scheduler.open_batches
                            and any(ex.idle for ex in free)):
                        # an executor is idle: serving the oldest open batch
                        # NOW beats waiting out its deadline (under load,
                        # batches fill while every device is busy)
                        nxt = self._scheduler.flush_oldest_open(now)
                        if nxt is not None:
                            picked = (nxt[0], nxt[1], None)
                            self.stats.preemptions = (
                                self._scheduler.preempt_splits)
                        break
                    wake = self._next_wake_locked(has_cap)
                    self._cv.wait(timeout=None if wake is None
                                  else max(wake - now, 0.0))
                if picked is not None:
                    # last-moment shedding: expired members of the popped
                    # batch never reach a device
                    queue_name, pb, exclude = picked
                    pb, shed = self._shed_batch_locked(
                        pb, time.perf_counter())
                    to_fail.extend(shed)
                    picked = (None if pb is None
                              else (queue_name, pb, exclude))
            for req, exc in to_fail:
                _resolve(req.future, exc=exc)
            if picked is not None:
                self._place(*picked)

    def _next_wake_locked(self, has_cap: bool) -> Optional[float]:
        """Earliest reason for the placer to wake on its own: a packer flush
        deadline, a retry coming due (with pipeline room: a completion
        notifies when room frees), or a request deadline to shed. Entries of
        requests resolved or on a device are dropped lazily."""
        cands = []
        d = self._scheduler.next_deadline()
        if d is not None:
            cands.append(d)
        if has_cap and self._retry_heap:
            cands.append(self._retry_heap[0][0])
        while self._deadline_heap:
            req = self._requests.get(self._deadline_heap[0][1])
            if req is None or req.dispatched:
                heapq.heappop(self._deadline_heap)
                continue
            cands.append(self._deadline_heap[0][0])
            break
        return min(cands) if cands else None

    def _place(self, queue_name: str, pb: PackedBatch,
               exclude: Optional[int] = None) -> None:
        """Least-backlog placement across executors with pipeline room
        (ties: lowest index); a dead executor is never chosen while an
        alive one exists, a retry avoids the executor it failed on
        (``exclude``) when another is alive, and an executor a gang holds
        takes no narrow batch."""
        with self._cv:
            free = [ex for ex in self._executors
                    if ex.index not in self._wide_reserved]
            cands = ([ex for ex in free if ex.has_capacity]
                     or [ex for ex in free if not ex.dead])
            if exclude is not None:
                cands = [ex for ex in cands if ex.index != exclude] or cands
            if not cands and any(not ex.dead for ex in self._executors):
                # every live executor is held by a gang: not a failure,
                # the batch comes back when the gang releases
                self._push_retry_locked(queue_name, pb, delay=0.001,
                                        exclude=exclude)
                return
            if not cands:          # whole pool dead: nothing can run this
                reqs = self._take_requests_locked(pb)
                self.stats.record_failure(queue=queue_name, failed=len(reqs))
            else:
                ex = min(cands, key=lambda e: (e.backlog, e.index))
                pb.dispatch_id = self._dispatch_seq
                self._dispatch_seq += 1
                self._inflight[pb.dispatch_id] = _Inflight(
                    queue=queue_name, batch=pb, ex=ex,
                    t_placed=time.perf_counter())
                for it in pb.items:
                    it.payload.dispatched = True
        if not cands:
            exc = ExecutorDead("no live executor to run batch",
                               request_ids=tuple(r.req_id for r in reqs))
            for req in reqs:
                _resolve(req.future, exc=exc)
            return
        ex.submit(queue_name, pb)

    def _shed_one_locked(self, req: _Request, reason: str
                         ) -> Optional[Tuple[_Request, BaseException]]:
        """Pop an expired request from the registry (under cv): what to
        resolve it with, or None when it was resolved elsewhere."""
        if self._requests.pop(req.req_id, None) is None:
            return None
        self._pending -= 1
        self._pending_by_queue[req.queue] -= 1
        self.stats.record_failure(queue=req.queue, shed=1, failed=1)
        return req, DeadlineExceeded(reason, request_ids=(req.req_id,))

    def _shed_scheduler_locked(self, now: float
                               ) -> List[Tuple[_Request, BaseException]]:
        """Shed expired graphs still held by the scheduler (under cv)."""
        if not self._deadlines_used:
            return []

        def expired(it: PackItem) -> bool:
            dt = it.payload.deadline_t
            return dt is not None and dt <= now

        out = [f for f in (self._shed_one_locked(
            it.payload, "deadline expired before dispatch")
            for _, it in self._scheduler.shed(expired)) if f is not None]
        if self._wide_queue:
            # wide requests waiting for a gang are sheddable too
            keep: List[_WideRequest] = []
            for wreq in self._wide_queue:
                dt = wreq.req.deadline_t
                if dt is None or dt > now:
                    keep.append(wreq)
                    continue
                f = self._shed_one_locked(
                    wreq.req, "deadline expired before a gang window opened")
                if f is not None:
                    out.append(f)
            self._wide_queue[:] = keep
        if out:
            self._cv.notify_all()
        return out

    def _shed_batch_locked(self, pb: PackedBatch, now: float
                           ) -> Tuple[Optional[PackedBatch],
                                      List[Tuple[_Request, BaseException]]]:
        """Shed expired members of a batch about to dispatch (under cv).
        Survivors keep the sealed bucket (``subset``), so the bucket's
        program serves them and their answers do not change. ``(None,
        fails)`` when every member expired."""
        if not self._deadlines_used:
            return pb, []
        live: List[PackItem] = []
        fails: List[Tuple[_Request, BaseException]] = []
        for it in pb.items:
            req = it.payload
            if req.deadline_t is not None and req.deadline_t <= now:
                f = self._shed_one_locked(req,
                                          "deadline expired before dispatch")
                if f is not None:
                    fails.append(f)
            else:
                live.append(it)
        if not fails and len(live) == len(pb.items):
            return pb, []
        self._cv.notify_all()
        if not live:
            return None, fails
        sub = pb.subset(live)
        sub.requeues = pb.requeues
        return sub, fails

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
            stranded = self._scheduler.flush_all()
            stranded.extend((qn, pb) for _, _, qn, pb, _ in self._retry_heap)
            self._retry_heap.clear()
            victims: List[_Request] = []
            for _, pb in stranded:
                victims.extend(self._take_requests_locked(pb))
            for wreq in self._wide_queue:
                req = self._requests.pop(wreq.req.req_id, None)
                if req is not None:
                    self._pending -= 1
                    self._pending_by_queue[req.queue] -= 1
                    victims.append(req)
            self._wide_queue.clear()
            if victims:
                self.stats.record_failure(failed=len(victims))
            self._cv.notify_all()
        for req in victims:
            _resolve(req.future, exc=exc)

    # ------------------------------------------------------------------
    # wide placement: gang scheduling and the gang runner (DESIGN.md §10)
    # ------------------------------------------------------------------

    def _try_reserve_gang_locked(self, now: float
                                 ) -> Optional[List[DeviceExecutor]]:
        """Reserve ``wide_k`` idle executors for a wide request at once, or
        None (the request stays queued). Under ``self._cv``, where the
        executors' ``idle`` and ``dead`` are read. All or nothing: a
        partial hold would deadlock against narrow traffic and against a
        second wide request. While a priority batch could claim an idle
        executor (the preempt window), no gang takes one."""
        if (self._scheduler.preempt_active(now)
                and self._scheduler.priority_ready):
            return None
        avail = [ex for ex in self._executors
                 if not ex.dead and ex.idle
                 and ex.index not in self._wide_reserved]
        if len(avail) < self._wide_k:
            return None
        gang = avail[:self._wide_k]
        self._wide_reserved.update(ex.index for ex in gang)
        return gang

    def _fail_wide_queue_locked(self, reason: str
                                ) -> List[Tuple[_Request, BaseException]]:
        """Fail every queued wide request (under ``self._cv``): the pool
        can no longer form a gang and will not heal (no respawn)."""
        out: List[Tuple[_Request, BaseException]] = []
        for wreq in self._wide_queue:
            req = self._requests.pop(wreq.req.req_id, None)
            if req is None:
                continue
            self._pending -= 1
            self._pending_by_queue[req.queue] -= 1
            self.stats.record_failure(queue=req.queue, failed=1)
            out.append((req, ExecutorDead(
                f"wide placement impossible: {reason}",
                request_ids=(req.req_id,))))
        self._wide_queue.clear()
        if out:
            self._cv.notify_all()
        return out

    def _ensure_wide_program(self, plan: WidePlan,
                             gang: List[DeviceExecutor], stacked, params):
        """The wide program of (the plan's ``WideBucket``, the gang, the
        input widths), built on its first graph ``stacked`` under the
        compile lock: the reference's one program per bucket extended to
        gangs. A gang on one card gets a ``CapturedWideProgram`` in the
        leader's graph pool on ``params``, the leader's resident tree; any
        other gang an ``EagerWideProgram``."""
        bucket = plan.bucket
        widths = (stacked["node_feat"].shape[-1],
                  stacked["edge_feat"].shape[-1],
                  stacked["node_pos"].shape[-1])
        # executors, not indices: a respawned member has a new stream and
        # a new resident tree
        key = (bucket, tuple(id(ex) for ex in gang), widths)
        prog = self._wide_programs.get(key)
        if prog is not None:
            return prog
        with self._compile_lock:
            prog = self._wide_programs.get(key)
            if prog is not None:
                return prog
            leader = gang[0]
            fwd = build_wide_forward(
                self.cfg, bucket,
                wide_mesh([ex.device for ex in gang],
                          [ex.stream for ex in gang]), self.dataflow)
            if fwd.gang.one_card:
                if leader.pool is None:
                    leader.pool = torch.cuda.graph_pool_handle()
                try:
                    prog = CapturedWideProgram(
                        fwd, params, stacked, pool=leader.pool,
                        stream=leader.stream,
                        warm_stream=leader.warm_stream)
                except Exception:
                    # a capture that failed may leave its pool recording
                    leader.pool = torch.cuda.graph_pool_handle()
                    raise
            else:
                prog = EagerWideProgram(fwd)
            self._wide_programs[key] = prog
            return prog

    def _serve_wide(self, plan: WidePlan, gang: List[DeviceExecutor],
                    pinned: List[Tuple[Any, int]], stacked
                    ) -> Tuple[np.ndarray, Optional[float]]:
        """One wide graph on its reserved gang: (the output on the host,
        the replay's span on a card, else None). On a card the program
        reads the leader's resident tree, into which the version the
        request pinned is first copied on the leader's stream (as a
        dispatch does); elsewhere each shard runs its member's pinned
        tree. The passes over the edges of one shard are recorded under
        ``("wide", k, n_pad, e_pad)``."""
        leader = gang[0]
        one_card = leader.device.type == "cuda" and all(
            ex.device == leader.device for ex in gang)
        with leader.on_device():
            if one_card:
                params: Any = leader._load(*pinned[0])
            else:
                params = [p for p, _ in pinned]
            prog = self._ensure_wide_program(plan, gang, stacked, params)
            out, span = prog.run(stacked, params)
        if prog.edge_passes is not None:
            b = plan.bucket
            self.edge_passes.setdefault(("wide", b.k, b.n_pad, b.e_pad),
                                        prog.edge_passes)
        return out, span

    def _run_wide(self, wreq: _WideRequest,
                  gang: List[DeviceExecutor]) -> None:
        """Run one wide request on its reserved gang (on its own thread).

        A gang member's death before, during or after the run invalidates
        the whole gang, so the request requeues intact (bounded by the
        requeue budget; the placer forms a gang of survivors). A transient
        failure with the gang healthy retries like a narrow batch until
        ``max_retries``, then fails with ``BatchFailed``. A non-finite
        answer is ``PoisonGraph``. Every future resolves once, through the
        request registry. The gang is released after the answer is on the
        host."""
        req, plan = wreq.req, wreq.plan
        resolved: Optional[Tuple[Future, Any,
                                 Optional[BaseException]]] = None
        try:
            t_dispatch = time.perf_counter()
            with self._cv:
                if req.req_id not in self._requests:
                    return             # shed or abandoned while queued
                req.dispatched = True  # past the shedding window
                # one (params, version) read a member, as a dispatch pins
                pinned = [ex._params_v for ex in gang]
            err: Optional[BaseException] = None
            out_np, span = None, None
            if not any(ex.dead for ex in gang):
                try:
                    stacked = stack_shard_arrays(
                        plan, wreq.node_feat, wreq.edge_feat, wreq.node_pos)
                    out_np, span = self._serve_wide(plan, gang, pinned,
                                                    stacked)
                except Exception as exc:
                    err = exc
            t_done = time.perf_counter()

            if any(ex.dead for ex in gang):
                # a member died: requeue the whole request on survivors
                with self._cv:
                    alive = sum(1 for ex in self._executors if not ex.dead)
                    if (not (self._stopped or self._closed)
                            and (alive >= self._wide_k or self._respawn)
                            and wreq.requeues < self._max_requeues
                            and req.req_id in self._requests):
                        wreq.requeues += 1
                        req.dispatched = False     # sheddable again
                        self.stats.record_failure(queue=req.queue,
                                                  retries=1)
                        self._wide_queue.append(wreq)
                        self._cv.notify_all()
                        return
                    if self._requests.pop(req.req_id, None) is None:
                        return
                    self._pending -= 1
                    self._pending_by_queue[req.queue] -= 1
                    self.stats.record_failure(queue=req.queue, failed=1)
                    self._cv.notify_all()
                failure: EngineError = ExecutorDead(
                    "gang member died and the wide graph could not be "
                    "re-placed", request_ids=(req.req_id,))
                failure.__cause__ = err
                resolved = (req.future, None, failure)
                return

            if err is not None:
                # the gang is healthy and the program failed: retry
                with self._cv:
                    if (not (self._stopped or self._closed)
                            and wreq.attempts < self._max_retries
                            and req.req_id in self._requests):
                        # forming a gang again spaces the retries
                        wreq.attempts += 1
                        req.dispatched = False
                        self.stats.record_failure(queue=req.queue,
                                                  retries=1)
                        self._wide_queue.append(wreq)
                        self._cv.notify_all()
                        return
                    if self._requests.pop(req.req_id, None) is None:
                        return
                    self._pending -= 1
                    self._pending_by_queue[req.queue] -= 1
                    self.stats.record_failure(queue=req.queue, failed=1)
                    self._cv.notify_all()
                failure = BatchFailed(
                    f"wide graph failed after {wreq.attempts + 1} "
                    f"attempts: {err}", request_ids=(req.req_id,))
                failure.__cause__ = err
                resolved = (req.future, None, failure)
                return

            result = (np.array(out_np[0]) if self.cfg.task == "graph"
                      else np.array(out_np[:plan.n_nodes]))
            with self._cv:
                if self._requests.pop(req.req_id, None) is None:
                    return             # abandoned mid-run: drop the answer
                self._pending -= 1
                self._pending_by_queue[req.queue] -= 1
                if (self._validate_outputs
                        and not bool(np.all(np.isfinite(result)))):
                    self.stats.record_failure(queue=req.queue,
                                              quarantined=1, failed=1)
                    resolved = (req.future, None, PoisonGraph(
                        "non-finite wide output quarantined by the "
                        "validation gate", request_ids=(req.req_id,)))
                else:
                    if req.record:
                        self.stats.record_batch(
                            latencies=[t_done - wreq.t_arrival],
                            queue_waits=[t_dispatch - wreq.t_arrival],
                            device_s=(span if span is not None
                                      else t_done - t_dispatch),
                            batch_size=1, t_dispatch=t_dispatch,
                            t_done=t_done, queue=req.queue,
                            device=f"wide[{len(gang)}]")
                    resolved = (req.future, result, None)
                self._cv.notify_all()
        finally:
            with self._cv:
                self._wide_reserved.difference_update(
                    ex.index for ex in gang)
                self._wide_running -= 1
                self._cv.notify_all()
            if resolved is not None:
                _resolve(*resolved)

    # ------------------------------------------------------------------
    # executor callbacks (dispatch threads / complete threads)
    # ------------------------------------------------------------------

    def _make_executor(self, device, index: int, params) -> DeviceExecutor:
        # a respawn after a hot reload pins the CURRENT version, not 0
        return DeviceExecutor(
            device=device, index=index, params=params,
            version=self._param_version,
            program_fn=self._ensure_program,
            unpack_fn=self._unpack,
            on_complete=self._handle_completion,
            on_fatal=self._handle_fatal,
            fault_hook=(self._faults.executor_hook
                        if self._faults is not None else None))

    def _handle_completion(self, ex: DeviceExecutor,
                           done: CompletedBatch) -> None:
        pb = done.batch
        with self._cv:
            if pb.dispatch_id is not None:
                if self._inflight.pop(pb.dispatch_id, None) is None:
                    return      # superseded (watchdog, drain timeout, close)
        if done.err is None:
            self._complete_ok(ex, done)
        else:
            self._complete_err(ex, done)

    def _complete_ok(self, ex: DeviceExecutor, done: CompletedBatch) -> None:
        pb = done.batch
        resolved = []          # (future, result, exc)
        tripped = False        # this batch tripped the NaN gate
        invalidate = False     # the breaker moved a rung: drop the programs
        with self._cv:
            lat, qw = [], []
            for i, it in enumerate(pb.items):
                req = self._requests.pop(it.payload.req_id, None)
                if req is None:
                    continue   # resolved elsewhere (shed, abandoned)
                self._pending -= 1
                self._pending_by_queue[req.queue] -= 1
                out = done.results[i]
                if (self._validate_outputs
                        and not bool(np.all(np.isfinite(out)))):
                    # the NaN gate: a non-finite answer is quarantined at
                    # the graph, never returned
                    self.stats.record_failure(queue=req.queue,
                                              quarantined=1, failed=1)
                    resolved.append((req.future, None, PoisonGraph(
                        "non-finite output quarantined by validation gate",
                        request_ids=(req.req_id,), executor_index=ex.index)))
                    tripped = True
                    continue
                if req.record:
                    lat.append(done.t_ready - it.t_arrival)
                    qw.append(done.t_build_start - it.t_arrival)
                resolved.append((req.future, out, None))
            if lat:
                self.stats.record_batch(
                    latencies=lat, queue_waits=qw, device_s=done.device_s,
                    batch_size=len(lat), t_dispatch=done.t_dispatch,
                    t_done=done.t_ready, queue=done.queue, device=ex.label)
            now = done.t_ready
            h = self._bucket_health.get(pb.bucket)
            was_probing = h is not None and h.probing
            if tripped:
                # a NaN-making impl and a NaN-making graph look the same
                # from here: demote a rung either way
                invalidate = self._record_trip_locked(pb.bucket, "nan_gate",
                                                      now)
            else:
                if self._audit_q is not None:
                    # a probing bucket is always audited (the probe's
                    # verdict), a healthy one sampled; ``was_probing`` is
                    # read before any promotion below, so the batch that
                    # only triggers a probe is not its verdict
                    if (was_probing
                            or self._audit_rng.random() < self._audit_rate):
                        try:
                            self._audit_q.put_nowait(
                                (pb, list(done.results),
                                 done.params_version, was_probing))
                            self._audits_enqueued += 1
                        except queue_lib.Full:
                            self.stats.audit_dropped += 1
                elif was_probing:
                    # no auditor: a clean completion is the best verdict
                    h.probing = False
                invalidate = self._maybe_probe_locked(pb.bucket, now)
            retune_reason = self._observe_bucket_locked(pb, done)
            self._cv.notify_all()
        for fut, res, exc in resolved:
            _resolve(fut, res, exc)
        if invalidate:
            self._invalidate_programs(pb.bucket)
        if retune_reason is not None:
            self._trigger_retune(pb.bucket)

    def _complete_err(self, ex: DeviceExecutor, done: CompletedBatch) -> None:
        """Classify a failed batch: requeue (executor death), retry with
        backoff (transient), bisect (retries spent, more than one graph) or
        quarantine (one graph, retries spent: ``PoisonGraph``)."""
        pb, err = done.batch, done.err
        # a death says nothing of the batch: requeue it on the survivors
        is_death = (isinstance(err, ExecutorDead)
                    or not isinstance(err, Exception))
        with self._cv:
            alive = any(not e.dead for e in self._executors)
            retryable = not (self._stopped or self._closed) and alive
            if is_death and retryable and pb.requeues < self._max_requeues:
                pb.requeues += 1
                self.stats.record_failure(queue=done.queue, retries=1)
                self._push_retry_locked(done.queue, pb, delay=0.0,
                                        exclude=ex.index)
                return
            if not is_death and retryable:
                if pb.attempts < self._max_retries:
                    pb.attempts += 1
                    self.stats.record_failure(queue=done.queue, retries=1)
                    self._push_retry_locked(
                        done.queue, pb, delay=self._backoff(pb.attempts),
                        exclude=ex.index)
                    return
                if pb.num_graphs > 1:
                    # bisection: both halves keep the bucket (its program
                    # serves them, nothing is built) and the spent attempts,
                    # so the poison graph is alone in log2(batch) steps and
                    # every other answer is what the fault-free run gives
                    left, right = pb.split()
                    self.stats.record_failure(queue=done.queue, retries=2)
                    delay = self._backoff(1)
                    for half in (left, right):
                        self._push_retry_locked(done.queue, half,
                                                delay=delay,
                                                exclude=ex.index)
                    return
            reqs = self._take_requests_locked(pb)
            if not reqs:
                return
            ids = tuple(r.req_id for r in reqs)
            if (not is_death and pb.num_graphs == 1
                    and pb.attempts >= self._max_retries):
                failure: EngineError = PoisonGraph(
                    f"graph failed after {pb.attempts + 1} attempts: {err}",
                    request_ids=ids, executor_index=ex.index)
                self.stats.record_failure(queue=done.queue, quarantined=1,
                                          failed=1)
            elif is_death:
                failure = ExecutorDead(
                    f"executor died and work could not be re-placed: {err}",
                    request_ids=ids, executor_index=ex.index)
                self.stats.record_failure(queue=done.queue, failed=len(reqs))
            else:
                failure = BatchFailed(
                    f"batch failed with retries exhausted: {err}",
                    request_ids=ids, executor_index=ex.index)
                self.stats.record_failure(queue=done.queue, failed=len(reqs))
            failure.__cause__ = err
        for req in reqs:
            _resolve(req.future, exc=failure)

    def _backoff(self, attempts: int) -> float:
        """Bounded exponential backoff for attempt N (1-based)."""
        return min(self._retry_backoff_s * (2.0 ** (attempts - 1)),
                   self._retry_backoff_max_s)

    def _push_retry_locked(self, queue: str, pb: PackedBatch, *,
                           delay: float, exclude: Optional[int]) -> None:
        pb.dispatch_id = None
        for it in pb.items:
            it.payload.dispatched = False    # sheddable again until placed
        heapq.heappush(self._retry_heap,
                       (time.perf_counter() + delay, self._retry_seq,
                        queue, pb, exclude))
        self._retry_seq += 1
        self._cv.notify_all()

    def _handle_fatal(self, ex: DeviceExecutor, exc: BaseException) -> None:
        """An executor's worker loop died: the executor failed what it held
        (those batches come back through ``_complete_err`` as requeues);
        supervision takes it out of the pool."""
        self._supervise(ex)

    def _supervise(self, ex: DeviceExecutor) -> None:
        """Take a dead executor out of rotation; with ``respawn_executors``
        put a fresh one (a new parameter replica at the current version,
        new stream, pool and threads, no programs) in its slot. Runs on the
        dying worker thread or the watchdog; once per executor. The dead
        executor stays referenced (``_dead_executors``): its programs and
        graph pool are never freed while its stream may still run them.
        When every executor is dead and none respawns, the engine closes
        and fails everything outstanding."""
        with self._cv:
            if id(ex) in self._supervised:
                return
            self._supervised.add(id(ex))
            self._dead_executors.append(ex)
            self.stats.executor_deaths += 1
            self.stats.pool_degraded = True
            do_respawn = self._respawn and not self._stopped
            self._cv.notify_all()
        if do_respawn and self._respawn_into(ex):
            return
        with self._cv:
            if any(not e.dead for e in self._executors):
                self._cv.notify_all()
                return
            self._closed = True
            victims = self._abandon_outstanding_locked()
        exc = ExecutorDead("every executor died",
                           request_ids=tuple(r.req_id for r in victims))
        for req in victims:
            _resolve(req.future, exc=exc)

    def _respawn_into(self, ex: DeviceExecutor) -> bool:
        """Put a fresh executor in dead ``ex``'s slot; False if that fails.
        Under the update lock, so that its replica and version are one
        version's and a later ``update_params`` stages onto it; under the
        compile lock, so that the replica's copy meets no capture."""
        try:
            with self._update_lock, self._compile_lock:
                with self._cv:
                    host = self._params_by_version[self._param_version]
                fresh = self._make_executor(
                    ex.device, ex.index,
                    replicate_params(host, [ex.device])[0])
                fresh.start()
                with self._cv:
                    self._executors[ex.index] = fresh
                    self.stats.respawns += 1
                    if not any(e.dead for e in self._executors):
                        self.stats.pool_degraded = False
                    self._cv.notify_all()
        except Exception:
            return False           # respawn failed: stay degraded
        return True

    # ------------------------------------------------------------------
    # in-flight watchdog
    # ------------------------------------------------------------------

    def _watchdog_loop(self) -> None:
        """Fail batches stuck inside an executor past the in-flight timeout
        (counted from placement): the executor is marked dead (its other
        queued work requeues on the survivors), the stuck batch's futures
        fail with ``DeadlineExceeded``, and supervision runs. The stuck
        batch leaves the in-flight registry first, so a late completion is
        a registry miss."""
        timeout = self._inflight_timeout_s
        interval = max(min(timeout / 4.0, 0.25), 1e-3)
        while not self._watchdog_stop.wait(interval):
            with self._cv:
                if self._stopped:
                    return
                now = time.perf_counter()
                stuck = [entry for entry in self._inflight.values()
                         if now - entry.t_placed > timeout]
                for entry in stuck:
                    self._inflight.pop(entry.batch.dispatch_id, None)
            for entry in stuck:
                entry.ex.mark_dead(ExecutorDead(
                    "executor exceeded the in-flight timeout",
                    executor_index=entry.ex.index))
                with self._cv:
                    reqs = self._take_requests_locked(entry.batch)
                    if reqs:
                        self.stats.record_failure(queue=entry.queue,
                                                  failed=len(reqs))
                exc = DeadlineExceeded(
                    f"batch stuck in flight > {timeout:.3f}s",
                    request_ids=tuple(r.req_id for r in reqs),
                    executor_index=entry.ex.index)
                for req in reqs:
                    _resolve(req.future, exc=exc)
                self._supervise(entry.ex)

    def _split_outputs(self, pb: PackedBatch, out_np: np.ndarray
                       ) -> List[np.ndarray]:
        """Per-graph rows of the packed output, copied so that buffers
        detach: a node-level task's rows by ``graph_offsets``, a
        graph-level task's by slot. The serving path and the auditor's
        mirror slice alike."""
        if self.cfg.task == "node":
            offs = pb.graph_offsets()
            return [np.array(out_np[offs[i]:offs[i + 1]])
                    for i in range(pb.num_graphs)]
        return [np.array(out_np[i]) for i in range(pb.num_graphs)]

    def _unpack(self, pb: PackedBatch, out_np: np.ndarray
                ) -> List[np.ndarray]:
        res = self._split_outputs(pb, out_np)
        if self._faults is not None:
            # chaos: NaN corruption lands between the read-back and the NaN
            # gate, and a broken impl's epsilon when it served this bucket
            res = self._faults.corrupt_outputs(
                pb, res, impl=self._served_impl.get(pb.bucket))
        return res

    # ------------------------------------------------------------------
    # shadow auditor: sampled re-execution on the CPU mirror (§9)
    # ------------------------------------------------------------------

    def _audit_reference(self):
        """The unfused mirror (``impl='unfused', single_pass=False``) as a
        callable on (params, batch): the ladder's floor and what every
        audit and canary is held to. It runs on the CPU."""
        fn = self._audit_ref
        if fn is None:
            apply, cfg = self.model.apply, self.cfg
            mirror = self.dataflow.replace(impl="unfused", single_pass=False)

            def fn(params, graph: GraphBatch) -> torch.Tensor:
                with torch.inference_mode():
                    return apply(params, graph, cfg, mirror)
            self._audit_ref = fn
        return fn

    def _audit_loop(self) -> None:
        while True:
            entry = self._audit_q.get()
            if entry is None:
                return
            t0 = time.perf_counter()
            try:
                self._audit_one(*entry)
            except Exception:
                with self._cv:
                    self.stats.audit_dropped += 1
            finally:
                with self._cv:
                    self.audit_seconds += time.perf_counter() - t0
                    self._audits_done += 1
                    self._cv.notify_all()

    def _audit_one(self, pb: PackedBatch, served: List[np.ndarray],
                   pver: int, probe: bool = False) -> None:
        """Run one sampled batch again on the CPU mirror, from its host
        arrays and under the host copy of the params version that served
        it, and compare what was SERVED (after any fault corruption: what
        the callers saw) with it. Off the card's streams. A clean verdict
        confirms an open probe only for a batch served at the probed rung
        (``probe``): the batch whose completion opened the probe ran on the
        rung below."""
        params = self._params_by_version.get(pver)
        if params is None:             # that version was retired: skip
            with self._cv:
                self.stats.audit_dropped += 1
            return
        g = pb.build(pos_dim=self.cfg.pos_dim, device=CPU)
        out = self._audit_reference()(params, g).numpy()
        ref = self._split_outputs(pb, out)
        mismatch = False
        for i in range(pb.num_graphs):
            got = np.asarray(served[i])
            if not bool(np.all(np.isfinite(got))):
                continue               # the NaN gate owns non-finite rows
            if not np.allclose(got, ref[i], rtol=self._audit_rtol,
                               atol=self._audit_atol):
                mismatch = True
                break
        invalidate = False
        with self._cv:
            self.stats.audits += 1
            if mismatch:
                self.stats.audit_mismatches += 1
                invalidate = self._record_trip_locked(
                    pb.bucket, "audit_mismatch", time.perf_counter())
            elif probe:
                h = self._bucket_health.get(pb.bucket)
                if h is not None and h.probing:
                    h.probing = False  # the probe is confirmed
            self._cv.notify_all()
        if invalidate:
            self._invalidate_programs(pb.bucket)

    def flush_audits(self, timeout: Optional[float] = None) -> bool:
        """Block until every audit enqueued so far has been judged. Returns
        False on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._audits_done >= self._audits_enqueued, timeout)

    # ------------------------------------------------------------------
    # hot parameter reload: versioned replicas, canary, rollback (§9)
    # ------------------------------------------------------------------

    def update_params(self, new_params, *, canary: bool = True) -> int:
        """Install ``new_params`` across the pool without draining it.

        Each dispatch pins its executor's ``(params, version)``: batches
        dispatched before the swap run the old weights and later ones the
        new, every future resolves once. A bucket's captured program copies
        a new version into the tensors it was captured on, on its
        executor's stream just before the replay that first runs it: no
        bucket is captured again. With ``canary=True`` every staged replica
        must first serve a probe batch (the default dataflow's eager
        forward, on the replica's device) finite and close to the CPU
        mirror under the new params; otherwise ``ParamUpdateFailed`` is
        raised and the previous version keeps serving untouched. A tree of
        another structure, shape or dtype is refused the same way. Returns
        the new version number.
        """
        if self._closed:
            raise EngineClosed("engine is closed")
        with self._update_lock:        # one update at a time
            reason = params_compatible(
                self._params_by_version[self._param_version], new_params)
            if reason is not None:
                with self._cv:
                    self.stats.param_rollbacks += 1
                raise ParamUpdateFailed(reason)
            with self._cv:
                alive = [ex for ex in self._executors if not ex.dead]
            if not alive:
                with self._cv:
                    self.stats.param_rollbacks += 1
                raise ParamUpdateFailed("no live executor to stage onto")
            # staged and canaried under the compile lock: the copies end in
            # a device synchronize, which must not meet a capture
            with self._compile_lock:
                host = replicate_params(new_params, [CPU])[0]
                replicas = replicate_params(new_params,
                                            [ex.device for ex in alive])
                own = next((rep for ex, rep in zip(alive, replicas)
                            if ex.device == self.device), None)
                if own is None:
                    own = replicate_params(host, [self.device])[0]
                err = (self._run_canary(host, alive, replicas) if canary
                       else None)
            if err is not None:
                with self._cv:
                    self.stats.param_rollbacks += 1
                raise ParamUpdateFailed(
                    f"canary failed, previous params kept: {err}")
            with self._cv:
                self._param_version += 1
                version = self._param_version
                self._params_by_version[version] = host
                while len(self._params_by_version) > 2:
                    # the previous version serves in-flight batches and
                    # late audits; anything older can no longer be live
                    del self._params_by_version[
                        min(self._params_by_version)]
                for ex, rep in zip(alive, replicas):
                    ex.set_params(rep, version)
                self.params = own
                self.stats.param_updates += 1
                self._cv.notify_all()
            return version

    def _run_canary(self, host, alive, replicas) -> Optional[str]:
        """Why the staged params fail, or None: the probe batch through the
        CPU mirror under ``host`` must be finite, and through the default
        dataflow's eager forward on each replica (on its executor's
        device) finite and close to the mirror. Runs under the compile
        lock, so that it never overlaps a capture."""
        if not _finite(host):
            return "non-finite parameter values"
        try:
            ref = self._audit_reference()(host, self._probe_batch(CPU))
        except Exception as exc:
            return f"reference eval failed: {exc}"
        ref = ref.numpy()
        if not bool(np.all(np.isfinite(ref))):
            return "mirror outputs are non-finite under the new params"
        with self._compile_lock:
            run = self._canary_run
            if run is None:
                run = self._canary_run = self._make_run(self.dataflow)
            for ex, rep in zip(alive, replicas):
                try:
                    with (torch.cuda.device(ex.device)
                          if ex.device.type == "cuda" else nullcontext()):
                        out = run(rep, self._probe_batch(ex.device))
                        out = out.cpu().numpy()
                except Exception as exc:
                    return f"canary batch failed on {ex.label}: {exc}"
                if not bool(np.all(np.isfinite(out))):
                    return f"canary outputs non-finite on {ex.label}"
                if not np.allclose(out, ref, rtol=self._audit_rtol,
                                   atol=self._audit_atol):
                    return f"canary diverges from the mirror on {ex.label}"
        return None

    def _probe_batch(self, device: torch.device) -> GraphBatch:
        """A small fixed ring graph with non-trivial features in the
        smallest bucket, on ``device``: wrong params move its outputs (an
        all-zeros batch would pass any canary)."""
        rng = np.random.default_rng(0x9E3779B9)
        b0 = self.buckets[0]
        n = min(8, b0)
        nf = rng.standard_normal(
            (n, self.cfg.node_feat_dim)).astype(np.float32)
        snd = np.arange(n, dtype=np.int32)
        rcv = np.roll(snd, -1).astype(np.int32)
        ef = (rng.standard_normal(
            (n, self.cfg.edge_feat_dim)).astype(np.float32)
            if self.cfg.edge_feat_dim != 1 else None)
        return build_graph_batch(
            nf, snd, rcv, edge_feat=ef, node_pad=b0,
            edge_pad=pad_bucket(2 * b0, self.buckets), graph_pad=1,
            pos_dim=self.cfg.pos_dim, device=device)

    # ------------------------------------------------------------------
    # drift detection -> bounded retune (§5)
    # ------------------------------------------------------------------

    def _observe_bucket_locked(self, pb: PackedBatch,
                               done: CompletedBatch) -> Optional[str]:
        """Fold one completed batch into its bucket's running stats (under
        ``self._cv``) and decide whether its traffic has drifted out of the
        envelope it was tuned in: the drift's reason when a retune should
        fire (``_trigger_retune``, outside the lock), else None. The retune
        budget is spent here, under the lock, so that two completions of
        one bucket never both trigger."""
        key = pb.bucket
        load = self._bucket_load.setdefault(key, _BucketLoad())
        a = 2.0 / (self._drift_window + 1.0)

        def ewma(old: Optional[float], new: float) -> float:
            return new if old is None else (1.0 - a) * old + a * new

        load.batches += 1
        load.graphs += pb.num_graphs
        load.batches_since_tune += 1
        fill = float(pb.num_graphs)
        load.ewma_fill = ewma(load.ewma_fill, fill)
        if done.device_s > 0:
            load.ewma_device_s = ewma(load.ewma_device_s, done.device_s)
        if load.last_seen_t is not None:
            load.ewma_gap_s = ewma(load.ewma_gap_s,
                                   done.t_ready - load.last_seen_t)
        load.last_seen_t = done.t_ready
        if load.tuned_fill is None:
            # the first batch after a (re)tune anchors the envelope's mix
            load.tuned_fill = fill

        if not self._autotune or key not in self._tuned:
            return None            # nothing tuned: nothing to retune
        if (load.retunes >= self._max_retunes
                or load.batches_since_tune < self._drift_window
                or done.t_ready - load.last_tune_t < self._drift_cooldown_s):
            return None
        reason = None
        if (load.tuned_device_s is not None
                and load.ewma_device_s is not None
                and load.ewma_device_s
                > self._drift_device_factor * load.tuned_device_s):
            reason = "device_time"
        elif (load.tuned_fill is not None and load.ewma_fill is not None
              and not (load.tuned_fill / self._drift_fill_factor
                       <= load.ewma_fill
                       <= load.tuned_fill * self._drift_fill_factor)):
            reason = "batch_mix"
        if reason is None:
            return None
        load.retunes += 1
        load.last_tune_t = done.t_ready
        load.batches_since_tune = 0
        load.tuned_fill = None
        load.tuned_device_s = None
        load.last_reason = reason
        self.stats.retunes += 1
        return reason

    def _trigger_retune(self, key: BucketKey) -> None:
        """Drop a drifted bucket's winner and move every executor's programs
        of it to ``retired`` (as ``_invalidate_programs`` does): the next
        batch of the bucket runs the autotune search again on current
        traffic. The bucket stays servable: a dispatch that misses builds
        as on a first sight, and a batch already enqueued on the old
        program finishes on it."""
        with self._compile_lock:
            self._tuned.pop(key, None)
            self._retire_bucket(key)

    # ------------------------------------------------------------------
    # circuit breaker: the degradation ladder and cooldown probes (§9)
    # ------------------------------------------------------------------

    @staticmethod
    def _impl_rung(df: DataflowConfig) -> int:
        """A dataflow's rung on the ladder (0: a fused kernel per layer or
        per aggregation; ``_JNP_RUNG``: the unfused mirror)."""
        if df.impl in ("fused_layer", "kernel"):
            return 0
        if df.impl in ("pipeline", "banked"):
            return 1
        if df.impl == "unfused" and not df.single_pass:
            return _JNP_RUNG
        return 2                       # the single-pass plain forms

    def _ladder_df(self, base: DataflowConfig, rung: int) -> DataflowConfig:
        """``base`` demoted to ``rung`` (clamped to the floor: the unfused
        mirror on the CPU, the pipeline on a GPU); a rung at or above the
        base's own is the base: demotion only strips."""
        rung = min(int(rung), self._floor)
        if rung <= self._impl_rung(base):
            return base
        if rung == 1:
            return base.replace(impl="pipeline")
        if rung == 2:
            return base.replace(impl="fused", single_pass=True)
        return base.replace(impl="unfused", single_pass=False)

    def _base_df(self, key: BucketKey) -> DataflowConfig:
        """Rung 0 of ``key``'s ladder: its tuned winner, else the engine's
        configured dataflow."""
        return self._tuned.get(key, self.dataflow)

    def _effective_df(self, key: BucketKey, df: DataflowConfig
                      ) -> DataflowConfig:
        """The dataflow ``key`` serves on: ``df`` (its rung 0) demoted by
        the bucket's breaker level."""
        h = self._bucket_health.get(key)
        if not self._breaker or h is None or h.level == 0:
            return df
        return self._ladder_df(df, self._impl_rung(df) + h.level)

    def _record_trip_locked(self, key: BucketKey, reason: str,
                            now: float) -> bool:
        """One breaker trip of ``key`` (under ``self._cv``); True when it
        demoted a rung (the caller then drops the bucket's programs,
        outside the lock)."""
        if not self._breaker:
            return False
        h = self._bucket_health.setdefault(key, _BucketHealth())
        h.trips += 1
        h.last_trip_t = now
        h.last_reason = reason
        h.probing = False              # a trip ends any open probe
        if self._impl_rung(self._base_df(key)) + h.level >= self._floor:
            return False               # already serving the floor
        h.level += 1
        self.stats.breaker_trips += 1
        return True

    def _maybe_probe_locked(self, key: BucketKey, now: float) -> bool:
        """Half-open the breaker after a quiet cooldown: promote one rung
        and mark the bucket probing (under ``self._cv``). True when it
        promoted (the caller drops the bucket's programs)."""
        h = self._bucket_health.get(key)
        if (not self._breaker or h is None or h.level == 0 or h.probing
                or h.probes >= self._breaker_max_probes
                or now - h.last_trip_t < self._breaker_cooldown_s):
            return False
        h.level -= 1
        h.probes += 1
        h.probing = True
        h.last_trip_t = now            # re-arm the cooldown
        self.stats.breaker_probes += 1
        return True

    def _invalidate_programs(self, key: BucketKey) -> None:
        """Drop every executor's programs of bucket ``key``, so that the
        next dispatch builds it at the bucket's current rung. Unlike
        ``_trigger_retune`` the tuned winner stays: the breaker moves along
        the ladder from it, and a healed bucket comes back to it."""
        with self._compile_lock:
            self._retire_bucket(key)

    def _retire_bucket(self, key: BucketKey) -> None:
        """Move every executor's programs of bucket ``key`` to its
        ``retired`` list (under the compile lock). A batch in flight keeps
        its program alive until it is waited for; the executor holds the
        dropped ones until its dispatch thread next builds with the pipe
        drained."""
        for ex in self._executors:
            for pkey in [k for k in ex.compiled if k[0] == key]:
                ex.retired.append(ex.compiled.pop(pkey))
                ex.touched.pop(pkey, None)

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
        sight of the bucket from its first batch ``graph``, at the bucket's
        breaker rung: the twin of the reference's ``_ensure_program``.
        With ``autotune`` and no winner for the bucket yet, the candidates
        are built and timed first (``_run_autotune``) and the winner's own
        program is kept; other executors build only the winner. On the CPU,
        when a rung fails to build, the breaker trips (``build_failure:
        ...``) and the next rung down is built. On a GPU a capture that
        raises fails the batch and trips nothing: a kernel that does not
        build or launch is never hidden by a lower rung. Each program's use
        is stamped in ``ex.touched``; past ``max_cached_programs`` the
        least recently used program of ``ex`` is evicted. Runs on ``ex``'s
        dispatch thread (or the caller's before the threads start), in
        ``ex.on_device()``. A program built at another rung than the
        bucket's current one is never served (the breaker's level is read
        at each dispatch, so a batch dispatched after a trip or a probe
        runs the new rung even before ``_invalidate_programs`` has dropped
        the old program)."""
        pkey = (key, self._widths(graph))
        prog = ex.compiled.get(pkey)
        if (prog is not None and prog.dataflow
                == self._effective_df(key, self._base_df(key))):
            # a plain dict store: the LRU order is approximate across
            # racing dispatch threads, which is fine
            ex.touched[pkey] = next(self._touch)
            return prog
        cuda = ex.device.type == "cuda"
        if cuda:
            # drain this executor's pipe BEFORE taking the lock: a complete
            # thread may need the lock (``_invalidate_programs``) to finish
            # the batches the drain waits for. Only this thread enqueues on
            # the executor, so the pipe stays empty until the capture.
            ex.quiesce()
        with self._compile_lock:
            prog = ex.compiled.get(pkey)
            if prog is not None:
                if prog.dataflow == self._effective_df(key,
                                                       self._base_df(key)):
                    ex.touched[pkey] = next(self._touch)
                    return prog
                ex.retired.append(ex.compiled.pop(pkey))     # another rung
                ex.touched.pop(pkey, None)
            if not ex.dead:
                ex.retired.clear()       # none of them is on the stream
            if cuda and ex.pool is None:
                ex.pool = torch.cuda.graph_pool_handle()
            prog = None
            if self._autotune and key not in self._tuned:
                prog = self._run_autotune(ex, key, pkey, graph)
            if prog is None:
                prog = self._build_on_ladder(ex, key, pkey, graph)
            if prog.edge_passes is not None:
                self.edge_passes.setdefault(key, prog.edge_passes)
            self._served_impl[key] = prog.dataflow.impl
            ex.compiled[pkey] = prog
            ex.touched[pkey] = next(self._touch)
            self._evict_cold_locked(ex, keep=pkey)
            return prog

    def _build_on_ladder(self, ex: DeviceExecutor, key: BucketKey,
                         pkey: ProgramKey, graph: PackedBatch):
        """Build ``key``'s program at its breaker rung (under the compile
        lock); on the CPU a rung that fails to build trips the breaker and
        the next rung down is built."""
        cuda = ex.device.type == "cuda"
        while True:
            eff = self._effective_df(key, self._base_df(key))
            try:
                return self._new_program(ex, key, pkey, graph, eff,
                                         self.edge_passes)
            except Exception as exc:
                if cuda:
                    # a capture that failed may leave its pool recording:
                    # later captures take a fresh one
                    ex.pool = torch.cuda.graph_pool_handle()
                if (cuda or not self._breaker
                        or self._impl_rung(eff) >= self._floor):
                    raise
                with self._cv:
                    self._record_trip_locked(
                        key, f"build_failure: {type(exc).__name__}: "
                        f"{exc}", time.perf_counter())

    def _new_program(self, ex: DeviceExecutor, key: BucketKey,
                     pkey: ProgramKey, graph: PackedBatch,
                     df: DataflowConfig, passes: Dict[BucketKey, int]):
        """One program of ``key`` under ``df`` on ``ex``: on a GPU the
        forward captured on ``graph`` into the executor's pool, with a ring
        of pinned slots of its own; on the CPU the eager forward, which
        counts its passes into ``passes`` on its first run."""
        run = self._make_run(df)
        if ex.device.type == "cuda":
            staging = BatchStaging(*key, pkey[1], ex.device, pin=True,
                                   slots=CapturedProgram.SLOTS)
            prog = CapturedProgram(run, ex.resident, staging, graph,
                                   pool=ex.pool, stream=ex.stream,
                                   warm_stream=ex.warm_stream)
        else:
            prog = EagerProgram(run, key, pkey[1], ex.device, passes=passes)
        prog.dataflow = df
        return prog

    def _evict_cold_locked(self, ex: DeviceExecutor, keep: ProgramKey
                           ) -> None:
        """Bound ``ex``'s programs (under the compile lock): while there
        are more than ``max_cached_programs``, move the least recently
        touched one, never ``keep`` (the one just installed), to
        ``ex.retired``, which frees it (its graph, its share of the pool,
        its pinned ring) once no batch of it can be in flight. The bucket
        stays servable: its next batch builds it again from its cached
        winner."""
        cap = self._max_cached_programs
        if cap is None:
            return
        while len(ex.compiled) > cap:
            victim = min((k for k in ex.compiled if k != keep),
                         key=lambda k: ex.touched.get(k, 0), default=None)
            if victim is None:
                return
            ex.retired.append(ex.compiled.pop(victim))
            ex.touched.pop(victim, None)
            self._evict_log[victim[0]] = self._evict_log.get(victim[0], 0) + 1
            with self._cv:
                self.stats.program_evictions += 1

    #: the impls that run a hand-written kernel, where ``rows_per_block``
    #: is a distinct launch shape
    _KERNEL_IMPLS = ("fused_layer", "pipeline", "kernel")

    def _candidate_dataflows(self, key: BucketKey, device: torch.device
                             ) -> List[DataflowConfig]:
        """The dataflows a bucket's autotune times on an executor of
        ``device`` (a pure function of the bucket and the device type).

        On the CPU the reference's design space (the paper's Fig. 10: its
        ``engine.py::_candidate_dataflows`` off the TPU): the configured
        (num_banks, edge_tile) and up to two more, the configured impl and
        ``pipeline``; ``fused_layer`` is left out, as the reference leaves
        it out where it would be a bitwise duplicate of the pipeline.
        Raising ``max_autotune`` expands toward banks {1, 2, 4, 8, 16} x
        tiles {32, 64, 128, 256} x impls.

        On a GPU (num_banks, edge_tile) change nothing, so every variant of
        them would be a bitwise duplicate; the kernels' launch shape,
        ``rows_per_block``, takes their place. The configured impl comes
        first, then ``pipeline`` and ``fused_layer`` (distinct hand-written
        programs there), each at the configured rows per block, then the
        configured impl at the other two of {None, 1, 8}; raising
        ``max_autotune`` expands toward {None, 1, 2, 4, 8, 16} x impls. As
        in the reference, impl diversity outranks launch-shape diversity
        under truncation to ``max_autotune``, and no duplicate is timed (a
        plain impl, which runs no kernel, is offered at None only)."""
        if torch.device(device).type == "cuda":
            return self._card_candidates()
        node_pad, edge_pad, _ = key

        def clamp(banks: int, tile: int) -> Tuple[int, int]:
            banks = max(1, min(banks, node_pad))
            while node_pad % banks:
                banks //= 2
            return banks, max(8, min(tile, edge_pad))

        impls = [self.dataflow.impl]
        if "pipeline" not in impls:
            impls.append("pipeline")
        pairs: List[Tuple[int, int]] = []
        for banks, tile in ((self.dataflow.num_banks, self.dataflow.edge_tile),
                            (1, 128), (8, 64)):
            bt = clamp(banks, tile)
            if bt not in pairs:
                pairs.append(bt)
        base = self.dataflow.replace(num_banks=pairs[0][0],
                                     edge_tile=pairs[0][1])
        cands = [base]
        cands += [base.replace(impl=impl) for impl in impls[1:]]
        cands += [self.dataflow.replace(num_banks=b, edge_tile=t)
                  for b, t in pairs[1:3]]
        if self._max_autotune > len(cands):
            seen = {(c.num_banks, c.edge_tile, c.impl) for c in cands}
            for banks in (1, 2, 4, 8, 16):
                for tile in (32, 64, 128, 256):
                    b, t = clamp(banks, tile)
                    for impl in impls:
                        if (b, t, impl) not in seen:
                            seen.add((b, t, impl))
                            cands.append(self.dataflow.replace(
                                num_banks=b, edge_tile=t, impl=impl))
        return cands[:self._max_autotune]

    def _card_candidates(self) -> List[DataflowConfig]:
        """``_candidate_dataflows`` on a GPU."""
        df = self.dataflow
        impls = [df.impl]
        for extra in ("pipeline", "fused_layer"):
            if extra not in impls:
                impls.append(extra)
        rows = [df.rows_per_block]
        for r in (None, 1, 8):
            if r not in rows:
                rows.append(r)
        cands: List[DataflowConfig] = []
        seen = set()

        def offer(impl: str, r: Optional[int]) -> None:
            r = r if impl in self._KERNEL_IMPLS else None
            if (impl, r) not in seen:
                seen.add((impl, r))
                cands.append(df.replace(impl=impl, rows_per_block=r))

        for impl in impls:
            offer(impl, rows[0])
        for r in rows[1:3]:
            offer(df.impl, r)
        if self._max_autotune > len(cands):
            for r in (None, 1, 2, 4, 8, 16):
                for impl in impls:
                    offer(impl, r)
        return cands[:self._max_autotune]

    def _candidate_name(self, df: DataflowConfig) -> str:
        """A candidate's name in the tune log: the reference's
        (``banks4_tile128``, ``_<impl>`` when it is not the configured
        one), with ``_rows<r>`` for a launch shape set."""
        name = f"banks{df.num_banks}_tile{df.edge_tile}"
        if df.rows_per_block is not None:
            name += f"_rows{df.rows_per_block}"
        if df.impl != self.dataflow.impl:
            name += f"_{df.impl}"
        return name

    def _run_autotune(self, ex: DeviceExecutor, key: BucketKey,
                      pkey: ProgramKey, pb: PackedBatch):
        """Time the bucket's candidates on its first batch ``pb`` on ``ex``
        (under the compile lock, on ``ex``'s dispatch thread, after its
        pipe drained), record the winner for the whole pool, anchor the
        drift envelope, persist the cache. Each candidate is a program of
        its own, its passes counted into a throwaway dict: on a GPU a
        ``CapturedProgram`` in the executor's pool timed by the span
        between the CUDA events around its replay (``device_s``'s span),
        the minimum of 3 replays of ``pb``; on the CPU the eager forward by
        the host clock, the minimum of 3 after a first run. A candidate
        that raises is skipped and named in the log's ``failed`` (on a GPU
        the executor then takes a fresh pool). Returns the winner's program
        when the bucket serves at rung 0 (the losers go to ``ex.retired``),
        else None, and then the caller builds the bucket's rung (also when
        every candidate failed: that build raises on a GPU)."""
        cuda = ex.device.type == "cuda"
        params = ex.resident if cuda else ex.params
        t0 = time.perf_counter()
        timings: Dict[str, float] = {}
        failed: Dict[str, str] = {}
        best_t, best_df, best_name, best_prog = float("inf"), None, None, None
        built = 0
        for df in self._candidate_dataflows(key, ex.device):
            name = self._candidate_name(df)
            try:
                built += 1
                prog = self._new_program(ex, key, pkey, pb, df, passes={})
                t = self._time_candidate(prog, pb, params, cuda)
            except Exception as exc:   # the candidate does not serve here
                failed[name] = f"{type(exc).__name__}: {exc}"
                if cuda:
                    ex.pool = torch.cuda.graph_pool_handle()
                continue
            timings[name] = t * 1e6
            if t < best_t:
                if best_prog is not None:
                    ex.retired.append(best_prog)
                best_t, best_df, best_name, best_prog = t, df, name, prog
            else:
                ex.retired.append(prog)
        winner = best_df if best_df is not None else self.dataflow
        self._tuned[key] = winner
        with self._cv:
            load = self._bucket_load.setdefault(key, _BucketLoad())
            load.last_tune_t = time.perf_counter()
            load.batches_since_tune = 0
            load.tuned_fill = None     # the next completion anchors the mix
            load.tuned_device_s = best_t if np.isfinite(best_t) else None
        log: Dict[str, Any] = {"candidates_us": timings, "device": ex.label,
                               "failed": failed, "programs": built,
                               "tune_ms": (time.perf_counter() - t0) * 1e3}
        if best_name is not None:
            log["winner"] = best_name
            log["best_us"] = best_t * 1e6
        self._tune_log[key] = log
        self._save_autotune_cache()
        if best_prog is None:
            return None
        if best_prog.dataflow != self._effective_df(key, winner):
            ex.retired.append(best_prog)   # the breaker serves another rung
            return None
        return best_prog

    @staticmethod
    def _time_candidate(prog, pb: PackedBatch, params, cuda: bool) -> float:
        """A candidate program's time on ``pb`` (s): on a GPU the least
        span of 3 replays, each between the CUDA events around it; on the
        CPU the least host time of 3 forwards after a first one."""
        if cuda:
            return min(prog.wait(prog.enqueue(pb, params))[1]
                       for _ in range(3))
        ticket = prog.enqueue(pb, params)
        prog.wait(ticket)              # the first run counts the passes
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            prog.wait(ticket)
            times.append(time.perf_counter() - t0)
        return min(times)

    # ------------------------------------------------------------------
    # autotune cache persistence
    # ------------------------------------------------------------------

    # The reference's schema, so that one file can hold both engines'
    # sections (each side rebuilds a file of another schema on save); the
    # fingerprint keeps the port's winners apart from the JAX engine's.
    AUTOTUNE_CACHE_SCHEMA = 3

    def _cache_fingerprint(self) -> str:
        """The workload and device the winners were tuned for: torch, the
        executors' device type and kind (``torch.cuda.get_device_name``,
        or ``cpu``), the model's shape, the configured dataflow and the wide
        shard count (``@wide{wide_k}``, ``@wide1`` with wide placement
        off: a wide engine's narrow buckets share their executors with
        gangs, so they keep their own section). The JAX
        engine's sections start with its backend's name, never ``torch``,
        so neither side applies the other's winners."""
        c, d = self.cfg, self.dataflow
        dev = self._executors[0].device
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu").replace(" ", "_")
        wide_k = self._wide_k if self._wide_enabled else 1
        return (f"torch:{dev.type}:{kind}/{c.model}-l{c.num_layers}-"
                f"h{c.hidden_dim}-{c.task}-{d.impl}"
                f"{'-sp' if d.single_pass else ''}@wide{wide_k}")

    def _load_autotune_cache(self) -> None:
        """Load the winners of this engine's section; a file of another
        schema, or one that does not parse, is ignored."""
        path = self._autotune_cache
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return
        if (not isinstance(raw, dict)
                or raw.get("__schema__") != self.AUTOTUNE_CACHE_SCHEMA):
            return                 # stale (or unversioned) cache: re-tune
        section = raw.get(self._cache_fingerprint(), {})
        if not isinstance(section, dict):
            return
        for key_s, val in section.items():
            try:
                key = tuple(int(v) for v in key_s.split("x"))
                if len(key) != 3:
                    continue
                rows = val.get("rows_per_block")
                self._tuned[key] = self.dataflow.replace(
                    num_banks=int(val["num_banks"]),
                    edge_tile=int(val["edge_tile"]),
                    impl=str(val.get("impl", self.dataflow.impl)),
                    rows_per_block=None if rows is None else int(rows))
            except (KeyError, ValueError, TypeError, AttributeError):
                continue
        self._tune_log.clear()     # cached winners are not timed again

    def _save_autotune_cache(self) -> None:
        """Write this engine's section, keeping the other sections of a
        file of the same schema; written to a temporary file, then moved
        into place."""
        path = self._autotune_cache
        if not path:
            return
        existing: Dict[str, Any] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    existing = json.load(f)
                if not isinstance(existing, dict):
                    existing = {}
            except (OSError, ValueError):
                existing = {}
        if existing.get("__schema__") != self.AUTOTUNE_CACHE_SCHEMA:
            existing = {}              # drop every stale-schema section
        existing["__schema__"] = self.AUTOTUNE_CACHE_SCHEMA
        existing[self._cache_fingerprint()] = {
            "x".join(map(str, key)): {"num_banks": df.num_banks,
                                      "edge_tile": df.edge_tile,
                                      "impl": df.impl,
                                      "rows_per_block": df.rows_per_block}
            for key, df in self._tuned.items()}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(existing, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass

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
    (``PackedBatch.build``), ``wait`` runs the eager forward on it under the
    params the dispatch pinned, so that on an executor the forward runs on
    the complete thread while the dispatch thread builds the next batch.
    The bucket's passes over the edges are counted on its first forward
    into ``passes``."""

    def __init__(self, run, key: BucketKey, widths: Tuple[int, int, int],
                 device: torch.device, *, passes: Dict[BucketKey, int]):
        self.run, self.key = run, key
        self.pos_dim = widths[2]
        self.device = device
        self.passes = passes
        self.edge_passes: Optional[int] = None

    def enqueue(self, pb: PackedBatch, params) -> Tuple[GraphBatch, Any]:
        return pb.build(pos_dim=self.pos_dim, device=self.device), params

    def wait(self, ticket: Tuple[GraphBatch, Any]) -> Tuple[np.ndarray, None]:
        """The forward's output on the host; no device span (the executor
        takes the marginal host time)."""
        batch, params = ticket
        if self.edge_passes is None:
            with count_edge_passes() as ps:
                out = self.run(params, batch)
            self.edge_passes = ps.passes
            self.passes.setdefault(self.key, ps.passes)
        else:
            out = self.run(params, batch)
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
    ``pool`` (one pool per executor), in ``thread_local`` capture mode. The
    side stream is ``warm_stream``, one an executor: the caching allocator
    reuses a freed block only on the stream that freed it, so a new side
    stream for each capture would hold a new set of blocks for each (memory
    that grows with every program built, as eviction rebuilds them).

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

    The weights. The graph reads the parameter tensors it was captured on:
    ``params``, its executor's ``resident`` tree, which the executor alone
    writes, on ``stream`` before the replay that first runs a new version
    (``DeviceExecutor._load``). ``enqueue`` takes that tree and no other.
    """

    SLOTS = DeviceExecutor.PIPELINE_DEPTH

    def __init__(self, run, params, staging: BatchStaging, pb: PackedBatch,
                 *, pool, stream: torch.cuda.Stream,
                 warm_stream: torch.cuda.Stream):
        t0 = time.perf_counter()
        self.params = params
        self.staging = staging
        self.stream = stream
        dev = staging.device_buf.device
        self._slots = [_Slot() for _ in staging.hosts]
        self._next = 0
        with torch.cuda.stream(stream):
            pb.stage(staging, 0)
            staging.upload(0)
            warm_stream.wait_stream(stream)
            with torch.cuda.stream(warm_stream):
                run(self.params, staging.batch)
            stream.wait_stream(warm_stream)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.graph.enable_debug_mode()
            with _no_gc(), count_edge_passes() as ps, torch.cuda.graph(
                    self.graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                self.out = run(self.params, staging.batch)
            self.graph.instantiate()
        self.edge_passes = ps.passes
        self.out_host = [torch.empty(self.out.shape, dtype=self.out.dtype,
                                     pin_memory=True)
                         for _ in self._slots]
        torch.cuda.synchronize(dev)
        #: host seconds the build took (staging, warm-up run, capture)
        self.build_s = time.perf_counter() - t0

    def enqueue(self, pb: PackedBatch, params) -> int:
        """Stage ``pb`` into the next slot and enqueue, on ``stream``, its
        upload, replay and copy-out; the slot is the ticket. ``params``
        must be the tree the graph was captured on."""
        if params is not self.params:
            raise RuntimeError("a captured program runs only the weights "
                               "it was captured on")
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


class EagerWideProgram:
    """A wide program off a single card (the CPU, or a gang over several
    cards): the ``WideForward`` run eagerly on each graph's arrays, its
    passes over the edges counted on its first run."""

    def __init__(self, fwd: WideForward):
        self.fwd = fwd
        self.edge_passes: Optional[int] = None

    def run(self, stacked, params) -> Tuple[np.ndarray, None]:
        """The graph's output on the host; no device span (the engine takes
        the host time)."""
        if self.edge_passes is None:
            with count_edge_passes() as ps:
                out = self.fwd(params, stacked)
            self.edge_passes = ps.passes
        else:
            out = self.fwd(params, stacked)
        return out.cpu().numpy(), None


class CapturedWideProgram:
    """The wide forward of one (``WideBucket``, gang) on one card, captured
    once as one ``torch.cuda.CUDAGraph``: K shards x L layers, the ring
    steps, the gathers and the readout.

    Built on the bucket's first graph under the compile lock, with every
    member idle: the graph's arrays are staged into the program's static
    inputs (pinned host mirrors, one copy each to the card), the forward
    runs once eagerly on the leader's ``warm_stream``, then is captured on
    the leader's ``stream`` into the leader's graph pool, in
    ``thread_local`` mode with the collector off. Inside, the schedule
    forks onto the members' streams by events, so that a layer's K shards
    are independent branches of the graph between two exchanges, and joins
    them back before the capture ends. A replay is one launch on the
    leader's stream.

    ``run`` pads a graph's arrays into the pinned mirrors, and on the
    leader's stream enqueues their upload, the replay between two events
    and the copy of the static output into pinned memory, then waits: the
    output is on the host before the gang is released, so no replay of
    another program of the pool (the leader's narrow ones share it) can
    overwrite it first. The graph reads ``params``, the leader's resident
    tree, into which ``DeviceExecutor._load`` copies each new version on
    the leader's stream before the replay that first runs it.
    """

    def __init__(self, fwd: WideForward, params, stacked, *, pool,
                 stream: torch.cuda.Stream, warm_stream: torch.cuda.Stream):
        from repro_torch.distributed.wide import WIDE_DTYPES
        t0 = time.perf_counter()
        self.fwd, self.params, self.stream = fwd, params, stream
        dev = fwd.gang.devices[0]
        self.host = {key: torch.empty(a.shape, dtype=WIDE_DTYPES[key],
                                      pin_memory=True)
                     for key, a in stacked.items()}
        self.inputs = {key: torch.empty(a.shape, dtype=WIDE_DTYPES[key],
                                        device=dev)
                       for key, a in stacked.items()}
        self.uploaded = torch.cuda.Event()
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.done = torch.cuda.Event()
        with torch.cuda.stream(stream):
            self.stage(stacked)
            self.upload()
            warm_stream.wait_stream(stream)
            with torch.cuda.stream(warm_stream), torch.inference_mode():
                fwd.run(params, self.inputs)
            stream.wait_stream(warm_stream)
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            self.graph.enable_debug_mode()
            with _no_gc(), count_edge_passes() as ps, \
                    torch.inference_mode(), torch.cuda.graph(
                        self.graph, pool=pool, stream=stream,
                        capture_error_mode="thread_local"):
                self.out = fwd.run(params, self.inputs)
            self.graph.instantiate()
        self.edge_passes = ps.passes
        self.out_host = torch.empty(self.out.shape, dtype=self.out.dtype,
                                    pin_memory=True)
        torch.cuda.synchronize(dev)
        #: host seconds the build took (staging, warm-up run, capture)
        self.build_s = time.perf_counter() - t0

    def run(self, stacked, params) -> Tuple[np.ndarray, float]:
        """One graph through the captured forward: (its output on the
        host, the replay's span in seconds). ``params`` must be the tree
        the graph was captured on."""
        if params is not self.params:
            raise RuntimeError("a captured program runs only the weights "
                               "it was captured on")
        self.stage(stacked)
        with torch.cuda.stream(self.stream):
            self.upload()
            self.replay()
            self.copy_out()
        self.done.synchronize()
        return (self.out_host.numpy().copy(),
                self.start.elapsed_time(self.end) * 1e-3)

    # the steps of ``run``, each a method so that it can be timed alone;
    # upload, replay and copy_out enqueue on the current stream

    def stage(self, stacked) -> None:
        """Pad a graph's arrays into the pinned mirrors, once the upload
        that last read them has run."""
        self.uploaded.synchronize()
        for key, a in stacked.items():
            self.host[key].numpy()[...] = a

    def upload(self) -> None:
        for key, t in self.inputs.items():
            t.copy_(self.host[key], non_blocking=True)
        self.uploaded.record()

    def replay(self) -> None:
        self.start.record()
        self.graph.replay()
        self.end.record()

    def copy_out(self) -> None:
        self.out_host.copy_(self.out, non_blocking=True)
        self.done.record()
