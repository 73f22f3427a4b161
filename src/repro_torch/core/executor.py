"""Per-device executor: the processing-element half of the serving stack.

The twin of ``repro/core/executor.py``. A ``DeviceExecutor`` is one of the
paper's processing elements: it owns one ``torch.device`` (on a GPU also
one ``torch.cuda.Stream`` and one CUDA-graph memory pool), its parameters
on that device, a per-bucket program cache, and its own dispatch/complete
thread pair with a depth-2 staging pipe, so that the host's packing of
batch k+1 overlaps the device's work on batch k, and D executors run D
pipelines.

The executor knows nothing about queues, futures, stats or autotuning (it
only holds the engine's per-executor state: ``compiled``, ``touched`` for
LRU eviction, ``retired``); the engine injects

  * ``program_fn(ex, key, pb)``  — the program of a bucket on THIS executor
    (built on the first ``PackedBatch`` of the bucket; the engine's cache
    is namespaced per executor). A program has ``enqueue(pb, params) ->
    ticket`` (dispatch thread: pad the batch into the program's input,
    enqueue its work on ``params``: the pinned tree on the CPU,
    ``resident`` on a GPU),
    ``wait(ticket) -> (output on the host, device seconds or None)``
    (complete thread) and ``release(ticket)`` (drop a ticket unread). The
    reference's ``build_fn`` is the program's ``enqueue``: a captured
    program pads a batch straight into one of its pinned slots.
  * ``unpack_fn(pb, out)``        — per-graph results of a batch's output,
  * ``on_complete(ex, done)``     — called from the complete thread with a
    ``CompletedBatch`` (results or error),
  * ``on_fatal(ex, exc)``         — a worker loop died unexpectedly,
  * ``fault_hook(site, ex, pb)``  — an optional callable run at the
    ``'dispatch'`` and ``'complete'`` sites; it may raise or sleep (the
    engine passes ``FaultInjector.executor_hook``).

Versioned parameters. Each dispatch reads the executor's ``(params,
version)`` pair once (``set_params`` swaps it as one reference): a batch
runs on the version it was dispatched with, whichever version is installed
by the time it runs. On the CPU the program runs the pinned tree itself.
On a GPU every captured program of the executor reads one tree of weights
the executor owns (``resident``, never aliased to a replica): a dispatch
whose pinned version differs from the one ``resident`` holds first
enqueues one device-to-device copy of the pinned replica into it on the
executor's stream, so batches enqueued earlier run the old weights and
later ones the new, in stream order, and no program is captured again.

On a GPU the dispatch thread runs each step inside ``torch.cuda.device``
and ``torch.cuda.stream(self.stream)``: the program pads the batch into a
pinned slot, enqueues the upload, the replay between two CUDA events and
the copy-out into a pinned output slot, and records an event after it. The
complete thread waits on that event only, not on the device, so batch k+1
is padded and enqueued while batch k runs. ``device_s`` is the span
between the two events around the replay: batches on one stream never
overlap, so the spans of an executor sum without double counting. On the
CPU the forward runs when the complete thread waits, and ``device_s`` is
the reference's marginal host time (from the later of the batch's dispatch
and the previous completion to this one).

Building a bucket's program on a GPU (a warm-up run, then a capture) first
drains this executor's pipe (``quiesce``): no thread of the executor makes
a CUDA call while it captures. ``warm`` runs on the dispatch thread once
the threads are started, so that every enqueue and capture of an executor
happens on one thread.

Failure semantics: a worker-loop death marks the executor ``dead``, fails
the batch it was holding plus everything queued behind it with
``ExecutorDead`` (every future resolves; nothing is stranded on the staging
pipe), and reports through ``on_fatal``. ``stop(timeout=...)`` bounds every
join, so a wedged worker never blocks shutdown; ``mark_dead`` is the entry
point for executors that are stuck rather than crashed.

``backlog`` (graphs submitted here and not yet completed) is what the
engine's least-backlog placement reads.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import ExecutorDead
from repro_torch.core.packing import PackedBatch

BucketKey = Tuple[int, int, int]

_SENTINEL = object()


def _map_tensors(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in the order ``_map_tensors`` visits them."""
    out: List[torch.Tensor] = []
    _map_tensors(out.append, tree)
    return out


@dataclass
class _InFlight:
    """A dispatched batch waiting for this executor's device."""

    queue: str
    batch: PackedBatch
    program: Any
    ticket: Any
    t_build_start: float
    t_dispatch: float
    params_version: int = 0
    params: Any = None        # the pinned tree, alive until completion


@dataclass
class _Warm:
    """A request to build (and run once) a bucket's program on the
    dispatch thread."""

    key: BucketKey
    batch: PackedBatch
    done: Future


@dataclass
class CompletedBatch:
    """Everything the engine needs to resolve one batch.

    ``params_version`` is the executor's params version at dispatch time.
    """

    queue: str
    batch: PackedBatch
    results: Optional[List[np.ndarray]]       # None iff err is set
    err: Optional[BaseException]
    t_build_start: float
    t_dispatch: float
    t_ready: float
    device_s: float
    params_version: int = 0


class DeviceExecutor:
    """One device's double-buffered dispatch/complete pipeline."""

    def __init__(self, *, device, index: int, params, version: int = 0,
                 program_fn: Callable[["DeviceExecutor", BucketKey,
                                       PackedBatch], Any],
                 unpack_fn: Callable[[PackedBatch, np.ndarray],
                                     List[np.ndarray]],
                 on_complete: Callable[["DeviceExecutor", CompletedBatch],
                                       None],
                 on_fatal: Callable[["DeviceExecutor", BaseException], None],
                 fault_hook: Optional[Callable[[str, "DeviceExecutor",
                                                PackedBatch], None]] = None):
        self.device = torch.device(device)
        self.index = index
        # (params on ``device``, version), swapped as ONE reference
        self._params_v: Tuple[Any, int] = (params, int(version))
        self.label = f"{self.device}#{index}"
        # this executor's programs, by (bucket, input widths); the engine's
        # ``compiled`` merges them
        self.compiled: Dict[Any, Any] = {}
        # the engine-wide touch sequence number of each program's last use
        # (the engine's LRU eviction reads it)
        self.touched: Dict[Any, int] = {}
        # programs the engine dropped from ``compiled`` (the breaker moved
        # their bucket a rung, a drift retune, an eviction, an autotune
        # candidate that lost): kept until the dispatch thread next builds
        # a program with the pipe drained, so that none is freed while a
        # batch of it may still be on this executor's stream
        self.retired: List[Any] = []
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        # the side stream of every capture's warm-up run (made once, so that
        # the allocator reuses its blocks across the captures)
        self.warm_stream = torch.cuda.Stream(self.device) if cuda else None
        # the memory pool this executor's captured programs share (made by
        # the engine at the first capture)
        self.pool = None
        # on a GPU: the weights every captured program of this executor
        # reads (made on the first dispatch), the version they hold, the
        # versions copied in since, and the events around the last copy.
        # Only the dispatch thread touches them.
        self.resident: Any = None
        self.resident_version: Optional[int] = None
        self.swaps = 0
        self._swap_events = ((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                             if cuda else None)

        self._program_fn = program_fn
        self._unpack_fn = unpack_fn
        self._on_complete = on_complete
        self._on_fatal = on_fatal
        self._fault_hook = fault_hook

        self._inbox: "queue.Queue[Any]" = queue.Queue()
        # depth-2 staging = the double buffer: one batch on the device, one
        # enqueued behind it; a third dispatch blocks until a completion
        self._staging: "queue.Queue[Any]" = queue.Queue(maxsize=2)
        self._backlog = 0
        self._queued_batches = 0
        self._unfinished = 0      # put on the staging pipe, not finished
        self._lock = threading.Lock()
        self._piped = threading.Condition(self._lock)
        self._dispatcher: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._stopped = False
        self._dead = False        # a worker loop died; fail, don't block

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._dispatcher is not None:
            return
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"flowgnn-dispatch-{self.label}")
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True,
            name=f"flowgnn-complete-{self.label}")
        self._dispatcher.start()
        self._completer.start()

    def stop(self, timeout: Optional[float] = None) -> bool:
        """Finish queued work, then stop both threads. Idempotent, and safe
        after a worker-loop death (no deadlock on a full staging queue;
        leftover batches fail rather than strand).

        With ``timeout`` every join is bounded: a wedged worker thread is
        declared dead instead of blocking shutdown, and everything it still
        held fails with ``ExecutorDead``. Returns True iff both threads
        exited cleanly within the budget.
        """
        if self._dispatcher is None or self._stopped:
            return not self._dead
        self._stopped = True
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)

        def _left() -> Optional[float]:
            return (None if deadline is None
                    else max(deadline - time.perf_counter(), 0.0))

        self._inbox.put(_SENTINEL)
        self._dispatcher.join(_left())
        if self._dispatcher.is_alive():
            self.mark_dead(ExecutorDead(
                "executor dispatch thread wedged during stop",
                executor_index=self.index))
            return False
        while True:
            try:
                self._staging.put(_SENTINEL, timeout=1.0)
                break
            except queue.Full:
                if self._dead:       # completer is gone; drain below
                    break
                left = _left()
                if left is not None and left <= 0.0:
                    self.mark_dead(ExecutorDead(
                        "executor staging pipe wedged during stop",
                        executor_index=self.index))
                    return False
        self._completer.join(_left())
        if self._completer.is_alive():
            self.mark_dead(ExecutorDead(
                "executor completer thread wedged during stop",
                executor_index=self.index))
            return False
        self._drain_queues(ExecutorDead(
            "executor stopped after worker death",
            executor_index=self.index))
        return not self._dead

    def mark_dead(self, exc: Optional[BaseException] = None) -> None:
        """Declare this executor dead without waiting for its threads.

        Worker loops fail fast once ``_dead`` is set; everything queued
        here resolves with ``exc`` immediately. The batch a wedged thread
        is holding cannot be reached from here: the engine's in-flight
        registry supersedes it (a late completion is ignored).
        """
        if exc is None:
            exc = ExecutorDead("executor marked dead",
                               executor_index=self.index)
        self._dead = True
        self._drain_queues(exc)

    # -- versioned params -------------------------------------------------

    @property
    def params(self) -> Any:
        return self._params_v[0]

    @property
    def params_version(self) -> int:
        return self._params_v[1]

    def set_params(self, params, version: int) -> None:
        """Install parameters on this device at ``version`` (one reference
        store). Every dispatch from now on pins them; on a GPU the first
        one copies them into ``resident`` on this executor's stream."""
        self._params_v = (params, int(version))

    def _load(self, params, version: int) -> Any:
        """The tree a program runs for a batch pinned to ``(params,
        version)``: ``params`` on the CPU; on a GPU ``resident``, into
        which a version it does not hold yet is first copied (one
        multi-tensor copy between two events, enqueued on the current
        stream: the executor's). Dispatch thread only."""
        if self.stream is None:
            return params
        if self.resident is None:
            self.resident = _map_tensors(torch.empty_like, params)
        if version != self.resident_version:
            start, end = self._swap_events
            start.record()
            torch._foreach_copy_(_tensors(self.resident), _tensors(params),
                                 non_blocking=True)
            end.record()
            if self.resident_version is not None:
                self.swaps += 1
            self.resident_version = version
        return self.resident

    def swap_ms(self) -> Optional[float]:
        """The span on the card of the last copy of a new version into
        ``resident`` (ms; waits for it), or None before the first."""
        if not self.swaps:
            return None
        start, end = self._swap_events
        end.synchronize()
        return start.elapsed_time(end)

    # -- placement interface ---------------------------------------------

    @property
    def backlog(self) -> int:
        """Graphs submitted to this executor and not yet completed."""
        with self._lock:
            return self._backlog

    @property
    def queued_batches(self) -> int:
        """Batches submitted here and not yet completed (building + staged
        + on the device + inbox). The placer bounds this at
        ``PIPELINE_DEPTH`` so excess backlog queues in the *fair*
        scheduler, not in a FIFO inbox where tenant weights no longer
        apply."""
        with self._lock:
            return self._queued_batches

    # one building on the dispatch thread + two in the staging double
    # buffer + one completing
    PIPELINE_DEPTH = 4

    @property
    def has_capacity(self) -> bool:
        return not self._dead and self.queued_batches < self.PIPELINE_DEPTH

    @property
    def idle(self) -> bool:
        return self.backlog == 0

    @property
    def dead(self) -> bool:
        return self._dead

    def submit(self, queue_name: str, pb: PackedBatch) -> None:
        """Hand one flushed batch to this executor (engine placer thread)."""
        with self._lock:
            self._backlog += pb.num_graphs
            self._queued_batches += 1
        if self._dead:       # worker died since placement: fail, don't strand
            self._fail_batch(queue_name, pb, self._dead_exc())
            return
        self._inbox.put((queue_name, pb))
        if self._dead:       # raced a dying worker past its drain: re-drain
            self._drain_queues(self._dead_exc())

    def warm(self, key: BucketKey, pb: PackedBatch) -> None:
        """Build (and run once) the bucket's program on this executor: on
        the dispatch thread once the threads run, else here."""
        if self._dispatcher is None or self._stopped:
            with self.on_device():
                program, ticket, _, _ = self._enqueue(key, pb)
                program.wait(ticket)
            return
        if self._dead:
            raise self._dead_exc()
        done: Future = Future()
        self._inbox.put(_Warm(key, pb, done))
        done.result()

    def on_device(self):
        """The context every CUDA call of this executor runs in: its device
        and its stream (nothing on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def quiesce(self) -> None:
        """Wait until every batch this executor put on its staging pipe has
        been finished by the complete thread (or the executor died): then
        neither worker thread makes a CUDA call until the caller, the
        dispatch thread, enqueues again."""
        with self._piped:
            while self._unfinished and not self._dead:
                self._piped.wait(0.05)

    # -- worker loops -----------------------------------------------------

    def _dead_exc(self) -> ExecutorDead:
        return ExecutorDead("executor worker died",
                            executor_index=self.index)

    def _finish(self, done: CompletedBatch, piped: bool = False) -> None:
        with self._lock:
            self._backlog -= done.batch.num_graphs
            self._queued_batches -= 1
            if piped:
                self._unfinished -= 1
                self._piped.notify_all()
        self._on_complete(self, done)

    def _fail_batch(self, queue_name: str, pb: PackedBatch,
                    exc: BaseException,
                    inflight: Optional[_InFlight] = None) -> None:
        if inflight is not None:
            inflight.program.release(inflight.ticket)
        t = time.perf_counter()
        self._finish(CompletedBatch(
            queue=queue_name, batch=pb, results=None, err=exc,
            t_build_start=t, t_dispatch=t, t_ready=t, device_s=0.0),
            piped=inflight is not None)

    def _fail_item(self, item: Any, exc: BaseException) -> None:
        if isinstance(item, _InFlight):
            self._fail_batch(item.queue, item.batch, exc, item)
        elif isinstance(item, _Warm):
            item.done.set_exception(exc)
        else:
            self._fail_batch(item[0], item[1], exc)

    def _drain_queues(self, exc: BaseException) -> None:
        """Fail every batch still sitting in inbox/staging (worker death:
        their futures must resolve and stop() must not block)."""
        for q in (self._staging, self._inbox):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    self._fail_item(item, exc)

    def _loop_fatal(self, exc: BaseException, current: Any = None) -> None:
        # a worker loop died unexpectedly: mark the executor dead (the
        # surviving loop fails work instead of blocking on the pipe), fail
        # the batch THIS loop was holding plus everything still queued
        # here, then tell the engine
        self._dead = True
        if current is not None:
            self._fail_item(current, exc)
        self._drain_queues(exc)
        self._on_fatal(self, exc)

    def _enqueue(self, key: BucketKey, pb: PackedBatch
                 ) -> Tuple[Any, Any, Any, int]:
        """Pin ``(params, version)`` (one read), load them, and enqueue
        ``pb`` on the bucket's program (built here on the bucket's first
        batch): ``(program, ticket, params, version)``. In
        ``on_device()``."""
        params, version = self._params_v
        tree = self._load(params, version)
        program = self._program_fn(self, key, pb)
        return program, program.enqueue(pb, tree), params, version

    def _run_warm(self, item: _Warm) -> None:
        try:
            with self.on_device():
                program, ticket, _, _ = self._enqueue(item.key, item.batch)
                program.wait(ticket)
        except Exception as exc:
            item.done.set_exception(exc)
        else:
            item.done.set_result(None)

    def _dispatch_loop(self) -> None:
        current: Any = None
        try:
            while True:
                item = self._inbox.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, _Warm):
                    self._run_warm(item)
                    continue
                queue_name, pb = item
                current = item
                if self._dead:
                    self._fail_batch(queue_name, pb, self._dead_exc())
                    current = None
                    continue
                t_build = time.perf_counter()
                try:
                    if self._fault_hook is not None:
                        self._fault_hook("dispatch", self, pb)
                    with self.on_device():
                        program, ticket, params, pver = self._enqueue(
                            pb.bucket, pb)
                except Exception as exc:        # bad batch: report, stay up
                    t = time.perf_counter()
                    self._finish(CompletedBatch(
                        queue=queue_name, batch=pb, results=None, err=exc,
                        t_build_start=t_build, t_dispatch=t, t_ready=t,
                        device_s=0.0))
                    current = None
                    continue
                # blocks while two batches are already staged (the double
                # buffer): host packing overlaps device execution. The
                # dead-check breaks the wait so a crashed completer cannot
                # wedge this thread on a full pipe.
                inflight = _InFlight(queue_name, pb, program, ticket,
                                     t_build, time.perf_counter(),
                                     params_version=pver, params=params)
                with self._lock:
                    self._unfinished += 1
                current = inflight
                while True:
                    if self._dead:
                        self._fail_batch(queue_name, pb, self._dead_exc(),
                                         inflight)
                        break
                    try:
                        self._staging.put(inflight, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                current = None
        except BaseException as exc:
            self._loop_fatal(exc, current)
            raise

    def _complete_loop(self) -> None:
        last_ready = 0.0
        current: Optional[_InFlight] = None
        try:
            while True:
                item = self._staging.get()
                if item is _SENTINEL:
                    return
                current = item
                err: Optional[Exception] = None
                results: Optional[List[np.ndarray]] = None
                span: Optional[float] = None
                try:
                    if self._fault_hook is not None:
                        self._fault_hook("complete", self, item.batch)
                    out_np, span = item.program.wait(item.ticket)
                    results = self._unpack_fn(item.batch, out_np)
                except Exception as exc:
                    item.program.release(item.ticket)
                    err = exc
                t_ready = time.perf_counter()
                # the replay's span on a GPU; on the CPU the marginal host
                # time, so that overlapped batches are not counted twice
                device_s = (span if span is not None
                            else t_ready - max(item.t_dispatch, last_ready))
                last_ready = t_ready
                current = None      # _finish resolves it (even if the
                # engine callback then raises, the batch is accounted)
                self._finish(CompletedBatch(
                    queue=item.queue, batch=item.batch, results=results,
                    err=err, t_build_start=item.t_build_start,
                    t_dispatch=item.t_dispatch, t_ready=t_ready,
                    device_s=device_s, params_version=item.params_version),
                    piped=True)
        except BaseException as exc:
            self._loop_fatal(exc, current)
            raise
