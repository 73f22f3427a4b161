"""Batch-1 streaming inference engine (the serving facade), in PyTorch.

The twin of ``repro/core/engine.py`` for its batch-1 path: one raw COO graph
arrives, is validated, padded to its bucket, built on the device, run through
the model and answered. This is the paper's workload: graphs served one at a
time, with no preprocessing.

Each bucket is served by one program, built on the bucket's first graph
(``_ensure_program``, the twin of the reference's; ``_make_run`` is the
forward it runs). On a CUDA device the program is the forward captured once
in a ``torch.cuda.CUDAGraph`` (``CapturedProgram``: the counterpart of the
reference's jitted program with donated buffers), fed through one pinned
staging buffer and one copy each way; on the CPU it is the eager forward on
a batch built afresh (``EagerProgram``).

``submit`` works synchronously and returns a ``Future`` that is already
resolved; ``process`` is ``submit(...).result()``. Multi-graph packing, the
scheduler and executor threads, autotune, failure handling, defense,
overload handling and wide placement are not ported yet (ROADMAP queue 1
items 3, 4 and 6).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.errors import (EngineClosed, GraphTooLarge,
                                     InvalidGraph, InvalidRequest)
from repro_torch.core.graph import (BatchStaging, GraphBatch,
                                    build_graph_batch, pad_bucket)
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import GNNConfig, make_gnn
from repro_torch.core.validate import check_budget, check_graph

BucketKey = Tuple[int, int, int]        # (node_pad, edge_pad, graph_pad)
# a program's key: its bucket and the widths of node_feat, edge_feat and
# node_pos it was built for
ProgramKey = Tuple[BucketKey, Tuple[int, int, int]]


@dataclass
class StreamStats:
    """Per-graph latency and per-batch forward span.

    ``latencies_s`` holds one host-clock time per graph, from ``submit`` to
    its answer on the host. ``device_s`` holds one forward span per batch:
    on a GPU the span between CUDA events recorded around the replay of the
    bucket's captured graph (the card's work and the gaps between the
    graph's kernels; no host dispatch inside it); the host clock around the
    eager forward on the CPU. ``batch_sizes`` holds the graphs per batch (1
    here). ``device_mean_ms`` and ``throughput_gps`` in ``summary()`` read
    these spans.
    """

    latencies_s: List[float] = field(default_factory=list)
    device_s: List[float] = field(default_factory=list)
    batch_sizes: List[int] = field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        if not self.latencies_s:
            return {}
        arr = np.array(self.latencies_s)
        out: Dict[str, Any] = {
            "count": float(arr.size),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
        }
        if self.device_s and sum(self.device_s) > 0:
            # graphs per second of forward span, host launch gaps included
            out["device_mean_ms"] = float(np.mean(self.device_s) * 1e3)
            out["throughput_gps"] = float(
                sum(self.batch_sizes) / sum(self.device_s))
        else:
            out["throughput_gps"] = float(arr.size / arr.sum())
        return out


class GraphStreamEngine:
    """Batch-1 serving of one model on one device, one program per bucket."""

    def __init__(self, cfg: GNNConfig, params,
                 dataflow: DataflowConfig = DEFAULT_DATAFLOW,
                 buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024),
                 *, device: DeviceLike = None, validate_inputs: bool = True,
                 require_finite: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.dataflow = dataflow
        self.buckets = tuple(buckets)
        self.model = make_gnn(cfg)
        self.stats = StreamStats()
        # passes over the edge stream per bucket, recorded when the bucket's
        # program first runs its forward (the paper's headline dataflow
        # property)
        self.edge_passes: Dict[BucketKey, int] = {}
        # one program per bucket (and input widths), built on first sight
        self.compiled: Dict[ProgramKey, Any] = {}
        # the memory pool every captured program of this engine shares
        self._pool = None
        self._validate_inputs = bool(validate_inputs)
        self._require_finite = bool(require_finite)
        self._closed = False
        self._req_seq = 0
        self._lock = threading.Lock()

    def submit(self, node_feat: np.ndarray, senders: np.ndarray,
               receivers: np.ndarray, edge_feat: Optional[np.ndarray] = None,
               node_pos: Optional[np.ndarray] = None,
               record: bool = True) -> Future:
        """Serve one graph; the returned Future holds ITS prediction.

        Graph-level tasks resolve to a ``(out_dim,)`` vector, node-level
        tasks to the graph's ``(n_nodes, out_dim)`` rows. A malformed graph
        raises ``InvalidGraph``; one over the largest bucket raises
        ``GraphTooLarge``.
        """
        t_arrival = time.perf_counter()
        if edge_feat is None and self.cfg.edge_feat_dim != 1:
            raise InvalidRequest("model expects edge features")
        if self._closed:
            raise EngineClosed("engine is closed")
        with self._lock:
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
        key = (pad_bucket(max(n, 1), self.buckets),
               pad_bucket(max(e, 1), self.buckets), 1)
        fut: Future = Future()
        with self._lock:
            out, device_s = self._run(key, node_feat, senders, receivers,
                                      edge_feat, node_pos)
            if record:
                self.stats.latencies_s.append(time.perf_counter() - t_arrival)
                self.stats.device_s.append(device_s)
                self.stats.batch_sizes.append(1)
        fut.set_result(out[:n] if self.cfg.task == "node" else out[0])
        return fut

    def process(self, node_feat: np.ndarray, senders: np.ndarray,
                receivers: np.ndarray, edge_feat: Optional[np.ndarray] = None,
                node_pos: Optional[np.ndarray] = None,
                record: bool = True) -> np.ndarray:
        """Synchronous batch-1 serving: submit one graph, return its result."""
        return self.submit(node_feat, senders, receivers, edge_feat, node_pos,
                           record=record).result()

    def warmup(self, node_feat, senders, receivers, edge_feat=None,
               node_pos=None) -> None:
        """Serve one representative graph without recording it, so that its
        bucket's first-run costs (kernel build and load, allocator growth,
        on a GPU the capture of its program) are paid before traffic
        arrives."""
        self.process(node_feat, senders, receivers, edge_feat, node_pos,
                     record=False)

    def close(self) -> None:
        """Reject further submissions (idempotent)."""
        self._closed = True

    def __enter__(self) -> "GraphStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # one program per bucket
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

    def _ensure_program(self, key: BucketKey, graph: Dict[str, Any]):
        """The program for ``key``, built on the first sight of the bucket
        from its first graph ``graph`` (raw arrays, as ``_run`` takes them):
        the twin of the reference's ``_ensure_program``, without autotune
        and the breaker (ROADMAP queue 1 item 4 (b), (d)). Called under
        ``self._lock``."""
        widths = (graph["node_feat"].shape[1],
                  1 if graph["edge_feat"] is None
                  else graph["edge_feat"].shape[1],
                  self.cfg.pos_dim if graph["node_pos"] is None
                  else graph["node_pos"].shape[1])
        prog = self.compiled.get((key, widths))
        if prog is not None:
            return prog
        run = self._make_run(self.dataflow)
        if self.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            staging = BatchStaging(*key, widths, self.device, pin=True)
            prog = CapturedProgram(run, self.params, staging, graph,
                                   pool=self._pool)
        else:
            prog = EagerProgram(run, self.params, key, widths, self.device)
        self.compiled[(key, widths)] = prog
        return prog

    def _run(self, key: BucketKey, node_feat, senders, receivers, edge_feat,
             node_pos) -> Tuple[np.ndarray, float]:
        """Serve one graph through its bucket's program: the output on the
        host and the forward's device seconds. Called under
        ``self._lock``."""
        graph = raw_graph(node_feat, senders, receivers, edge_feat, node_pos)
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            prog = self._ensure_program(key, graph)
            out = prog(graph)
        self.edge_passes.setdefault(key, prog.edge_passes)
        return out


def raw_graph(node_feat, senders, receivers, edge_feat=None,
              node_pos=None) -> Dict[str, Any]:
    """One submitted graph's arrays as a program takes them: numpy, float
    payloads in float32, absent ones ``None``."""
    return {"node_feat": np.asarray(node_feat, np.float32),
            "senders": np.asarray(senders),
            "receivers": np.asarray(receivers),
            "edge_feat": (None if edge_feat is None
                          else np.asarray(edge_feat, np.float32)),
            "node_pos": (None if node_pos is None
                         else np.asarray(node_pos, np.float32))}


class EagerProgram:
    """A bucket's program on the CPU: the eager forward on a batch built
    afresh by ``build_graph_batch`` for each graph. Its passes over the
    edges are counted on its first forward."""

    def __init__(self, run, params, key: BucketKey,
                 widths: Tuple[int, int, int], device: torch.device):
        self.run, self.params, self.key = run, params, key
        self.pos_dim = widths[2]
        self.device = device
        self.edge_passes: Optional[int] = None

    def __call__(self, graph: Dict[str, Any]) -> Tuple[np.ndarray, float]:
        node_pad, edge_pad, graph_pad = self.key
        g = build_graph_batch(
            graph["node_feat"], graph["senders"], graph["receivers"],
            edge_feat=graph["edge_feat"], node_pos=graph["node_pos"],
            node_pad=node_pad, edge_pad=edge_pad, graph_pad=graph_pad,
            pos_dim=self.pos_dim, device=self.device)
        t0 = time.perf_counter()
        if self.edge_passes is None:
            with count_edge_passes() as ps:
                out = self.run(self.params, g)
            self.edge_passes = ps.passes
        else:
            out = self.run(self.params, g)
        return out.numpy(), time.perf_counter() - t0


class CapturedProgram:
    """A bucket's program on a CUDA device: its forward captured once in a
    ``torch.cuda.CUDAGraph`` and replayed for each graph.

    Built from the bucket's first graph: the graph is staged, the forward
    runs once eagerly on a side stream (it loads the kernels, sets their
    attributes, fills their launch caches and warms the allocator), then is
    captured on the static batch of ``staging`` into ``pool`` (shared by
    every program of an engine). A graph is served in four steps, each a
    method so that it can be timed alone: ``stage`` pads it into the pinned
    host buffer, ``upload`` enqueues the one copy to the card, ``replay``
    launches the graph between two CUDA events, ``download`` copies the
    static output into a pinned host buffer and waits for that copy.

    Every program of an engine shares ``pool``, so one program's static
    output may lie in blocks that another's replay uses for its temporaries.
    That is safe only because a program's answer is copied out
    (``download``, which waits for the copy) before any other program
    replays: ``GraphStreamEngine`` serves one graph at a time under its
    lock. Staging two graphs in flight (ROADMAP queue 1 item 4 (a)) must
    first give each program's output its own allocation outside the pool.

    The kernel wrappers count their launches in Python where they enqueue
    them: the warm-up run and the capture each count one forward's, and a
    replay counts nothing. What a replay runs is read from the graph itself
    (``graph``: kept with its node list, in debug mode, so that
    ``CUDAGraph.debug_dump`` can write its kernel nodes) or from the
    profiler's device events.
    """

    def __init__(self, run, params, staging: BatchStaging,
                 graph: Dict[str, Any], *, pool):
        self.staging = staging
        dev = staging.device_buf.device
        self.stage(graph)
        self.upload()
        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            run(params, staging.batch)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.enable_debug_mode()
        with count_edge_passes() as ps, torch.cuda.graph(self.graph,
                                                         pool=pool):
            self.out = run(params, staging.batch)
        self.graph.instantiate()
        self.edge_passes = ps.passes
        self.out_host = torch.empty(self.out.shape, dtype=self.out.dtype,
                                    pin_memory=True)
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._done = torch.cuda.Event()
        torch.cuda.synchronize(dev)

    def __call__(self, graph: Dict[str, Any]) -> Tuple[np.ndarray, float]:
        self.stage(graph)
        self.upload()
        self.replay()
        out = self.download()
        return out, self._start.elapsed_time(self._end) * 1e-3

    def stage(self, graph: Dict[str, Any]) -> None:
        """Pad ``graph`` into the pinned host buffer."""
        self.staging.stage(graph["node_feat"], graph["senders"],
                           graph["receivers"], edge_feat=graph["edge_feat"],
                           node_pos=graph["node_pos"])

    def upload(self) -> None:
        """Enqueue the staged batch's one copy to the card."""
        self.staging.upload()

    def replay(self) -> None:
        """Launch the captured forward between two CUDA events."""
        self._start.record()
        self.graph.replay()
        self._end.record()

    def download(self) -> np.ndarray:
        """The static output on the host: one copy into the pinned buffer,
        then a wait on an event recorded after it."""
        self.out_host.copy_(self.out, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return self.out_host.numpy().copy()


def _to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    return params.to(device)
