"""Batch-1 streaming inference engine (the serving facade), in PyTorch.

The twin of ``repro/core/engine.py`` for its batch-1 path: one raw COO graph
arrives, is validated, padded to its bucket, built on the device, run through
the model and answered. This is the paper's workload: graphs served one at a
time, with no preprocessing.

``submit`` works synchronously and returns a ``Future`` that is already
resolved; ``process`` is ``submit(...).result()``. Multi-graph packing, the
scheduler and executor threads, autotune, failure handling, defense,
overload handling and wide placement are not ported yet (ROADMAP queue 1
item 7, sub-slices (b) to (e), and item 8).
"""

from __future__ import annotations

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
from repro_torch.core.graph import build_graph_batch, pad_bucket
from repro_torch.core.message_passing import (DEFAULT_DATAFLOW,
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import GNNConfig, make_gnn
from repro_torch.core.validate import check_budget, check_graph

BucketKey = Tuple[int, int, int]        # (node_pad, edge_pad, graph_pad)


@dataclass
class StreamStats:
    """Per-graph latency and per-batch forward span.

    ``latencies_s`` holds one host-clock time per graph, from ``submit`` to
    its answer on the host. ``device_s`` holds one forward span per batch:
    CUDA events recorded around the forward on a GPU, so the host's launch
    gaps between the forward's kernels count in it; the host clock around
    the forward on the CPU. ``batch_sizes`` holds the graphs per batch (1
    here). ``device_mean_ms`` and ``throughput_gps`` in ``summary()`` read
    these spans: they measure the card's work plus the host's dispatch,
    not the card alone.
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
                 *, device: DeviceLike = None, validate_inputs: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.dataflow = dataflow
        self.buckets = tuple(buckets)
        self.model = make_gnn(cfg)
        self.stats = StreamStats()
        # passes over the edge stream per bucket, recorded on the bucket's
        # first forward (the paper's headline dataflow property)
        self.edge_passes: Dict[BucketKey, int] = {}
        self._validate_inputs = bool(validate_inputs)
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
                pos_dim=self.cfg.pos_dim)
            if reason is not None:
                raise InvalidGraph(reason, request_ids=(req_id,))
        n = int(np.asarray(node_feat).shape[0])
        e = int(np.asarray(senders).shape[0])
        reason = check_budget(n, node_budget=max(self.buckets))
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
        bucket's first-run costs (kernel build and load, allocator growth)
        are paid before traffic arrives."""
        self.process(node_feat, senders, receivers, edge_feat, node_pos,
                     record=False)

    def close(self) -> None:
        """Reject further submissions (idempotent)."""
        self._closed = True

    def __enter__(self) -> "GraphStreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _run(self, key: BucketKey, node_feat, senders, receivers, edge_feat,
             node_pos) -> Tuple[np.ndarray, float]:
        """Build the padded batch, run the forward; the output on the host
        and the forward's device seconds."""
        node_pad, edge_pad, graph_pad = key
        g = build_graph_batch(
            np.asarray(node_feat, np.float32), np.asarray(senders),
            np.asarray(receivers),
            edge_feat=(None if edge_feat is None
                       else np.asarray(edge_feat, np.float32)),
            node_pos=(None if node_pos is None
                      else np.asarray(node_pos, np.float32)),
            node_pad=node_pad, edge_pad=edge_pad, graph_pad=graph_pad,
            pos_dim=self.cfg.pos_dim, device=self.device)
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        with torch.inference_mode():
            if key in self.edge_passes:
                out = self.model.apply(self.params, g, self.cfg,
                                       self.dataflow)
            else:
                with count_edge_passes() as ps:
                    out = self.model.apply(self.params, g, self.cfg,
                                           self.dataflow)
                self.edge_passes[key] = ps.passes
        if cuda:
            end.record()
        out_np = out.cpu().numpy()          # waits for the device
        if cuda:
            device_s = start.elapsed_time(end) * 1e-3
        else:
            device_s = time.perf_counter() - t0
        return out_np, device_s


def _to_device(params, device: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    return params.to(device)
