"""The paper's real-time scenario end to end on the PyTorch port:
consecutive small graphs at batch size 1, zero preprocessing,
workload-agnostic.

The twin of ``examples/gnn_streaming.py``. Streams two workloads
(MolHIV-like molecules and HEP-like kNN point clouds) through the same
engine (one captured program per bucket on the card, graphs in raw
arrival order) and sets it beside the dense Eq.-2 baseline
(``core/pyg_ref.py::DENSE_REFS``, an explicit (N, N) adjacency), whose
answer on the first graph it also holds the engine's against. Then the
packed path (asynchronous ``submit``, adaptive packing, futures) and two
tenants, a saturated bulk queue beside a latency-sensitive one, through the
weighted-fair scheduler. The engine runs the port's main path,
``impl="fused_layer"`` (``layer_fused`` per layer; GAT's layers
``mp_pipeline``).

Run (from the root of a checkout):
    PYTHONPATH=src python examples/gnn_streaming_torch.py [--graphs 50]
    PYTHONPATH=src python examples/gnn_streaming_torch.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import GraphStreamEngine
from repro_torch.core.graph import build_graph_batch
from repro_torch.core.message_passing import DataflowConfig
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
from repro_torch.core.pyg_ref import DENSE_REFS
from repro_torch.core.scheduler import QueueConfig
from repro_torch.data.graphs import hep_like, molhiv_like
from repro_torch.distributed.sharding import replicate_params

DATAFLOW = DataflowConfig(impl="fused_layer")
# the engine's answer vs the dense oracle: the reference's own
# sparse-vs-dense tolerance (tests/test_flowgnn_models.py), relative to
# max(1, |dense|)
DENSE_TOL = 1e-4


def time_fn(fn, *args, device: torch.device, warmup: int = 2,
            iters: int = 5) -> float:
    """Median wall seconds of one call of ``fn(*args)``, the device
    synchronised before each clock read."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _model(model_name: str):
    cfg = PAPER_GNN_CONFIGS[model_name]
    return cfg, make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


def stream(model_name: str, gen, dataset: str, n: int, device=None) -> dict:
    """``n`` graphs of ``gen`` through ``process``; the dense baseline's
    time on the first graph, and its answer held against the engine's."""
    dev = resolve_device(device)
    cfg, params = _model(model_name)
    graphs = list(gen(seed=0, n_graphs=n))
    g0 = graphs[0]

    # dense baseline (what a framework without the sparse engine does)
    gb = build_graph_batch(g0.node_feat, g0.senders, g0.receivers,
                           edge_feat=g0.edge_feat, node_pad=128,
                           edge_pad=1024, node_pos=g0.node_pos, device=dev)
    dense_params = replicate_params(params, [dev])[0]

    def dense(p, g):
        with torch.inference_mode():
            return DENSE_REFS[cfg.model](p, g, cfg)
    t_dense = time_fn(dense, dense_params, gb, device=dev)
    want = dense(dense_params, gb)[0].cpu()

    with GraphStreamEngine(cfg, params, DATAFLOW, device=dev) as eng:
        eng.warmup(*_args(g0))
        first = None
        for g in graphs:
            out = eng.process(*_args(g))
            first = out if first is None else first
        s = eng.stats.summary()
    got = torch.as_tensor(np.asarray(first)).reshape(want.shape)
    err = float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))
    if not err <= DENSE_TOL:
        raise AssertionError(f"{model_name} | {dataset}: the engine's answer "
                             f"is {err:.3e} of scale from the dense oracle")
    print(f"[{model_name} | {dataset}] dense={t_dense*1e3:8.2f} ms  "
          f"flowgnn p50={s['p50_ms']:7.2f} ms  p99={s['p99_ms']:7.2f} ms  "
          f"speedup={t_dense*1e3/s['p50_ms']:5.1f}x  "
          f"throughput={s['throughput_gps']:6.1f} graphs/s  "
          f"vs dense oracle {err:.1e} of scale  on {dev}")
    return {**s, "dense_ms": t_dense * 1e3, "dense_err": err}


def stream_packed(model_name: str, n: int, max_batch: int = 16,
                  device=None) -> dict:
    """The multi-queue path: async submission, adaptive packing, futures."""
    cfg, params = _model(model_name)
    graphs = list(molhiv_like(seed=0, n_graphs=n))
    with GraphStreamEngine(cfg, params, DATAFLOW, max_batch=max_batch,
                           max_wait_ms=10.0, eager_flush=False,
                           device=device) as eng:
        eng.warmup(*_args(graphs[0]))
        futs = [eng.submit(*_args(g)) for g in graphs]
        eng.drain(timeout=300)
        preds = [f.result() for f in futs]
        s = eng.stats.summary()
    print(f"[{model_name} | molhiv packed x{max_batch}] "
          f"p50={s['p50_ms']:7.2f} ms  "
          f"mean_batch={s['mean_batch_size']:5.1f}  "
          f"throughput={s['throughput_gps']:6.1f} graphs/s  "
          f"({len(preds)} futures resolved)")
    return {**s, "resolved": len(preds)}


def stream_two_tenants(model_name: str, n: int, device=None) -> dict:
    """Multi-tenant serving: a saturated bulk tenant next to a
    latency-sensitive one on the same engine. Weighted-fair draining keeps
    the latency queue's tail bounded although its graphs arrive after the
    whole bulk backlog."""
    cfg, params = _model(model_name)
    graphs = list(molhiv_like(seed=0, n_graphs=n))
    queues = [
        QueueConfig("bulk", weight=1.0, max_wait_ms=20.0, max_batch=16),
        QueueConfig("latency", weight=16.0, max_wait_ms=1.0, max_batch=2),
    ]
    with GraphStreamEngine(cfg, params, DATAFLOW, queues=queues,
                           eager_flush=False, device=device) as eng:
        # every bucket x per-queue graph_pad built up front, so the tail
        # latencies printed measure the fair scheduler, not a capture
        eng.warmup_all()
        bulk = [eng.submit(*_args(g), queue="bulk")
                for g in graphs for _ in range(3)]
        lat = [eng.submit(*_args(g), queue="latency")
               for g in graphs[: max(n // 4, 4)]]
        eng.drain(timeout=600)
        for f in bulk + lat:
            f.result()
        s = eng.stats.summary()
    for q in ("bulk", "latency"):
        sq = s["queues"][q]
        print(f"[{model_name} | tenant={q:8s}] n={int(sq['count']):4d}  "
              f"p50={sq['p50_ms']:8.2f} ms  p90={sq['p90_ms']:8.2f} ms")
    return s


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, which must exist)")
    args = ap.parse_args()
    for m in ("gin", "gcn", "gat"):
        stream(m, molhiv_like, "molhiv", args.graphs, args.device)
    stream("gin", hep_like, "hep", max(args.graphs // 3, 5), args.device)
    stream_packed("gin", max(args.graphs, 32), device=args.device)
    stream_two_tenants("gin", max(args.graphs, 32), device=args.device)
