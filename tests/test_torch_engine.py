"""The port's engine against the JAX package's, on the CPU, one graph at a
time through ``process``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.message_passing import DataflowConfig as JDF  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import hep_like, molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.errors import (GraphTooLarge,  # noqa: E402
                                     InvalidGraph, InvalidRequest)
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import gin_init  # noqa: E402


def _stream():
    return (list(molhiv_like(seed=0, n_graphs=6))
            + list(hep_like(seed=2, n_graphs=2)))


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


@pytest.fixture(scope="module")
def port_engine():
    cfg = TCFG["gin"]
    params = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                           device="cpu") as eng:
        yield eng


def test_engine_matches_reference_engine():
    jcfg = JCFG["gin"]
    jp = jmake(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    graphs = _stream()
    with JEngine(jcfg, jp, JDF(impl="fused_layer", scan_layers=False)) as je:
        ref = [je.process(*_args(g)) for g in graphs]
    with GraphStreamEngine(TCFG["gin"], tp, DataflowConfig(impl="fused_layer"),
                           device="cpu") as te:
        te.warmup(*_args(graphs[0]))
        ours = [te.process(*_args(g)) for g in graphs]
        summary = te.stats.summary()
        passes = dict(te.edge_passes)
    for a, b in zip(ours, ref):
        assert a.shape == (jcfg.out_dim,)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert summary["count"] == len(graphs)
    for k in ("p50_ms", "p90_ms", "p99_ms", "throughput_gps"):
        assert summary[k] > 0
    # molecules land in (32, 64|128), kNN graphs in (64, 1024), each bucket
    # padded to the queue's max_batch (8) graph slots as in the reference:
    # one pass per layer in each bucket
    assert (32, 64, 8) in passes and (64, 1024, 8) in passes
    assert set(passes.values()) == {jcfg.num_layers}


def test_submit_returns_resolved_future(port_engine):
    """``submit`` returns a Future that resolves, without a drain, to what
    ``process`` answers for the same graph."""
    g = next(molhiv_like(seed=1, n_graphs=1))
    fut = port_engine.submit(*_args(g))
    np.testing.assert_array_equal(fut.result(timeout=60),
                                  port_engine.process(*_args(g)))
    assert fut.done()


def test_malformed_graph_raises_invalid_graph(port_engine):
    g = next(molhiv_like(seed=1, n_graphs=1))
    bad = g.senders.copy()
    bad[0] = g.node_feat.shape[0] + 5            # out-of-range index
    with pytest.raises(InvalidGraph):
        port_engine.process(g.node_feat, bad, g.receivers, g.edge_feat)
    with pytest.raises(InvalidGraph):            # float edge indices
        port_engine.process(g.node_feat, g.senders.astype(np.float32),
                            g.receivers, g.edge_feat)
    with pytest.raises(InvalidGraph):            # wrong node width
        port_engine.process(g.node_feat[:, :4], g.senders, g.receivers,
                            g.edge_feat)
    with pytest.raises(InvalidRequest):          # the model needs edge feats
        port_engine.process(g.node_feat, g.senders, g.receivers)


def test_graph_over_largest_bucket_raises(port_engine):
    n = max(port_engine.buckets) + 1
    x = np.zeros((n, 9), np.float32)
    snd = np.arange(n - 1, dtype=np.int32)
    rcv = snd + 1
    with pytest.raises(GraphTooLarge):
        port_engine.process(x, snd, rcv, np.zeros((n - 1, 3), np.float32))


def test_no_device_and_no_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCFG["gin"]
    params = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphStreamEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gin_init(torch.Generator().manual_seed(0), cfg)


def test_closed_engine_rejects(port_engine):
    cfg = TCFG["gin"]
    params = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = GraphStreamEngine(cfg, params, device="cpu")
    eng.close()
    g = next(molhiv_like(seed=1, n_graphs=1))
    with pytest.raises(RuntimeError, match="closed"):
        eng.process(*_args(g))
