"""The port's graph generators and containers against the JAX package's.

Same seeds must give identical arrays; ``build_graph_batch`` /
``concat_raw_graphs`` / ``pad_bucket`` / ``permute_edges`` must agree field
by field (indices are int64 on the port's side, int32 on the reference's).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.data import graphs as jdata  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.data import graphs as tdata  # noqa: E402

FIELDS = ("node_feat", "edge_feat", "senders", "receivers", "node_mask",
          "edge_mask", "graph_ids", "graph_mask", "node_pos")


def _same_graph(a, b):
    for name in ("node_feat", "senders", "receivers", "edge_feat",
                 "node_pos"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, name
            continue
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.label == b.label


@pytest.mark.parametrize("gen,kw", [
    ("molhiv_like", {}),
    ("sized_stream", {"n_mean": 40.0, "n_std": 0.0}),
    ("hep_like", {}),
    ("molhiv_like", {"edge_dim": 0}),
])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generators_match_reference(gen, kw, seed):
    ours = list(getattr(tdata, gen)(seed=seed, n_graphs=3, **kw))
    ref = list(getattr(jdata, gen)(seed=seed, n_graphs=3, **kw))
    for a, b in zip(ours, ref, strict=True):
        _same_graph(a, b)


def _assert_batch_equal(tb, jb):
    for name in FIELDS:
        t = getattr(tb, name).numpy()
        j = np.asarray(getattr(jb, name))
        assert t.shape == j.shape, name
        if np.issubdtype(j.dtype, np.integer):
            assert t.dtype == np.int64, name
            np.testing.assert_array_equal(t, j.astype(np.int64),
                                          err_msg=name)
        else:
            assert t.dtype == j.dtype, name
            np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("n_graphs,node_pad,edge_pad,graph_pad", [
    (1, 64, 128, 1),
    (3, 128, 256, 4),
])
def test_build_graph_batch_matches_reference(n_graphs, node_pad, edge_pad,
                                             graph_pad):
    graphs = list(jdata.molhiv_like(seed=3, n_graphs=n_graphs))
    raw_t = tgraph.concat_raw_graphs(graphs)
    raw_j = jgraph.concat_raw_graphs(graphs)
    assert raw_t.keys() == raw_j.keys()
    for k in raw_j:
        np.testing.assert_array_equal(raw_t[k], raw_j[k], err_msg=k)
    kw = dict(edge_feat=raw_t["edge_feat"], node_pos=raw_t["node_pos"],
              graph_offsets=raw_t["graph_offsets"], node_pad=node_pad,
              edge_pad=edge_pad, graph_pad=graph_pad)
    tb = tgraph.build_graph_batch(raw_t["node_feat"], raw_t["senders"],
                                  raw_t["receivers"], device="cpu", **kw)
    jb = jgraph.build_graph_batch(raw_j["node_feat"], raw_j["senders"],
                                  raw_j["receivers"], **kw)
    _assert_batch_equal(tb, jb)
    assert (tb.n_node_pad, tb.n_edge_pad, tb.n_graph_pad) == (
        jb.n_node_pad, jb.n_edge_pad, jb.n_graph_pad)


def test_build_graph_batch_defaults_and_errors_match_reference():
    g = next(jdata.molhiv_like(seed=5, n_graphs=1))
    tb = tgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                  node_pad=64, edge_pad=128, pos_dim=2,
                                  device="cpu")
    jb = jgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                  node_pad=64, edge_pad=128, pos_dim=2)
    _assert_batch_equal(tb, jb)
    with pytest.raises(ValueError):
        tgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                 node_pad=4, edge_pad=128, device="cpu")
    with pytest.raises(ValueError):
        tgraph.concat_raw_graphs([])


def test_concat_raw_graphs_fills_missing_features_like_reference():
    a, b = list(jdata.molhiv_like(seed=2, n_graphs=2))
    bare = jdata.RawGraph(b.node_feat, b.senders, b.receivers, None,
                          b.node_pos, b.label)
    ours = tgraph.concat_raw_graphs([a, bare])
    ref = jgraph.concat_raw_graphs([a, bare])
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1024, 1025, 5000, 20000])
def test_pad_bucket_matches_reference(n):
    assert tgraph.pad_bucket(n) == jgraph.pad_bucket(n)
    buckets = (32, 64, 128, 256, 512, 1024)
    assert tgraph.pad_bucket(n, buckets) == jgraph.pad_bucket(n, buckets)


def test_permute_edges_matches_reference():
    g = next(jdata.molhiv_like(seed=4, n_graphs=1))
    kw = dict(edge_feat=g.edge_feat, node_pad=64, edge_pad=128)
    tb = tgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                  device="cpu", **kw)
    jb = jgraph.build_graph_batch(g.node_feat, g.senders, g.receivers, **kw)
    perm = np.random.default_rng(0).permutation(128)
    _assert_batch_equal(tgraph.permute_edges(tb, perm),
                        jgraph.permute_edges(jb, perm))
