"""The port's graph generators against the JAX package's, on the CPU.

``repro_torch/data/graphs.py`` keeps its own copy of the numpy generators;
one seed must give identical arrays on both sides. ``citation_like`` mixes
``hash(name)`` into its seed, which Python salts per process, so the two
sides agree within one interpreter (this one).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import graphs as J  # noqa: E402
from repro_torch.data import graphs as T  # noqa: E402

FIELDS = ("node_feat", "senders", "receivers", "edge_feat", "node_pos",
          "label")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("kw", [
    dict(seed=4, n_graphs=2),
    dict(seed=11, n_graphs=1, n_nodes=300, node_dim=9, edge_dim=3),
    dict(seed=20, n_graphs=2, n_nodes=980, node_dim=8, edge_dim=1),
    dict(seed=1, n_graphs=1, n_nodes=1100, window=4, e_per_node=3.0,
         edge_dim=0),
])
def test_mesh_like_matches_the_reference(kw):
    for a, b in zip(J.mesh_like(**kw), T.mesh_like(**kw), strict=True):
        _same(a, b)


@pytest.mark.parametrize("name", ["cora", "citeseer", "reddit_mini"])
def test_citation_like_matches_the_reference(name):
    _same(J.citation_like(name), T.citation_like(name))
    g = T.citation_like(name)
    assert g.edge_feat is None
    assert g.senders.shape == g.receivers.shape


def test_mesh_like_edges_stay_inside_the_window():
    g = next(T.mesh_like(seed=3, n_graphs=1, n_nodes=500, window=8))
    gap = np.abs(g.senders.astype(np.int64) - g.receivers)
    ring = (gap == 1) | (gap == 499)
    assert np.all(ring | (gap <= 8))
    assert g.node_feat.shape == (500, 9) and g.edge_feat.shape[1] == 3


@pytest.mark.parametrize("kw", [dict(), dict(seed=7, n_graphs=5),
                                dict(seed=3, n_graphs=2, node_dim=4,
                                     edge_dim=1)])
def test_molpcba_like_matches_the_reference(kw):
    kw = {"n_graphs": 3, **kw}
    for a, b in zip(J.molpcba_like(**kw), T.molpcba_like(**kw), strict=True):
        _same(a, b)
