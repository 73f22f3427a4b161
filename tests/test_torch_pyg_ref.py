"""The port's dense oracles (``repro_torch/core/pyg_ref.py``) and the
``GraphBatch`` counts against the JAX package, and the port's sparse models
against the port's dense oracle.

* ``DENSE_REFS`` against the reference's, model for model at the paper
  configs, on the same graphs (each side's ``build_graph_batch``) and the
  JAX ``init`` weights (``params_from_numpy``): float32 at atol = rtol =
  1e-5.
* The port's six sparse models (``make_gnn(cfg).apply`` under the default
  dataflow) against the port's oracle on molhiv-like graphs, alone and
  packed: the reference's own sparse-vs-dense tolerance, 1e-4
  (``tests/test_flowgnn_models.py``), since the two sum in other orders.
* ``num_nodes`` / ``num_edges`` / ``in_degrees`` against JAX's, with
  receivers in the padding rows (counted) and outside [0, N_pad)
  (dropped, as ``jax.ops.segment_sum`` drops them).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import pyg_ref as jref  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.graph import concat_raw_graphs  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core import pyg_ref as tref  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
SPARSE_VS_DENSE = dict(atol=1e-4, rtol=1e-4)
MODELS = ("gcn", "gin", "gin_vn", "gat", "pna", "dgn")


def _graphs(seed, n_graphs):
    gs = list(molhiv_like(seed=seed, n_graphs=n_graphs))
    raw = concat_raw_graphs(gs)
    kw = dict(edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
              graph_offsets=raw["graph_offsets"], node_pad=64 * n_graphs,
              edge_pad=128 * n_graphs, graph_pad=n_graphs)
    args = (raw["node_feat"], raw["senders"], raw["receivers"])
    return jbuild(*args, **kw), tbuild(*args, device="cpu", **kw)


def _params(name, seed=0):
    cfg = JCFG[name]
    jp = jmake(cfg).init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def test_the_same_models_are_covered():
    assert set(tref.DENSE_REFS) == set(jref.DENSE_REFS) == set(MODELS)


@pytest.mark.parametrize("name", MODELS)
def test_dense_oracle_matches_the_reference(name):
    jp, tp = _params(name)
    jg, tg = _graphs(seed=5, n_graphs=2)
    ref = jref.DENSE_REFS[name](jp, jg, JCFG[name])
    out = tref.DENSE_REFS[name](tp, tg, TCFG[name])
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dense_from_coo_matches_the_reference():
    jg, tg = _graphs(seed=6, n_graphs=3)
    ja, je = jref.dense_from_coo(jg)
    ta, te = tref.dense_from_coo(tg)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("n_graphs", [1, 3])
@pytest.mark.parametrize("name", MODELS)
def test_sparse_models_match_the_dense_oracle(name, n_graphs):
    cfg = TCFG[name]
    _, tp = _params(name, seed=1)
    _, tg = _graphs(seed=7 + n_graphs, n_graphs=n_graphs)
    with torch.inference_mode():
        out = tmake(cfg).apply(tp, tg, cfg)
        ref = tref.DENSE_REFS[name](tp, tg, cfg)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **SPARSE_VS_DENSE)


def _with_receivers(jg, tg, receivers):
    """Both batches with these receivers on their first edges, each edge
    unmasked."""
    e = len(receivers)
    rj = np.asarray(jg.receivers).copy()
    rj[:e] = receivers
    mj = np.asarray(jg.edge_mask).copy()
    mj[:e] = True
    jg = dataclasses.replace(jg, receivers=jnp.asarray(rj, jnp.int32),
                             edge_mask=jnp.asarray(mj))
    tg = dataclasses.replace(tg, receivers=torch.from_numpy(rj.astype(
        np.int64)), edge_mask=torch.from_numpy(mj))
    return jg, tg


@pytest.mark.parametrize("receivers", [
    None,                                   # as built: real edges only
    [62, 63, 63],                           # padding rows of node_pad 64
    [64, 200, -1, 5],                       # outside [0, N_pad), and one in
], ids=["as_built", "padding_rows", "outside"])
def test_graph_counts_match_the_reference(receivers):
    jg, tg = _graphs(seed=9, n_graphs=1)
    if receivers is not None:
        jg, tg = _with_receivers(jg, tg, receivers)
    assert int(tg.num_nodes()) == int(jg.num_nodes())
    assert int(tg.num_edges()) == int(jg.num_edges())
    assert tg.num_nodes().dtype == tg.num_edges().dtype == torch.int32
    deg = tg.in_degrees()
    assert deg.dtype == torch.float32 and deg.shape == (tg.n_node_pad,)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jg.in_degrees()))
