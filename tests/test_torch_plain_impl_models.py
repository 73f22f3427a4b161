"""The six models under the port's ``twopass``, ``unfused`` and ``banked``
impls against the JAX package's, on the CPU.

Both sides get the same graphs (the JAX generators through each side's
``build_graph_batch``) and the same weights (the JAX ``init``, moved across
through ``params_from_numpy``), hidden 16 and three layers, alone and 3
graphs packed; the reference runs unrolled (``scan_layers=False``).
Tolerance: atol = rtol = 1e-5, what the reference holds between its own
eager and compiled forwards. Passes over the edges must be equal on both
sides. The aggregation arms are in ``test_torch_plain_impls.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import message_passing as jmp  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.graph import concat_raw_graphs  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.message_passing import (DataflowConfig,  # noqa: E402
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
MODELS = ("gin", "gcn", "gin_vn", "gat", "pna", "dgn")
IMPLS = ("twopass", "unfused", "banked")


def _graphs(packed):
    gs = list(molhiv_like(seed=3, n_graphs=3 if packed else 1))
    pads = (128, 256) if packed else (64, 128)
    raw = concat_raw_graphs(gs)
    kw = dict(edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
              graph_offsets=raw["graph_offsets"], node_pad=pads[0],
              edge_pad=pads[1], graph_pad=len(gs))
    args = (raw["node_feat"], raw["senders"], raw["receivers"])
    return jbuild(*args, **kw), tbuild(*args, device="cpu", **kw)


def _small(cfgs, name):
    return cfgs[name].replace(num_layers=3, hidden_dim=16)


def _jax_params(cfg, seed=0):
    params = jmake(cfg).init(jax.random.PRNGKey(seed), cfg)
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_small_model_matches_reference(name, packed, impl):
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=7)
    jg, tg = _graphs(packed)
    with count_edge_passes() as ps:
        ours = tmake(tcfg).apply(tp, tg, tcfg,
                                 DataflowConfig(impl=impl)).numpy()
    with jmp.count_edge_passes() as pj:
        ref = np.asarray(jmake(jcfg).apply(
            jp, jg, jcfg, jmp.DataflowConfig(impl=impl, scan_layers=False)))
    assert ps.passes == pj.passes
    assert ours.shape == (tg.n_graph_pad, tcfg.out_dim)
    np.testing.assert_allclose(ours, ref, **TOL)
