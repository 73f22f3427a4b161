"""The six models under the port's ``impl='kernel'`` against the JAX
package's, on the CPU.

Under ``impl='kernel'`` every aggregation is one launch of ``mp_scatter``,
``mp_scatter_multi`` or ``seg_softmax``; on the CPU each runs its plain
version. Both sides get the same graphs (the JAX generators through each
side's ``build_graph_batch``) and the same weights (the JAX ``init``, moved
across through ``params_from_numpy``), at the reference's kernel-test width
(hidden 16, three layers), alone and 3 graphs packed. Tolerances: 1e-4
against the reference's interpret-mode kernel forward, what it holds
between that and its fused forward (``test_kernel_impl_matches_fused``),
and 1e-5 against its unrolled ``impl='fused'`` forward. The aggregation
unit, the passes and the engine are in ``test_torch_kernel_impl.py``.
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
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
MODELS = ("gin", "gcn", "gin_vn", "gat", "pna", "dgn")
# the reference's kernel test dataflow
KERNEL_DF = dict(impl="kernel", num_banks=4, edge_tile=32)


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


def _port_apply(cfg, params, g, **df):
    return tmake(cfg).apply(params, g, cfg, DataflowConfig(**df)).numpy()


def _ref_apply(cfg, params, g, **df):
    return np.asarray(jmake(cfg).apply(
        params, g, cfg, jmp.DataflowConfig(scan_layers=False, **df)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_small_model_matches_reference(name, packed):
    """Alone and 3 graphs packed: against the reference's interpret-mode
    kernel forward (1e-4) and its unrolled fused forward (1e-5)."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=4)
    jg, tg = _graphs(packed)
    ours = _port_apply(tcfg, tp, tg, **KERNEL_DF)
    assert ours.shape == (tg.n_graph_pad, tcfg.out_dim)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, _ref_apply(jcfg, jp, jg, **KERNEL_DF),
                               **KERNEL_TOL)
    np.testing.assert_allclose(ours, _ref_apply(jcfg, jp, jg, impl="fused"),
                               **TOL)


@pytest.mark.parametrize("name", ["pna", "dgn"])
def test_per_kind_loop_matches_reference(name):
    """single_pass=False: one kernel launch per kind (PNA four
    mp_scatter_multi a layer, DGN an mp_scatter and an mp_scatter_multi),
    3 graphs packed."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=6)
    jg, tg = _graphs(packed=True)
    ours = _port_apply(tcfg, tp, tg, single_pass=False, **KERNEL_DF)
    np.testing.assert_allclose(
        ours, _ref_apply(jcfg, jp, jg, single_pass=False, **KERNEL_DF),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        ours, _ref_apply(jcfg, jp, jg, impl="fused", single_pass=False),
        **TOL)
