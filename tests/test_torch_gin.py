"""The port's GIN forward against the JAX package's, on the CPU.

Both sides get the same graphs (the JAX generators through each side's
``build_graph_batch``) and the same weights (the JAX ``init``, moved across
through ``params_from_numpy``). The reference runs unrolled
(``scan_layers=False``). Tolerance: atol = rtol = 1e-5, what the reference
holds between its own eager and compiled forwards.
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
from repro.data.graphs import hep_like, molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_numpy,  # noqa: E402
                                            params_to_numpy)
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core import message_passing as tmp  # noqa: E402
from repro_torch.core.graph import permute_edges  # noqa: E402
from repro_torch.core.message_passing import (DataflowConfig,  # noqa: E402
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import GNNConfig, gin_init  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _small(cfgs):
    return cfgs["gin"].replace(num_layers=3, hidden_dim=16)


def _graphs(packed, hep=False):
    if hep:
        gs = list(hep_like(seed=2, n_graphs=3 if packed else 1))
        pads = (256, 4096) if packed else (64, 1024)
    else:
        gs = list(molhiv_like(seed=3, n_graphs=3 if packed else 1))
        pads = (128, 256) if packed else (64, 128)
    raw = concat_raw_graphs(gs)
    kw = dict(edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
              graph_offsets=raw["graph_offsets"], node_pad=pads[0],
              edge_pad=pads[1], graph_pad=len(gs))
    args = (raw["node_feat"], raw["senders"], raw["receivers"])
    return jbuild(*args, **kw), tbuild(*args, device="cpu", **kw)


def _jax_params(cfg, seed=0):
    params = jmake(cfg).init(jax.random.PRNGKey(seed), cfg)
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _port_apply(cfg, params, g, impl):
    return tmake(cfg).apply(params, g, cfg,
                            DataflowConfig(impl=impl)).numpy()


def test_params_round_trip():
    cfg = _small(JCFG)
    jp, tp = _jax_params(cfg)
    back = params_to_numpy(tp)
    flat_j, tree_j = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jp))
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tp["layers"][0]["eps"].ndim == 0
    assert tp["node_enc"]["w"].shape == (cfg.node_feat_dim, cfg.hidden_dim)


@pytest.mark.parametrize("impl", ["fused", "pipeline", "fused_layer"])
@pytest.mark.parametrize("packed", [False, True])
def test_small_gin_matches_reference(impl, packed):
    """small_cfg (3 layers, hidden 16): against the JAX jnp forward and,
    for fused_layer, against the forced interpret-mode Pallas kernel."""
    jcfg, tcfg = _small(JCFG), _small(TCFG)
    jp, tp = _jax_params(jcfg, seed=1)
    jg, tg = _graphs(packed)
    ours = _port_apply(tcfg, tp, tg, impl)
    ref = jmake(jcfg).apply(jp, jg, jcfg,
                            jmp.DataflowConfig(impl=impl, scan_layers=False))
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    assert ours.shape == (tg.n_graph_pad, tcfg.out_dim)
    if impl == "fused_layer":
        jmp._FORCE_PIPELINE_KERNEL = True
        try:
            kern = jmake(jcfg).apply(
                jp, jg, jcfg, jmp.DataflowConfig(impl=impl,
                                                 scan_layers=False))
        finally:
            jmp._FORCE_PIPELINE_KERNEL = False
        np.testing.assert_allclose(ours, np.asarray(kern), **TOL)


@pytest.mark.parametrize("impl", ["fused", "fused_layer"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hep", [False, True])
def test_paper_gin_matches_reference(impl, packed, hep):
    """The paper width (5 x 100, MLP 100-200-100) against the jnp forward,
    on molecules and on kNN particle graphs."""
    jcfg, tcfg = JCFG["gin"], TCFG["gin"]
    jp, tp = _jax_params(jcfg, seed=2)
    jg, tg = _graphs(packed, hep=hep)
    ours = _port_apply(tcfg, tp, tg, impl)
    ref = jmake(jcfg).apply(jp, jg, jcfg,
                            jmp.DataflowConfig(impl=impl, scan_layers=False))
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("impl", ["fused", "pipeline", "fused_layer"])
def test_edge_permutation_invariance(impl):
    cfg = _small(TCFG)
    _, tp = _jax_params(_small(JCFG), seed=3)
    _, tg = _graphs(packed=True)
    perm = np.random.default_rng(0).permutation(tg.n_edge_pad)
    base = _port_apply(cfg, tp, tg, impl)
    permuted = _port_apply(cfg, tp, permute_edges(tg, perm), impl)
    np.testing.assert_allclose(base, permuted, **TOL)


@pytest.mark.parametrize("impl,per_layer", [("fused_layer", 1),
                                            ("pipeline", 1),
                                            ("fused", 2)])
def test_edge_passes_per_layer(impl, per_layer):
    """One pass over the edge stream per layer under fused_layer and
    pipeline (the reference's figure); gather/phi and the scatter apart
    under fused."""
    cfg = TCFG["gin"]
    tp = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, tg = _graphs(packed=False)
    with count_edge_passes() as ps:
        tmake(cfg).apply(tp, tg, cfg, DataflowConfig(impl=impl))
    assert ps.passes == per_layer * cfg.num_layers
    with jmp.count_edge_passes() as pj:
        jcfg = JCFG["gin"]
        jax.eval_shape(lambda p, g: jmake(jcfg).apply(
            p, g, jcfg, jmp.DataflowConfig(impl=impl, scan_layers=False)),
            _jax_params(jcfg)[0], _graphs(packed=False)[0])
    assert ps.passes == pj.passes


@pytest.mark.parametrize("flags", [
    dict(),
    dict(with_degrees=False, with_graph_counts=True),
    dict(with_degrees=False, with_self_loop_norm=True),
    dict(with_self_loop_norm=True, with_graph_counts=True),
])
def test_precompute_graph_stats_matches_reference(flags):
    """The port's statistics equal the reference's: in-degrees and node
    counts bitwise (small integers in f32), 1/sqrt(deg + 1) to 1e-6; and
    each sweep over the edge stream is counted as the reference counts it."""
    jg, tg = _graphs(packed=True)
    with count_edge_passes() as ps:
        ours = tmp.precompute_graph_stats(tg, **flags)
    with jmp.count_edge_passes() as pj:
        ref = jmp.precompute_graph_stats(jg, **flags)
    assert ps.passes == pj.passes
    for name in ("degrees", "inv_sqrt_deg", "graph_node_counts"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(
                a.numpy(), np.asarray(b), atol=0,
                rtol=1e-6 if name == "inv_sqrt_deg" else 0, err_msg=name)


def test_gin_init_shapes_match_reference():
    cfg = TCFG["gin"]
    tp = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp = jmake(JCFG["gin"]).init(jax.random.PRNGKey(0), JCFG["gin"])
    leaves_t = jax.tree_util.tree_leaves(params_to_numpy(tp))
    leaves_j = jax.tree_util.tree_leaves(jp)
    assert [a.shape for a in leaves_t] == [np.shape(a) for a in leaves_j]
    w = tp["layers"][0]["mlp"][0]["w"]
    assert abs(float(w.std()) - (2.0 / 300) ** 0.5) < 0.01
    again = gin_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["head"][0]["w"], tp["head"][0]["w"])


def test_unported_models_and_impls_raise():
    """An unknown model raises KeyError. The impls once unported here
    (kernel, twopass, banked) now run and agree with the reference under
    the same impl, with the same passes; banked raises ValueError on both
    sides when the padded nodes do not divide into the banks."""
    with pytest.raises(KeyError):
        tmake(GNNConfig(model="nope"))
    cfg, jcfg = _small(TCFG), _small(JCFG)
    jp, tp = _jax_params(jcfg)
    jg, tg = _graphs(packed=False)
    for impl in ("kernel", "twopass", "banked"):
        with count_edge_passes() as ps:
            ours = _port_apply(cfg, tp, tg, impl)
        with jmp.count_edge_passes() as pj:
            ref = np.asarray(jmake(jcfg).apply(
                jp, jg, jcfg,
                jmp.DataflowConfig(impl=impl, scan_layers=False)))
        assert ps.passes == pj.passes, impl
        # the reference's kernel arm runs its interpret-mode Pallas kernels
        np.testing.assert_allclose(
            ours, ref, **(dict(atol=1e-4, rtol=1e-4) if impl == "kernel"
                          else TOL), err_msg=impl)
    with pytest.raises(ValueError):
        tmake(cfg).apply(tp, tg, cfg, DataflowConfig(impl="banked",
                                                     num_banks=3))
    with pytest.raises(ValueError):
        jmake(jcfg).apply(jp, jg, jcfg, jmp.DataflowConfig(
            impl="banked", num_banks=3, scan_layers=False))
