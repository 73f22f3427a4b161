"""The port's PNA, DGN and GIN-VN forwards, and the statistics and the plain
aggregation unit they use, against the JAX package's, on the CPU.

Both sides get the same graphs (the JAX generators through each side's
``build_graph_batch``, DGN's field from each graph's ``node_pos``) and the
same weights (the JAX ``init``, moved across through ``params_from_numpy``).
The reference runs unrolled (``scan_layers=False``). Tolerances: atol =
rtol = 1e-5 against the reference's jnp forward, what it holds between its
own eager and compiled forwards; 1e-4 against its interpret-mode Pallas
kernels (``_FORCE_PIPELINE_KERNEL``), what it holds between that kernel
path and its unfused path, since the kernels' one-hot products and keyed
extrema round differently.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import message_passing as jmp  # noqa: E402
from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.graph import concat_raw_graphs  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_numpy,  # noqa: E402
                                            params_to_numpy)
from repro_torch.core import message_passing as tmpass  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.graph import permute_edges  # noqa: E402
from repro_torch.core.message_passing import (DataflowConfig,  # noqa: E402
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import (dgn_init, gin_vn_init,  # noqa: E402
                                     pna_init)
from repro_torch.core.models import make_gnn as tmake  # noqa: E402
from repro_torch.kernels import layer_fused as tlf  # noqa: E402
from repro_torch.kernels import mp_pipeline as tmp  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ("fused", "pipeline", "fused_layer")
MODELS = ("pna", "dgn", "gin_vn")


def _small(cfgs, name):
    return cfgs[name].replace(num_layers=3, hidden_dim=16)


def _graphs(packed):
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


def _port_apply(cfg, params, g, impl, **df):
    return tmake(cfg).apply(params, g, cfg,
                            DataflowConfig(impl=impl, **df)).numpy()


def _ref_apply(cfg, params, g, impl, **df):
    return np.asarray(jmake(cfg).apply(
        params, g, cfg,
        jmp.DataflowConfig(impl=impl, scan_layers=False, **df)))


def _forced_kernel(cfg, params, g, impl):
    """The reference forward with its Pallas kernels forced (interpret
    mode), the package's test hook set and restored here."""
    jmp._FORCE_PIPELINE_KERNEL = True
    try:
        return _ref_apply(cfg, params, g, impl)
    finally:
        jmp._FORCE_PIPELINE_KERNEL = False


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_small_model_matches_reference(name, impl, packed):
    """3 layers, hidden 16, alone and 3 graphs packed, against the
    reference's jnp forward: PNA's scalers and DGN's field under
    fused_layer run layer_fused's plain version here, where the reference
    runs its edge-phase mirror and the update apart."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=1)
    jg, tg = _graphs(packed)
    ours = _port_apply(tcfg, tp, tg, impl)
    np.testing.assert_allclose(ours, _ref_apply(jcfg, jp, jg, impl), **TOL)
    assert ours.shape == (tg.n_graph_pad, tcfg.out_dim)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("impl", ["pipeline", "fused_layer"])
@pytest.mark.parametrize("name", MODELS)
def test_fusable_impls_match_forced_kernel(name, impl):
    """pipeline (one mp_pipeline launch a layer: PNA's four statistics,
    DGN's full (E, 2D) src_weight) and fused_layer (one layer_fused launch:
    PNA's scalers, DGN's field, GIN-VN's self term) against the
    reference's interpret-mode Pallas kernels, 3 graphs packed."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=4)
    jg, tg = _graphs(packed=True)
    ours = _port_apply(tcfg, tp, tg, impl)
    np.testing.assert_allclose(
        ours, _forced_kernel(jcfg, jp, jg, impl), **KERNEL_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_per_kind_loop_matches_reference(name):
    """impl='fused' with single_pass=False: one sweep family per kind."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=2)
    jg, tg = _graphs(packed=True)
    ours = _port_apply(tcfg, tp, tg, "fused", single_pass=False)
    np.testing.assert_allclose(
        ours, _ref_apply(jcfg, jp, jg, "fused", single_pass=False), **TOL)


@pytest.mark.parametrize("df", [dict(impl=i) for i in IMPLS]
                         + [dict(impl="fused", single_pass=False)],
                         ids=list(IMPLS) + ["fused_per_kind"])
@pytest.mark.parametrize("name", MODELS)
def test_edge_passes_equal_reference(name, df):
    """Passes over the edge stream per forward at the paper configs, as the
    reference counts them: under pipeline and fused_layer one a layer plus
    the statistics' sweeps (PNA 1 for the degrees, DGN 3 with the field,
    GIN-VN none)."""
    jcfg, tcfg = JCFG[name], TCFG[name]
    jp, tp = _jax_params(jcfg)
    jg, tg = _graphs(packed=False)
    with count_edge_passes() as ps:
        tmake(tcfg).apply(tp, tg, tcfg, DataflowConfig(**df))
    with jmp.count_edge_passes() as pj:
        jax.eval_shape(lambda p, g: jmake(jcfg).apply(
            p, g, jcfg, jmp.DataflowConfig(scan_layers=False, **df)),
            jp, jg)
    assert ps.passes == pj.passes
    if df["impl"] != "fused":
        stat_sweeps = {"pna": 1, "dgn": 3, "gin_vn": 0}[name]
        assert ps.passes == tcfg.num_layers + stat_sweeps


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_edge_permutation_invariance(name, impl):
    cfg = _small(TCFG, name)
    _, tp = _jax_params(_small(JCFG, name), seed=3)
    _, tg = _graphs(packed=True)
    perm = np.random.default_rng(0).permutation(tg.n_edge_pad)
    base = _port_apply(cfg, tp, tg, impl)
    permuted = _port_apply(cfg, tp, permute_edges(tg, perm), impl)
    np.testing.assert_allclose(base, permuted, **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_engine_serves_and_matches_reference_engine(name):
    """GraphStreamEngine(device='cpu') serves the model under fused_layer
    like the reference engine, DGN with each graph's node_pos; the same
    passes in every bucket, and no kernel launch on the CPU."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg)
    graphs = list(molhiv_like(seed=0, n_graphs=8))[4:]

    def args(g):
        return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos

    with JEngine(jcfg, jp, jmp.DataflowConfig(impl="fused_layer",
                                              scan_layers=False)) as je:
        ref = [je.process(*args(g)) for g in graphs]
    before = (tlf.layer_fused.launches, tmp.mp_pipeline.launches)
    with GraphStreamEngine(tcfg, tp, DataflowConfig(impl="fused_layer"),
                           device="cpu") as te:
        ours = [te.process(*args(g)) for g in graphs]
        passes = dict(te.edge_passes)
    assert (tlf.layer_fused.launches, tmp.mp_pipeline.launches) == before
    for a, b in zip(ours, ref):
        assert a.shape == (jcfg.out_dim,)
        np.testing.assert_allclose(a, b, **TOL)
    assert len(passes) == 3
    stat_sweeps = {"pna": 1, "dgn": 3, "gin_vn": 0}[name]
    assert set(passes.values()) == {tcfg.num_layers + stat_sweeps}


@pytest.mark.parametrize("name,init", [("pna", pna_init), ("dgn", dgn_init),
                                       ("gin_vn", gin_vn_init)])
def test_init_shapes_and_round_trip_match_reference(name, init):
    """Each init draws the reference's leaf shapes and scales from one
    torch.Generator (PNA's 13·80-wide post layer, DGN's 3·100, GIN-VN's
    four virtual-node MLPs); the converter carries the JAX leaves across
    and back unchanged."""
    cfg = TCFG[name]
    tp = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jp, moved = _jax_params(JCFG[name])
    flat_j, tree_j = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, jp))
    flat_t, tree_t = jax.tree_util.tree_flatten(params_to_numpy(tp))
    assert tree_t == tree_j
    assert [a.shape for a in flat_t] == [a.shape for a in flat_j]
    flat_b, tree_b = jax.tree_util.tree_flatten(params_to_numpy(moved))
    assert tree_b == tree_j
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    d = cfg.hidden_dim
    if name == "gin_vn":
        assert len(tp["vn_mlps"]) == cfg.num_layers - 1
        w = tp["vn_mlps"][0][0]["w"]
    else:
        w = tp["layers"][1]["post"]["w"]
        assert w.shape == ((13 if name == "pna" else 3) * d, d)
    assert abs(float(w.std()) - (2.0 / sum(w.shape)) ** 0.5) < 0.01
    again = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["head"][0]["w"], tp["head"][0]["w"])


# ---------------------------------------------------------------------------
# the statistics and the plain aggregation unit
# ---------------------------------------------------------------------------

def test_precompute_graph_stats_matches_reference():
    """Degrees, PNA's three scalers and DGN's field weights and their sums,
    padded rows and edges included; one pass for the degrees and two for
    the field."""
    jg, tg = _graphs(packed=True)
    kw = dict(pna_delta=1.3, with_dgn_field=True, with_graph_counts=True)
    with count_edge_passes() as ps:
        ours = tmpass.precompute_graph_stats(tg, **kw)
    with jmp.count_edge_passes() as pj:
        ref = jmp.precompute_graph_stats(jg, **kw)
    assert ps.passes == pj.passes == 3
    for field in ("degrees", "pna_scalers", "dgn_weights", "dgn_wsum",
                  "graph_node_counts"):
        np.testing.assert_allclose(getattr(ours, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   err_msg=field, **TOL)
    assert ours.pna_scalers.shape == (tg.n_node_pad, 3)
    assert ours.inv_sqrt_deg is None


def _messages(packed=True, d=8, seed=0):
    jg, tg = _graphs(packed)
    rng = np.random.default_rng(seed)
    msg = rng.normal(size=(tg.n_edge_pad, d)).astype(np.float32)
    return jg, tg, msg


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kind", tmpass.AGG_KINDS)
def test_segment_aggregate_matches_reference(kind, with_degrees):
    """Every kind of AGG_KINDS in the plain arm, with the degrees shared or
    swept here; empty destinations (the padded nodes) give 0, and the
    passes match the reference's."""
    jg, tg, msg = _messages(seed=len(kind))
    deg_t = deg_j = None
    if with_degrees:
        deg_t = tmpass.precompute_graph_stats(tg).degrees
        deg_j = jmp.precompute_graph_stats(jg).degrees
    with count_edge_passes() as ps:
        ours = tmpass.segment_aggregate(
            torch.from_numpy(msg), tg.receivers, tg.n_node_pad, kind=kind,
            edge_mask=tg.edge_mask, degrees=deg_t)
    with jmp.count_edge_passes() as pj:
        ref = jmp.segment_aggregate(
            jnp.asarray(msg), jg.receivers, jg.n_node_pad, kind=kind,
            edge_mask=jg.edge_mask, degrees=deg_j)
    assert ps.passes == pj.passes
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    empty = ~tg.node_mask.numpy()
    want = np.sqrt(np.float32(1e-5)) if kind == "std" else 0.0
    np.testing.assert_allclose(ours.numpy()[empty], want, rtol=1e-6)


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kinds", [
    ("mean", "std", "max", "min"),
    ("sum", "mean"),
    ("sum", "var", "max"),
    ("min", "std"),
])
def test_segment_multi_aggregate_matches_reference(kinds, with_degrees):
    """The single-pass arm: the stacked [s1 | s2 | count] sweep, max and min
    one sweep each, masked edges sent past the last row; empty
    destinations give 0 for every kind but std."""
    jg, tg, msg = _messages(seed=len(kinds) + 10 * with_degrees)
    deg_t = deg_j = None
    if with_degrees:
        deg_t = tmpass.precompute_graph_stats(tg).degrees
        deg_j = jmp.precompute_graph_stats(jg).degrees
    with count_edge_passes() as ps:
        ours = tmpass.segment_multi_aggregate(
            torch.from_numpy(msg), tg.receivers, tg.n_node_pad, kinds=kinds,
            edge_mask=tg.edge_mask, degrees=deg_t)
    with jmp.count_edge_passes() as pj:
        ref = jmp.segment_multi_aggregate(
            jnp.asarray(msg), jg.receivers, jg.n_node_pad, kinds=kinds,
            edge_mask=jg.edge_mask, degrees=deg_j)
    assert ps.passes == pj.passes
    assert tuple(ours) == kinds
    empty = ~tg.node_mask.numpy()
    for k in kinds:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
        if k != "std":
            assert (ours[k].numpy()[empty] == 0.0).all(), k


def test_aggregation_rejects_what_the_reference_rejects():
    """Unknown or empty kinds and 1-D messages raise ValueError on both
    sides. The impl='kernel' and 'banked' arms run and agree with the
    reference's; banked raises ValueError on both sides when the nodes do
    not divide into the banks."""
    jg, tg, msg = _messages(packed=False)
    tm, jm = torch.from_numpy(msg), jnp.asarray(msg)
    n = tg.n_node_pad
    for call in (
            lambda: tmpass.segment_aggregate(tm, tg.receivers, n,
                                             kind="median"),
            lambda: tmpass.segment_multi_aggregate(tm, tg.receivers, n,
                                                   kinds=()),
            lambda: tmpass.segment_multi_aggregate(tm[:, 0], tg.receivers,
                                                   n, kinds=("sum",)),
            lambda: jmp.segment_aggregate(jm, jg.receivers, n,
                                          kind="median"),
            lambda: jmp.segment_multi_aggregate(jm, jg.receivers, n,
                                                kinds=()),
            lambda: jmp.segment_multi_aggregate(jm[:, 0], jg.receivers, n,
                                                kinds=("sum",))):
        with pytest.raises(ValueError):
            call()
    for impl in ("kernel", "banked"):
        df, jdf = DataflowConfig(impl=impl), jmp.DataflowConfig(impl=impl)
        ours = tmpass.segment_aggregate(tm, tg.receivers, n, kind="mean",
                                        edge_mask=tg.edge_mask, dataflow=df)
        ref = jmp.segment_aggregate(jm, jg.receivers, n, kind="mean",
                                    edge_mask=jg.edge_mask, dataflow=jdf)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   err_msg=impl, **TOL)
        ours = tmpass.segment_multi_aggregate(
            tm, tg.receivers, n, kinds=("sum", "max"),
            edge_mask=tg.edge_mask, dataflow=df)
        ref = jmp.segment_multi_aggregate(
            jm, jg.receivers, n, kinds=("sum", "max"),
            edge_mask=jg.edge_mask, dataflow=jdf)
        for k in ("sum", "max"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                       err_msg=f"{impl} {k}", **TOL)
    df = DataflowConfig(impl="banked", num_banks=3)
    jdf = jmp.DataflowConfig(impl="banked", num_banks=3)
    for call in (
            lambda: tmpass.segment_aggregate(tm, tg.receivers, n, kind="sum",
                                             dataflow=df),
            lambda: tmpass.segment_multi_aggregate(
                tm, tg.receivers, n, kinds=("sum", "max"), dataflow=df),
            lambda: jmp.segment_aggregate(jm, jg.receivers, n, kind="sum",
                                          dataflow=jdf),
            lambda: jmp.segment_multi_aggregate(
                jm, jg.receivers, n, kinds=("sum", "max"), dataflow=jdf)):
        with pytest.raises(ValueError):
            call()
