"""The port's GAT and GCN forwards, and its ``pipeline`` arm, against the
JAX package's, on the CPU.

Both sides get the same graphs (the JAX generators through each side's
``build_graph_batch``) and the same weights (the JAX ``init``, moved across
through ``params_from_numpy``). The reference runs unrolled
(``scan_layers=False``). Tolerances: atol = rtol = 1e-5 against the
reference's jnp forward, what it holds between its own eager and compiled
forwards; 1e-4 against its interpret-mode Pallas pipeline, what it holds
between that kernel path and its unfused path
(``tests/test_mp_pipeline.py``), since the kernel's online softmax and
one-hot products round differently.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import message_passing as jmp  # noqa: E402
from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.graph import concat_raw_graphs  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro_torch.checkpoint.convert import (params_from_numpy,  # noqa: E402
                                            params_to_numpy)
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.graph import permute_edges  # noqa: E402
from repro_torch.core import message_passing as tmpass  # noqa: E402
from repro_torch.core.message_passing import (DataflowConfig,  # noqa: E402
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import gat_init, gcn_init  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402
from repro_torch.kernels import mp_pipeline as tmp  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ("fused", "pipeline", "fused_layer")


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


def _port_apply(cfg, params, g, impl):
    return tmake(cfg).apply(params, g, cfg,
                            DataflowConfig(impl=impl)).numpy()


def _ref_apply(cfg, params, g, impl):
    return np.asarray(jmake(cfg).apply(
        params, g, cfg, jmp.DataflowConfig(impl=impl, scan_layers=False)))


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
@pytest.mark.parametrize("name", ["gat", "gcn"])
def test_small_model_matches_reference(name, impl, packed):
    """3 layers, hidden 16 (GAT: 4 heads x 16), alone and 3 graphs packed,
    against the reference's jnp forward."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=1)
    jg, tg = _graphs(packed)
    ours = _port_apply(tcfg, tp, tg, impl)
    np.testing.assert_allclose(ours, _ref_apply(jcfg, jp, jg, impl), **TOL)
    assert ours.shape == (tg.n_graph_pad, tcfg.out_dim)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("name", ["gat", "gcn", "gin"])
@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_matches_forced_kernel(name, packed):
    """impl='pipeline' against the reference's interpret-mode Pallas
    mp_pipeline (online softmax for GAT, scalar src_weight for GCN, edge
    term and relu for GIN)."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=4)
    jg, tg = _graphs(packed)
    ours = _port_apply(tcfg, tp, tg, "pipeline")
    np.testing.assert_allclose(
        ours, _forced_kernel(jcfg, jp, jg, "pipeline"), **KERNEL_TOL)


@pytest.mark.parametrize("name", ["gat", "gcn"])
def test_fused_layer_matches_forced_kernel(name):
    """impl='fused_layer': GAT's one mp_pipeline launch per layer, GCN's one
    layer_fused launch (per-node self term, scalar src_weight), against the
    reference's interpret-mode kernels."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg, seed=5)
    jg, tg = _graphs(packed=True)
    ours = _port_apply(tcfg, tp, tg, "fused_layer")
    np.testing.assert_allclose(
        ours, _forced_kernel(jcfg, jp, jg, "fused_layer"), **KERNEL_TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ["gat", "gcn", "gin"])
def test_edge_passes_equal_reference(name, impl):
    """Passes over the edge stream per forward, as the reference counts
    them: GAT 5 under pipeline / fused_layer and 25 under fused (3 for the
    softmax, the message, the sum); GCN one more for its degree sweep; GIN
    5 under pipeline."""
    jcfg, tcfg = JCFG[name], TCFG[name]
    jp, tp = _jax_params(jcfg)
    jg, tg = _graphs(packed=False)
    with count_edge_passes() as ps:
        tmake(tcfg).apply(tp, tg, tcfg, DataflowConfig(impl=impl))
    with jmp.count_edge_passes() as pj:
        jax.eval_shape(lambda p, g: jmake(jcfg).apply(
            p, g, jcfg, jmp.DataflowConfig(impl=impl, scan_layers=False)),
            jp, jg)
    assert ps.passes == pj.passes
    layers = tcfg.num_layers
    want = {("gat", "fused"): 5 * layers}.get((name, impl), layers)
    if name == "gcn":
        want = (2 * layers if impl == "fused" else layers) + 1
    elif name == "gin" and impl == "fused":
        want = 2 * layers
    assert ps.passes == want


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ["gat", "gcn"])
def test_edge_permutation_invariance(name, impl):
    cfg = _small(TCFG, name)
    _, tp = _jax_params(_small(JCFG, name), seed=3)
    _, tg = _graphs(packed=True)
    perm = np.random.default_rng(0).permutation(tg.n_edge_pad)
    base = _port_apply(cfg, tp, tg, impl)
    permuted = _port_apply(cfg, tp, permute_edges(tg, perm), impl)
    np.testing.assert_allclose(base, permuted, **TOL)


@pytest.mark.parametrize("name", ["gat", "gcn"])
def test_engine_serves_and_matches_reference_engine(name):
    """GraphStreamEngine(device='cpu') serves the model under fused_layer
    like the reference engine, one pass per layer (GCN: plus the degree
    sweep) in every bucket, and GAT's edge phase goes through
    mp_pipeline's plain version with no launch."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg)
    graphs = list(molhiv_like(seed=0, n_graphs=8))[4:]

    def args(g):
        return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos

    with JEngine(jcfg, jp, jmp.DataflowConfig(impl="fused_layer",
                                              scan_layers=False)) as je:
        ref = [je.process(*args(g)) for g in graphs]
    before = tmp.mp_pipeline.launches
    with GraphStreamEngine(tcfg, tp, DataflowConfig(impl="fused_layer"),
                           device="cpu") as te:
        ours = [te.process(*args(g)) for g in graphs]
        passes = dict(te.edge_passes)
    assert tmp.mp_pipeline.launches == before
    for a, b in zip(ours, ref):
        assert a.shape == (jcfg.out_dim,)
        np.testing.assert_allclose(a, b, **TOL)
    # these molecules land in three buckets: (32, 64), (32, 128), (64, 128)
    assert len(passes) == 3
    assert set(passes.values()) == {tcfg.num_layers + (name == "gcn")}


@pytest.mark.parametrize("name,init", [("gat", gat_init), ("gcn", gcn_init)])
def test_init_shapes_and_round_trip_match_reference(name, init):
    """Each init draws the reference's leaf shapes and scales from one
    torch.Generator; the converter carries the JAX leaves (GAT's (H, Dh)
    attention halves, GCN's per-layer dense leaves) across and back
    unchanged."""
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
    if name == "gat":
        a_src = tp["layers"][0]["a_src"]
        assert a_src.shape == (cfg.heads, cfg.head_dim)
        assert abs(float(a_src.std()) - 0.1) < 0.05
    w = tp["layers"][1]["w"]["w"] if name == "gat" else tp["layers"][1]["w"]
    d = w.shape[0]
    assert abs(float(w.std()) - (1.0 / d) ** 0.5) < 0.03
    again = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["head"][0]["w"], tp["head"][0]["w"])


def _fusable_pair(rng, e, d, n, *, sw=None, edge_term=False, bias=False,
                  relu=False, heads=0):
    """One FusableMessage for each side, from the same numpy draws."""
    import jax.numpy as jnp
    kw = {"activation": "relu" if relu else "none"}
    if sw == "scalar":
        kw["src_weight"] = rng.normal(size=(e,)).astype(np.float32)
    elif sw == "full":
        kw["src_weight"] = rng.normal(size=(e, d)).astype(np.float32)
    if edge_term:
        kw["edge_term"] = rng.normal(size=(e, d)).astype(np.float32)
    if bias:
        kw["bias"] = rng.normal(size=(d,)).astype(np.float32)
    att = {}
    if heads:
        att = {k: rng.normal(size=(n, heads)).astype(np.float32)
               for k in ("src_logits", "dst_logits")}

    def side(mod, conv):
        a = (mod.FusableAttention(**{k: conv(v) for k, v in att.items()})
             if att else None)
        return mod.FusableMessage(
            attention=a, **{k: conv(v) if isinstance(v, np.ndarray) else v
                            for k, v in kw.items()})

    return side(jmp, jnp.asarray), side(tmpass, torch.from_numpy)


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kinds,phi", [
    (("mean", "std", "max", "min"), dict(edge_term=True, relu=True)),
    (("sum", "var", "max"), dict(sw="scalar", bias=True)),
    (("min", "mean"), dict(sw="full", edge_term=True)),
])
def test_fused_edge_aggregate_kinds_match_reference(kinds, phi, with_degrees,
                                                    force):
    """The kinds ``_derive_kinds`` builds from mp_pipeline's raw
    accumulators (mean, var, std; max and min 0 where no edge arrives),
    with validity from the shared degrees or from the kernel's own count,
    against the reference's ``fused_edge_aggregate``: its jnp mirror at
    1e-5, its interpret-mode Pallas kernel (forced) at 1e-4. Padded nodes
    are the empty destinations. One pass over the edges."""
    import jax.numpy as jnp
    jg, tg = _graphs(packed=True)
    rng = np.random.default_rng(len(kinds) + 7 * with_degrees)
    n, e, d = tg.n_node_pad, tg.n_edge_pad, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    jf, tf = _fusable_pair(rng, e, d, n, **phi)
    jst = jmp.precompute_graph_stats(jg) if with_degrees else None
    tst = tmpass.precompute_graph_stats(tg) if with_degrees else None
    with count_edge_passes() as ps:
        ours = tmpass.fused_edge_aggregate(tg, torch.from_numpy(x), tf,
                                           kinds=kinds, stats=tst)
    assert ps.passes == 1
    jmp._FORCE_PIPELINE_KERNEL = force
    try:
        ref = jmp.fused_edge_aggregate(jg, jnp.asarray(x), jf, kinds=kinds,
                                       stats=jst)
    finally:
        jmp._FORCE_PIPELINE_KERNEL = False
    assert tuple(ours) == kinds
    empty = ~tg.node_mask.numpy()
    for k in kinds:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k,
                                   **(KERNEL_TOL if force else TOL))
        if k in ("sum", "mean", "max", "min", "var"):
            assert (ours[k].numpy()[empty] == 0.0).all(), k


def test_fused_edge_aggregate_rejects_what_the_reference_rejects():
    """Empty or unknown kinds, attention with another kind than 'sum', and
    attention with a src_weight raise ValueError on both sides."""
    import jax.numpy as jnp
    jg, tg = _graphs(packed=False)
    rng = np.random.default_rng(0)
    n, e, d = tg.n_node_pad, tg.n_edge_pad, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    plain = _fusable_pair(rng, e, d, n)
    att = _fusable_pair(rng, e, d, n, heads=2)
    att_sw = _fusable_pair(rng, e, d, n, sw="scalar", heads=2)
    for (jf, tf), kinds in ((plain, ()), (plain, ("median",)),
                            (att, ("mean",)), (att, ("sum", "max")),
                            (att_sw, ("sum",))):
        with pytest.raises(ValueError):
            jmp.fused_edge_aggregate(jg, jnp.asarray(x), jf, kinds=kinds)
        with pytest.raises(ValueError):
            tmpass.fused_edge_aggregate(tg, torch.from_numpy(x), tf,
                                        kinds=kinds)
