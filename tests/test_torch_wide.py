"""Wide placement in the port (``repro_torch/distributed/wide.py`` and the
engine's gang), against the JAX package on the CPU.

Twins of ``tests/test_wide.py``: the merge algebra, the planner's layout
invariants, the host-loop reference runner, the admission gate, the pool
check and the autotune fingerprint; the reference's SPMD parity and
edge-pass tests become the port's gang runner (``build_wide_forward`` on
``devices=["cpu"] * K``, run eagerly). Beyond them: ``plan_wide`` gives
arrays identical to the reference's, and the port's runners match the JAX
package's unrolled single-device forward (``scan_layers=False``) and its
``wide_forward_reference`` for all six models at K in {2, 3, 4}, at
rtol 1e-5 and atol 1e-6, with the same weights (the JAX ``init`` moved
across) on the same ``mesh_like`` graph. The engine's gang is held to the
port's own single-device forward at a larger bucket (the reference's twin,
``test_engine_gang_serves_oversized_graph``, fails under jax 0.9.0), and
its failure paths (a member's death, transient failures, deadlines) run
through ``_serve_wide`` patched to fail. Every wait has its own timeout.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import models as JM  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.message_passing import DataflowConfig as JDataflow  # noqa
from repro.distributed import wide as JW  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core import models as TM  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.errors import (BatchFailed,  # noqa: E402
                                     DeadlineExceeded, GraphTooLarge)
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.graph import pad_bucket  # noqa: E402
from repro_torch.core.message_passing import (DataflowConfig,  # noqa: E402
                                              count_edge_passes,
                                              precompute_graph_stats)
from repro_torch.data.graphs import mesh_like  # noqa: E402
from repro_torch.distributed import wide as W  # noqa: E402
from repro_torch.distributed.pipeline import ring_perm, ring_shift  # noqa

MODELS = ("gin", "gin_vn", "gcn", "gat", "pna", "dgn")
PARITY = dict(rtol=1e-5, atol=1e-6)
WAIT_S = 120.0


def _mesh_graph(n=600, seed=0, node_dim=8, edge_dim=1):
    return next(mesh_like(seed=seed, n_graphs=1, n_nodes=n,
                          node_dim=node_dim, edge_dim=edge_dim))


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# merge algebra (the boundary-bank contract)
# ---------------------------------------------------------------------------

def test_merge_partial_sums_is_left_fold(rng):
    parts = [_t(rng.normal(size=(5, 3)).astype(np.float32))
             for _ in range(4)]
    got = W.merge_partial_sums(parts)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JW.merge_partial_sums(
            [jnp.asarray(p.numpy()) for p in parts])))


def test_merge_partial_extrema_neutral():
    a = torch.tensor([[1.0, -W.BIG], [-W.BIG, 2.0]])
    b = torch.tensor([[0.5, 3.0], [-W.BIG, -W.BIG]])
    mx = W.merge_partial_extrema([a, b], kind="max").numpy()
    np.testing.assert_array_equal(
        mx, np.asarray([[1.0, 3.0], [-W.BIG, 2.0]], np.float32))
    mn = W.merge_partial_extrema([-a, -b], kind="min").numpy()
    np.testing.assert_array_equal(
        mn, np.asarray([[-1.0, -3.0], [W.BIG, -2.0]], np.float32))
    with pytest.raises(ValueError):
        W.merge_partial_extrema([a, b], kind="mean")


@pytest.mark.parametrize("heads", [0, 2])
def test_merge_softmax_carries_matches_full_softmax(rng, heads):
    # K partial (m, l, s) carries merged flash-style == one softmax over
    # the union of every shard's edges, and == the reference's merge
    n, d, k, e = 6, 4, 3, 17
    shape = (e,) if heads == 0 else (e, heads)
    logits = [rng.normal(size=shape).astype(np.float32) for _ in range(k)]
    values = [rng.normal(size=(e, d)).astype(np.float32) for _ in range(k)]
    recv = [rng.integers(0, n, size=e).astype(np.int32) for _ in range(k)]
    parts = [W.softmax_carry(_t(lg), _t(v), _t(r), n)
             for lg, v, r in zip(logits, values, recv)]
    m, l, s = W.merge_softmax_carries(parts)
    jparts = [JW.softmax_carry(jnp.asarray(lg), jnp.asarray(v),
                               jnp.asarray(r), n)
              for lg, v, r in zip(logits, values, recv)]
    for got, want in zip((m, l, s), JW.merge_softmax_carries(jparts)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    if heads:
        return
    got = (s / torch.clamp(l, min=1e-16)[:, None]).numpy()
    all_lg, all_v = np.concatenate(logits), np.concatenate(values)
    all_r = np.concatenate(recv)
    want = np.zeros((n, d), np.float32)
    for i in range(n):
        sel = all_r == i
        if not sel.any():
            continue
        w = np.exp(all_lg[sel] - all_lg[sel].max())
        want[i] = (w[:, None] * all_v[sel]).sum(0) / w.sum()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_softmax_carry_masked_edges_are_neutral(rng):
    e, n, d = 12, 4, 3
    lg = _t(rng.normal(size=e).astype(np.float32))
    v = _t(rng.normal(size=(e, d)).astype(np.float32))
    r = _t(rng.integers(0, n, size=e).astype(np.int32))
    mask = _t(rng.random(e) < 0.5)
    m1, l1, s1 = W.softmax_carry(lg, v, r, n, edge_mask=mask)
    m2, l2, s2 = W.softmax_carry(lg[mask], v[mask], r[mask], n)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_plan_dest_ownership_and_halo_layout():
    g = _mesh_graph(n=500, seed=1)
    n = g.node_feat.shape[0]
    for k in (2, 4):
        plan = W.plan_wide(g.senders, g.receivers, n, k=k)
        covered = np.zeros(g.senders.shape[0], bool)
        for sp in plan.shards:
            glob_recv = sp.receivers.astype(np.int64) + sp.lo
            assert glob_recv.min() >= sp.lo
            assert glob_recv.max() < sp.lo + sp.n_own
            np.testing.assert_array_equal(glob_recv,
                                          g.receivers[sp.edge_ids])
            assert (np.diff(sp.edge_ids) > 0).all()    # global edge order
            assert not covered[sp.edge_ids].any()
            covered[sp.edge_ids] = True
            row_to_global = np.full(plan.n_pad, -1, np.int64)
            row_to_global[:sp.n_own] = np.arange(sp.lo, sp.lo + sp.n_own)
            for s, ids in enumerate(sp.halo_ids, start=1):
                base = plan.n_own_pad + (s - 1) * plan.h_pad
                row_to_global[base:base + len(ids)] = ids
            np.testing.assert_array_equal(row_to_global[sp.senders],
                                          g.senders[sp.edge_ids])
        assert covered.all()


def test_plan_send_tables_feed_the_right_halo():
    g = _mesh_graph(n=400, seed=2)
    plan = W.plan_wide(g.senders, g.receivers, 400, k=4)
    for kk, sp in enumerate(plan.shards):
        for s in range(1, plan.k):
            src = plan.shards[(kk - s) % plan.k]
            ids = sp.halo_ids[s - 1]
            sent = src.send_idx[s - 1][:len(ids)].astype(np.int64) + src.lo
            np.testing.assert_array_equal(sent, ids)


def test_plan_bucket_rounding_shares_programs():
    g1, g2 = _mesh_graph(n=590, seed=3), _mesh_graph(n=640, seed=4)
    p1 = W.plan_wide(g1.senders, g1.receivers, 590, k=4)
    p2 = W.plan_wide(g2.senders, g2.receivers, 640, k=4)
    assert p1.bucket == p2.bucket
    assert p1.n_own_pad == pad_bucket(-(-590 // 4))


def test_plan_budget_rejection():
    g = _mesh_graph(n=500, seed=5)
    with pytest.raises(W.WidePlanError):
        W.plan_wide(g.senders, g.receivers, 500, k=2, node_budget=64)
    with pytest.raises(W.WidePlanError):
        W.plan_wide(g.senders, g.receivers, 500, k=2, edge_budget=64)
    with pytest.raises(ValueError):
        W.plan_wide(g.senders, g.receivers, 500, k=1)


def test_halo_accounting():
    g = _mesh_graph(n=500, seed=6)
    plan = W.plan_wide(g.senders, g.receivers, 500, k=4)
    want = sum(int(sp.halo_counts.sum()) for sp in plan.shards)
    assert plan.halo_rows_per_layer == want
    assert plan.halo_bytes_per_layer(64) == want * 64 * 4
    assert plan.halo_rows_per_layer < 500 // 4


@pytest.mark.parametrize("n,k,seed", [(300, 2, 11), (300, 3, 11),
                                      (300, 4, 11), (1500, 4, 3),
                                      (2040, 4, 0)])
def test_plan_wide_matches_the_reference(n, k, seed):
    g = _mesh_graph(n=n, seed=seed, node_dim=9, edge_dim=3)
    tp = W.plan_wide(g.senders, g.receivers, n, k=k, node_budget=1024)
    jp = JW.plan_wide(g.senders, g.receivers, n, k=k, node_budget=1024)
    assert tp.bucket.__dict__ == jp.bucket.__dict__
    for f in ("k", "n_nodes", "n_edges", "halo_rows_per_layer"):
        assert getattr(tp, f) == getattr(jp, f)
    np.testing.assert_array_equal(tp.degrees, jp.degrees)
    for ts, js in zip(tp.shards, jp.shards, strict=True):
        assert (ts.index, ts.lo, ts.n_own) == (js.index, js.lo, js.n_own)
        for f in ("halo_counts", "send_idx", "senders", "receivers",
                  "edge_ids"):
            a, b = getattr(ts, f), getattr(js, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ts.halo_ids, js.halo_ids, strict=True):
            np.testing.assert_array_equal(a, b)
    ta = W.stack_shard_arrays(tp, g.node_feat, g.edge_feat, g.node_pos)
    ja = JW.stack_shard_arrays(jp, g.node_feat, g.edge_feat, g.node_pos)
    assert sorted(ta) == sorted(ja)
    for key in ta:
        assert ta[key].dtype == ja[key].dtype
        np.testing.assert_array_equal(ta[key], ja[key])


def test_plan_fails_where_the_reference_does():
    # a K=2 split of a graph over the largest bucket leaves no room for
    # halo rows (own n/2 pads to the whole bucket)
    g = _mesh_graph(n=1100, seed=0, node_dim=9, edge_dim=3)
    for mod in (W, JW):
        with pytest.raises(mod.WidePlanError):
            mod.plan_wide(g.senders, g.receivers, 1100, k=2,
                          node_budget=1024)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_ring_perm_and_shift():
    assert ring_perm(4, steps=1) == [(0, 1), (1, 2), (2, 3), (3, 0)]
    assert ring_perm(3, steps=2) == [(0, 2), (1, 0), (2, 1)]
    parts = [torch.full((2,), float(i)) for i in range(4)]
    for steps in (1, 2, 3):
        got = ring_shift(parts, steps=steps)
        assert [int(t[0]) for t in got] == [(i - steps) % 4
                                            for i in range(4)]


# ---------------------------------------------------------------------------
# the injected degrees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "pna", "dgn"])
def test_injected_degrees_give_the_computed_stats(model):
    g = _mesh_graph(n=300, seed=7, node_dim=9, edge_dim=3)
    b = tbuild(g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
               node_pos=g.node_pos, node_pad=512, edge_pad=2048,
               device="cpu")
    kw = {"gcn": dict(with_self_loop_norm=True),
          "pna": dict(pna_delta=1.3),
          "dgn": dict(with_dgn_field=True)}[model]
    with count_edge_passes() as ps:
        want = precompute_graph_stats(b, **kw)
    deg = torch.as_tensor(np.bincount(g.receivers, minlength=512)
                          .astype(np.float32))
    with count_edge_passes() as ps_inj:
        got = precompute_graph_stats(b, degrees=deg, **kw)
    assert ps_inj.passes == ps.passes - 1     # the degree sweep skipped
    for f in ("degrees", "inv_sqrt_deg", "pna_scalers", "dgn_weights",
              "dgn_wsum"):
        a, w = getattr(got, f), getattr(want, f)
        assert (a is None) == (w is None), f
        if a is not None:
            assert torch.equal(a, w), f


# ---------------------------------------------------------------------------
# the runners against the JAX package, all six models at K in {2, 3, 4}
# ---------------------------------------------------------------------------

_PARITY_GRAPH = _mesh_graph(n=300, seed=11, node_dim=9, edge_dim=3)
_JAX_SINGLE = {}


def _parity_case(model):
    """(JAX params, port params, config, the JAX unrolled single-device
    forward), made once per model."""
    if model not in _JAX_SINGLE:
        g = _PARITY_GRAPH
        n, e = g.node_feat.shape[0], g.senders.shape[0]
        cfg = JM.PAPER_GNN_CONFIGS[model].replace(num_layers=3,
                                                  hidden_dim=16)
        jm = JM.make_gnn(cfg)
        jp = jm.init(jax.random.PRNGKey(0), cfg)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        df = JDataflow(scan_layers=False)
        batch = jbuild(g.node_feat, g.senders, g.receivers,
                       edge_feat=g.edge_feat, node_pad=pad_bucket(n),
                       edge_pad=pad_bucket(e), node_pos=g.node_pos)
        ref = np.asarray(jax.jit(
            lambda p, b: jm.apply(p, b, cfg, df))(jp, batch))
        _JAX_SINGLE[model] = (jp, tp, cfg, ref)
    return _JAX_SINGLE[model]


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("model", MODELS)
def test_wide_runners_match_jax(model, k):
    g = _PARITY_GRAPH
    n = g.node_feat.shape[0]
    jp, tp, jcfg, ref = _parity_case(model)
    tcfg = TM.PAPER_GNN_CONFIGS[model].replace(num_layers=3, hidden_dim=16)
    jplan = JW.plan_wide(g.senders, g.receivers, n, k=k)
    jwide = np.asarray(JW.wide_forward_reference(
        jp, jcfg, jplan, g.node_feat, edge_feat=g.edge_feat,
        node_pos=g.node_pos, dataflow=JDataflow(scan_layers=False)))
    plan = W.plan_wide(g.senders, g.receivers, n, k=k)
    host = W.wide_forward_reference(
        tp, tcfg, plan, g.node_feat, edge_feat=g.edge_feat,
        node_pos=g.node_pos, device="cpu").numpy()
    fwd = W.build_wide_forward(tcfg, plan, W.wide_mesh(["cpu"] * k))
    gang = fwd(tp, W.stack_shard_arrays(plan, g.node_feat, g.edge_feat,
                                        g.node_pos)).numpy()
    for got in (host, gang):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **PARITY)
        np.testing.assert_allclose(got, jwide, **PARITY)
    # destination ownership: the gang's schedule is the host loop's
    np.testing.assert_array_equal(gang, host)


def test_reference_matches_single_device_port_forward():
    # the host loop against the port's own unsharded forward, bitwise:
    # every aggregate folds its edges in the single-device order
    g = _PARITY_GRAPH
    n, e = g.node_feat.shape[0], g.senders.shape[0]
    for model in ("gin", "gcn", "gat"):
        cfg = TM.PAPER_GNN_CONFIGS[model].replace(num_layers=3,
                                                  hidden_dim=16)
        m = TM.make_gnn(cfg)
        params = m.init(torch.Generator().manual_seed(0), cfg, device="cpu")
        b = tbuild(g.node_feat, g.senders, g.receivers,
                   edge_feat=g.edge_feat, node_pos=g.node_pos,
                   node_pad=pad_bucket(n), edge_pad=pad_bucket(e),
                   device="cpu")
        with torch.inference_mode():
            ref = m.apply(params, b, cfg, DataflowConfig()).numpy()
        plan = W.plan_wide(g.senders, g.receivers, n, k=3)
        got = W.wide_forward_reference(params, cfg, plan, g.node_feat,
                                       g.edge_feat, g.node_pos,
                                       device="cpu").numpy()
        np.testing.assert_allclose(got, ref, **PARITY)


@pytest.mark.parametrize("model,want", [("gin", 3), ("gcn", 3), ("gat", 3),
                                        ("pna", 3), ("dgn", 5)])
def test_fused_layer_one_edge_pass_per_layer_per_shard(model, want):
    # one pass a layer a shard under fused_layer; DGN adds its two hoisted
    # field sweeps, and PNA's and GCN's degrees are injected (no sweep)
    g = _PARITY_GRAPH
    n, e = g.node_feat.shape[0], g.senders.shape[0]
    cfg = TM.PAPER_GNN_CONFIGS[model].replace(num_layers=3)
    m = TM.make_gnn(cfg)
    params = m.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    df = DataflowConfig(impl="fused_layer")
    plan = W.plan_wide(g.senders, g.receivers, n, k=4)
    fwd = W.build_wide_forward(cfg, plan, W.wide_mesh(["cpu"] * 4), df)
    with count_edge_passes() as ps:
        out = fwd(params, W.stack_shard_arrays(plan, g.node_feat,
                                               g.edge_feat, g.node_pos))
    assert ps.passes == want
    b = tbuild(g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
               node_pos=g.node_pos, node_pad=pad_bucket(n),
               edge_pad=pad_bucket(e), device="cpu")
    with torch.inference_mode():
        ref = m.apply(params, b, cfg, df).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: admission, the pool, the fingerprint
# ---------------------------------------------------------------------------

def _small_cfg(**kw):
    return TM.GNNConfig(model="gin", num_layers=kw.pop("num_layers", 2),
                        hidden_dim=kw.pop("hidden_dim", 8), node_feat_dim=8,
                        edge_feat_dim=1, out_dim=kw.pop("out_dim", 2))


def _params(cfg, device="cpu"):
    return TM.make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device=device)


def test_graph_too_large_without_wide():
    cfg = _small_cfg()
    g = _mesh_graph(n=200, seed=8)
    with GraphStreamEngine(cfg, _params(cfg), buckets=(32, 64),
                           device="cpu") as eng:
        with pytest.raises(GraphTooLarge) as exc_info:
            eng.process(g.node_feat, g.senders, g.receivers, g.edge_feat)
        assert "wide=True" in str(exc_info.value)
        assert eng.stats.invalid_rejects == 1
        out = eng.submit(g.node_feat[:40], g.senders[:60] % 40,
                         g.receivers[:60] % 40, g.edge_feat[:60]
                         ).result(timeout=WAIT_S)
        assert np.all(np.isfinite(out))


def test_wide_needs_a_big_enough_pool():
    cfg = _small_cfg()
    with pytest.raises(ValueError):
        GraphStreamEngine(cfg, _params(cfg), wide=True, wide_k=5,
                          devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        GraphStreamEngine(cfg, _params(cfg), wide=True, wide_k=1,
                          devices=["cpu"] * 4)
    with pytest.raises(ValueError):            # wide_k: the pool, 1 here
        GraphStreamEngine(cfg, _params(cfg), wide=True, device="cpu")


def test_autotune_fingerprint_has_wide_component():
    cfg = _small_cfg()
    assert GraphStreamEngine.AUTOTUNE_CACHE_SCHEMA == 3
    with GraphStreamEngine(cfg, _params(cfg), buckets=(32, 64),
                           device="cpu") as eng:
        assert eng._cache_fingerprint().endswith("@wide1")
    with GraphStreamEngine(cfg, _params(cfg), buckets=(32, 64), wide=True,
                           wide_k=4, devices=["cpu"] * 4) as eng:
        assert eng._cache_fingerprint().endswith("@wide4")
    with GraphStreamEngine(cfg, _params(cfg), buckets=(32, 64), wide=True,
                           devices=["cpu"] * 3) as eng:
        assert eng._cache_fingerprint().endswith("@wide3")


# ---------------------------------------------------------------------------
# the engine's gang on devices=["cpu"] * 4
# ---------------------------------------------------------------------------

def _single(cfg, params, g, df):
    """The port's unsharded forward of ``g`` at the bucket of its size."""
    n, e = g.node_feat.shape[0], g.senders.shape[0]
    b = tbuild(g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
               node_pad=pad_bucket(n), edge_pad=pad_bucket(e),
               device="cpu")
    with torch.inference_mode():
        return TM.make_gnn(cfg).apply(params, b, cfg, df).numpy()[0]


@pytest.mark.parametrize("impl", ["fused", "fused_layer"])
def test_engine_gang_serves_oversized_graph(impl):
    # graphs ~2x one executor's largest bucket served by a 4-executor gang
    # beside narrow traffic on the same engine; one wide program serves
    # both wide size classes
    cfg = _small_cfg(num_layers=3, hidden_dim=16, out_dim=4)
    params = _params(cfg)
    df = DataflowConfig(impl=impl)
    eng = GraphStreamEngine(cfg, params, df,
                            buckets=(32, 64, 128, 256, 512), wide=True,
                            wide_k=4, devices=["cpu"] * 4)
    try:
        futs, graphs = [], []
        for i in range(5):
            g = _mesh_graph(n=900 + 80 * (i % 2), seed=20 + i)
            graphs.append(g)
            futs.append(eng.submit(g.node_feat, g.senders, g.receivers,
                                   g.edge_feat))
        for i in range(6):
            g = _mesh_graph(n=48, seed=40 + i)
            graphs.append(g)
            futs.append(eng.submit(g.node_feat, g.senders, g.receivers,
                                   g.edge_feat))
        eng.drain(timeout=WAIT_S)
        for g, fut in zip(graphs, futs):
            out = fut.result(timeout=WAIT_S)
            np.testing.assert_allclose(out, _single(cfg, params, g, df),
                                       **PARITY)
        assert len(eng._wide_programs) == 1
        assert eng.edge_passes[("wide", 4, 512, 1024)] == (
            3 if impl == "fused_layer" else 6)
        summary = eng.stats.summary()
        assert summary["devices"]["wide[4]"]["count"] == 5.0
        assert summary["count"] == 11.0
        # a graph with no locality fits no 4-way split
        rng = np.random.default_rng(0)
        with pytest.raises(GraphTooLarge):
            eng.process(rng.normal(size=(900, 8)).astype(np.float32),
                        rng.integers(0, 900, 3600).astype(np.int32),
                        rng.integers(0, 900, 3600).astype(np.int32),
                        rng.normal(size=(3600, 1)).astype(np.float32))
    finally:
        eng.close(timeout=WAIT_S)


def _wide_engine(cfg, params, **kw):
    kw.setdefault("wide_k", 4)
    return GraphStreamEngine(cfg, params, buckets=(32, 64, 128, 256, 512),
                             wide=True, devices=["cpu"] * 4, **kw)


def test_engine_wide_deadline_sheds_while_queued():
    # a wide request whose deadline passes while the only gang is busy is
    # shed with DeadlineExceeded; the running one is served
    cfg = _small_cfg()
    params = _params(cfg)
    eng = _wide_engine(cfg, params)
    real = eng._serve_wide

    def slow(*args):
        time.sleep(0.6)
        return real(*args)
    eng._serve_wide = slow
    try:
        g = _mesh_graph(n=900, seed=1)
        first = eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat)
        t0 = time.perf_counter()
        while eng._wide_running == 0 and time.perf_counter() - t0 < WAIT_S:
            time.sleep(0.005)
        late = eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                          deadline=0.1)
        with pytest.raises(DeadlineExceeded) as exc_info:
            late.result(timeout=WAIT_S)
        assert "gang" in str(exc_info.value)
        out = first.result(timeout=WAIT_S)
        np.testing.assert_allclose(out, _single(cfg, params, g,
                                                DataflowConfig()), **PARITY)
        assert eng.stats.shed_deadline == 1
    finally:
        eng.close(timeout=WAIT_S)


def test_engine_gang_member_death_requeues():
    # a member dies mid-run: the whole request requeues (no retry charged
    # against max_retries) and a gang of survivors serves it
    cfg = _small_cfg()
    params = _params(cfg)
    eng = _wide_engine(cfg, params, wide_k=3, max_retries=0)
    real = eng._serve_wide
    gangs = []

    def dying(plan, gang, pinned, stacked):
        gangs.append([ex.index for ex in gang])
        if len(gangs) == 1:
            gang[1].mark_dead()
            raise RuntimeError("member lost mid-ring")
        return real(plan, gang, pinned, stacked)
    eng._serve_wide = dying
    try:
        g = _mesh_graph(n=700, seed=2)
        out = eng.submit(g.node_feat, g.senders, g.receivers,
                         g.edge_feat).result(timeout=WAIT_S)
        np.testing.assert_allclose(out, _single(cfg, params, g,
                                                DataflowConfig()), **PARITY)
        assert len(gangs) == 2
        assert gangs[0][1] not in gangs[1]
        assert eng.stats.retries == 1 and eng.stats.failed == 0
    finally:
        eng.close(timeout=WAIT_S)


@pytest.mark.parametrize("failures,served", [(1, True), (99, False)])
def test_engine_wide_transient_failure_retries(failures, served):
    # the gang stays healthy and the program fails: it retries up to
    # max_retries, then the future fails with BatchFailed
    cfg = _small_cfg()
    params = _params(cfg)
    eng = _wide_engine(cfg, params, max_retries=1)
    real = eng._serve_wide
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) <= failures:
            raise RuntimeError("planted transient failure")
        return real(*args)
    eng._serve_wide = flaky
    try:
        g = _mesh_graph(n=900, seed=3)
        fut = eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat)
        if served:
            np.testing.assert_allclose(
                fut.result(timeout=WAIT_S),
                _single(cfg, params, g, DataflowConfig()), **PARITY)
        else:
            with pytest.raises(BatchFailed) as exc_info:
                fut.result(timeout=WAIT_S)
            assert isinstance(exc_info.value.__cause__, RuntimeError)
            assert eng.stats.failed == 1
        assert len(calls) == 2 and eng.stats.retries == 1
    finally:
        eng.close(timeout=WAIT_S)


def test_engine_wide_serves_the_updated_params():
    # update_params reaches the gang: a wide graph after the swap matches
    # the new weights' single-device forward
    cfg = _small_cfg()
    params = _params(cfg)
    new = TM.make_gnn(cfg).init(torch.Generator().manual_seed(1), cfg,
                                device="cpu")
    g = _mesh_graph(n=900, seed=4)
    with _wide_engine(cfg, params) as eng:
        before = eng.submit(g.node_feat, g.senders, g.receivers,
                            g.edge_feat).result(timeout=WAIT_S)
        eng.update_params(new)
        after = eng.submit(g.node_feat, g.senders, g.receivers,
                           g.edge_feat).result(timeout=WAIT_S)
    df = DataflowConfig()
    np.testing.assert_allclose(before, _single(cfg, params, g, df), **PARITY)
    np.testing.assert_allclose(after, _single(cfg, new, g, df), **PARITY)
    assert not np.allclose(before, after)
