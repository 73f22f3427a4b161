"""The port's packer and packed batches, against ``tests/test_packing.py``.

The packer-policy tests run as the reference's do. The numerical contract
is held through the port's ``model.apply`` on the CPU for all six models: a
graph served alone is BITWISE the same graph packed with others in the
same bucket (also with a degree-0 co-graph and with a co-packed graph's
edges permuted), as the reference holds it. One parity test moves the JAX
weights across (``params_from_numpy``) and holds the port's forward on a
packed batch to the JAX forward (``scan_layers=False``) at atol = rtol =
1e-5, what the reference holds between its own eager and compiled
forwards.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.message_passing import DataflowConfig as JDF  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core.graph import (BATCH_FIELDS,  # noqa: E402
                                    BatchStaging, build_graph_batch,
                                    concat_raw_graphs)
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.core.packing import (GraphPacker, PackedBatch,  # noqa: E402
                                      PackItem)
from repro_torch.data.graphs import RawGraph, molhiv_like  # noqa: E402

MODELS = sorted(PAPER_GNN_CONFIGS)


def small_cfg(name, cfgs=PAPER_GNN_CONFIGS):
    cfg = cfgs[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _init(cfg, seed):
    return make_gnn(cfg).init(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")


def _item(n=8, e=16, seed=0, node_dim=4):
    r = np.random.default_rng(seed)
    return PackItem(
        node_feat=r.normal(size=(n, node_dim)).astype(np.float32),
        senders=r.integers(0, n, size=e).astype(np.int32),
        receivers=r.integers(0, n, size=e).astype(np.int32))


def _degree0_graph(seed=5) -> RawGraph:
    """4 nodes, last one fully isolated (no in- or out-edges)."""
    r = np.random.default_rng(seed)
    return RawGraph(
        node_feat=r.normal(size=(4, 9)).astype(np.float32),
        senders=np.array([0, 1, 2], np.int32),
        receivers=np.array([1, 2, 0], np.int32),
        edge_feat=r.normal(size=(3, 3)).astype(np.float32),
        node_pos=r.normal(size=(4, 1)).astype(np.float32),
        label=0.0)


# ---------------------------------------------------------------------------
# packer policy
# ---------------------------------------------------------------------------

def test_first_fit_flushes_on_max_batch():
    p = GraphPacker(max_batch=3, max_wait_s=10.0)
    assert p.add(_item(seed=1)) == []
    assert p.add(_item(seed=2)) == []
    flushed = p.add(_item(seed=3))
    assert len(flushed) == 1
    pb = flushed[0]
    assert pb.num_graphs == 3 and pb.graph_pad == 3
    assert pb.node_pad >= 24 and pb.edge_pad >= 48
    assert p.open_batches == 0


def test_deadline_poll_and_flush_all():
    p = GraphPacker(max_batch=8, max_wait_s=10.0)
    p.add(_item(seed=1), now=100.0)
    p.add(_item(seed=2), now=105.0)       # fits the same open batch
    assert p.poll(now=105.0) == []        # deadline is 110 (first arrival)
    expired = p.poll(now=110.5)
    assert len(expired) == 1 and expired[0].num_graphs == 2
    p.add(_item(seed=3), now=120.0)
    rest = p.flush_all()
    assert len(rest) == 1 and p.pending_graphs == 0


def test_budgets_open_second_batch_and_oversize_gets_own():
    p = GraphPacker(max_batch=8, max_wait_s=10.0, max_nodes=20, max_edges=100)
    p.add(_item(n=12, seed=1))
    p.add(_item(n=12, seed=2))            # 24 > 20 nodes: second open batch
    assert p.open_batches == 2
    # a graph larger than the whole budget still gets (its own) batch
    p.add(_item(n=50, e=10, seed=3))
    assert p.open_batches == 3
    shapes = {pb.num_graphs for pb in p.flush_all()}
    assert shapes == {1}


def test_default_budgets_scale_with_max_batch():
    p = GraphPacker(max_batch=5)
    assert (p.max_nodes, p.max_edges) == (320, 1280)


def test_packed_batch_build_offsets():
    p = GraphPacker(max_batch=2, max_wait_s=10.0)
    a, b = _item(n=5, e=7, seed=1), _item(n=9, e=4, seed=2)
    (pb,) = p.add(a) + p.add(b)
    assert pb.node_span_of(0) == (0, 5) and pb.node_span_of(1) == (5, 14)
    g = pb.build(device="cpu")
    assert g.n_graph_pad == 2
    gids = g.graph_ids.numpy()[g.node_mask.numpy()]
    assert (gids[:5] == 0).all() and (gids[5:] == 1).all()
    # edge indices shifted into each graph's node range
    snd = g.senders.numpy()[g.edge_mask.numpy()]
    assert (snd[:7] < 5).all() and (snd[7:] >= 5).all()


def test_concat_raw_graphs_zero_fills_mixed_optionals():
    """A graph without edge_feat/node_pos must not poison a pack that has
    them: the gap is zero-filled, while width mismatches still fail."""
    a = _item(seed=1)
    b = _item(seed=2)
    b.edge_feat = np.ones((b.num_edges, 3), np.float32)
    raw = concat_raw_graphs([a, b])
    assert raw["edge_feat"].shape == (a.num_edges + b.num_edges, 3)
    assert (raw["edge_feat"][:a.num_edges] == 0).all()
    assert (raw["edge_feat"][a.num_edges:] == 1).all()
    assert raw["node_pos"] is None
    a.edge_feat = np.ones((a.num_edges, 5), np.float32)   # width mismatch
    with pytest.raises(ValueError):
        concat_raw_graphs([a, b])


def test_subset_rebucket_split_keep_or_tighten_the_bucket():
    items = [_item(n=8, e=16, seed=i) for i in range(4)]
    pb = PackedBatch(items=items, node_pad=128, edge_pad=256, graph_pad=4,
                     attempts=1)
    sub = pb.subset(items[1:3])
    assert sub.bucket == pb.bucket and sub.attempts == 1
    assert sub.num_graphs == 2
    tight = pb.rebucket((16, 32, 64, 128, 256))
    assert tight.bucket == (32, 64, 4) and tight.attempts == 1
    left, right = pb.split()
    assert [left.num_graphs, right.num_graphs] == [2, 2]
    assert left.bucket == right.bucket == pb.bucket
    with pytest.raises(ValueError):
        sub.subset(items[:1]).split()


def test_readmit_pins_the_sealed_bucket_and_takes_no_new_items():
    p = GraphPacker(max_batch=4, max_wait_s=10.0)
    (pb,) = sum((p.add(_item(seed=i), now=0.0) for i in range(4)), [])
    p.readmit(pb.subset(pb.items[1:]), now=5.0)
    p.add(_item(seed=9), now=5.0)          # opens a batch of its own
    assert p.open_batches == 2
    first = p.poll(now=5.0)
    assert len(first) == 1 and first[0].bucket == pb.bucket
    assert first[0].num_graphs == 3


def test_shed_drops_matching_items_and_empty_batches():
    p = GraphPacker(max_batch=8, max_wait_s=10.0, max_nodes=10)
    a, b, c = _item(seed=1), _item(seed=2), _item(seed=3)
    a.payload, b.payload, c.payload = "x", "keep", "x"
    for it in (a, b, c):
        p.add(it, now=0.0)
    assert p.open_batches == 3
    shed = p.shed(lambda it: it.payload == "x")
    assert {id(it) for it in shed} == {id(a), id(c)}
    assert p.open_batches == 1 and p.pending_graphs == 1
    assert p.flush_oldest().items == [b]
    assert p.flush_oldest() is None


@pytest.mark.parametrize("slot", [0, 2])
def test_stage_matches_build(slot):
    """``PackedBatch.stage`` into a staging slot, uploaded, is bitwise
    ``PackedBatch.build``: the packed graphs at their offsets, padding
    rows written, also over a larger batch staged there before."""
    graphs = list(molhiv_like(seed=3, n_graphs=4))
    small = PackedBatch(items=[PackItem(g.node_feat, g.senders, g.receivers,
                                        g.edge_feat, g.node_pos)
                               for g in graphs[:2]],
                        node_pad=128, edge_pad=256, graph_pad=4)
    large = PackedBatch(items=[PackItem(g.node_feat, g.senders, g.receivers,
                                        g.edge_feat, g.node_pos)
                               for g in graphs],
                        node_pad=128, edge_pad=256, graph_pad=4)
    st = BatchStaging(128, 256, 4, (9, 3, 1), "cpu", slots=3)
    for pb in (large, small):
        pb.stage(st, slot)
        st.upload(slot)
    want = small.build(device="cpu")
    for name in BATCH_FIELDS:
        assert torch.equal(getattr(st.batch, name), getattr(want, name)), name


# ---------------------------------------------------------------------------
# numerical invariance through the port's forward: alone == packed
# ---------------------------------------------------------------------------

def _packed_and_alone(target: RawGraph, co, node_pad=128, edge_pad=256,
                      graph_pad=4, build=build_graph_batch, **kw):
    raw = concat_raw_graphs([target] + list(co))
    packed = build(
        raw["node_feat"], raw["senders"], raw["receivers"],
        edge_feat=raw["edge_feat"], node_pad=node_pad, edge_pad=edge_pad,
        graph_offsets=raw["graph_offsets"], graph_pad=graph_pad,
        node_pos=raw["node_pos"], **kw)
    alone = build(
        target.node_feat, target.senders, target.receivers,
        edge_feat=target.edge_feat, node_pad=node_pad, edge_pad=edge_pad,
        graph_pad=graph_pad, node_pos=target.node_pos, **kw)
    return packed, alone


def _apply(cfg, params, g):
    with torch.inference_mode():
        return make_gnn(cfg).apply(params, g, cfg).numpy()


@pytest.mark.parametrize("name", MODELS)
def test_packed_prediction_bitwise_equals_alone(name):
    """Same bucket, same slot: packing co-graphs (including one with a
    degree-0 node) must not change graph 0's prediction AT ALL."""
    cfg = small_cfg(name)
    params = _init(cfg, 0)
    graphs = list(molhiv_like(seed=0, n_graphs=3))
    packed, alone = _packed_and_alone(graphs[0],
                                      [graphs[1], _degree0_graph()],
                                      device="cpu")
    out_packed = _apply(cfg, params, packed)
    out_alone = _apply(cfg, params, alone)
    np.testing.assert_array_equal(out_packed[0], out_alone[0])
    assert np.isfinite(out_packed[0]).all()


@pytest.mark.parametrize("name", MODELS)
def test_packed_prediction_invariant_to_copack_edge_order(name):
    """Permuting a CO-PACKED graph's edges leaves the target's prediction
    bitwise unchanged (its own sums are untouched); permuting the target's
    own edges changes only summation order (allclose)."""
    cfg = small_cfg(name)
    params = _init(cfg, 1)
    tgt, co = list(molhiv_like(seed=7, n_graphs=2))

    r = np.random.default_rng(0)
    perm_co = r.permutation(co.senders.shape[0])
    co_perm = dataclasses.replace(
        co, senders=co.senders[perm_co], receivers=co.receivers[perm_co],
        edge_feat=co.edge_feat[perm_co])
    packed, _ = _packed_and_alone(tgt, [co], device="cpu")
    packed_p, alone = _packed_and_alone(tgt, [co_perm], device="cpu")
    base = _apply(cfg, params, packed)
    np.testing.assert_array_equal(base[0], _apply(cfg, params, packed_p)[0])

    perm_t = r.permutation(tgt.senders.shape[0])
    tgt_perm = dataclasses.replace(
        tgt, senders=tgt.senders[perm_t], receivers=tgt.receivers[perm_t],
        edge_feat=tgt.edge_feat[perm_t])
    packed_tp, _ = _packed_and_alone(tgt_perm, [co], device="cpu")
    np.testing.assert_allclose(base[0], _apply(cfg, params, packed_tp)[0],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(base[0], _apply(cfg, params, alone)[0],
                               atol=1e-4, rtol=1e-4)


def test_degree0_graph_alone_is_finite_everywhere():
    """Degree-0 nodes exercise every neutral-element path (mean/std/max/min,
    softmax denominators, DGN normalizers)."""
    g = _degree0_graph()
    for name in MODELS:
        cfg = small_cfg(name)
        gb = build_graph_batch(g.node_feat, g.senders, g.receivers,
                               edge_feat=g.edge_feat, node_pad=32,
                               edge_pad=32, node_pos=g.node_pos,
                               device="cpu")
        assert np.isfinite(_apply(cfg, _init(cfg, 2), gb)).all(), name


@pytest.mark.parametrize("name", MODELS)
def test_packed_batch_matches_the_reference_forward(name):
    """Three ``molhiv_like(seed=0)`` graphs and the degree-0 graph packed
    in one bucket (128 nodes, 256 edges, 4 graphs): the port's forward on
    the JAX weights against the JAX forward (unrolled), every graph's row,
    to atol = rtol = 1e-5."""
    jcfg, tcfg = small_cfg(name, JCFG), small_cfg(name)
    jp = jmake(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    graphs = list(molhiv_like(seed=0, n_graphs=3)) + [_degree0_graph()]
    raw = concat_raw_graphs(graphs)
    kw = dict(edge_feat=raw["edge_feat"], node_pos=raw["node_pos"],
              graph_offsets=raw["graph_offsets"], node_pad=128,
              edge_pad=256, graph_pad=4)
    args = (raw["node_feat"], raw["senders"], raw["receivers"])
    ref = np.asarray(jmake(jcfg).apply(jp, jbuild(*args, **kw), jcfg,
                                       JDF(scan_layers=False)))
    ours = _apply(tcfg, tp, build_graph_batch(*args, device="cpu", **kw))
    assert ours.shape == ref.shape == (4, jcfg.out_dim)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
