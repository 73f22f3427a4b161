"""The port's admission modules against the JAX package's, on the CPU:
``core/errors.py`` (bases, fields, messages) and ``core/validate.py``
(``validate_graph``, ``check_budget``), and the engine's
``require_finite``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import errors as jerrors  # noqa: E402
from repro.core import validate as jvalidate  # noqa: E402
from repro_torch.core import errors as terrors  # noqa: E402
from repro_torch.core import validate as tvalidate  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS  # noqa: E402
from repro_torch.core.models import make_gnn  # noqa: E402
from repro_torch.data.graphs import molhiv_like  # noqa: E402

ERRORS = ("EngineError", "EngineClosed", "InvalidRequest", "InvalidGraph",
          "GraphTooLarge", "UnknownQueue", "ParamUpdateFailed",
          "BatchFailed", "PoisonGraph", "DeadlineExceeded", "ExecutorDead")
# (message, request_ids, executor_index)
ERROR_ARGS = [("queue 'bulk' is not configured", (), None),
              ("batch failed", (3, 4), 1),
              ("deadline", tuple(range(11)), None),
              ("executor died", (), 0)]


@pytest.mark.parametrize("name", ERRORS)
def test_error_class_matches_reference(name):
    """The same bases (by name), the fields kept, ``str()`` equal to the
    reference's on the same arguments, and the builtin it also is."""
    ours, ref = getattr(terrors, name), getattr(jerrors, name)
    assert ([b.__name__ for b in ours.__bases__]
            == [b.__name__ for b in ref.__bases__])
    assert ([c.__name__ for c in ours.__mro__]
            == [c.__name__ for c in ref.__mro__])
    for msg, ids, ex in ERROR_ARGS:
        a = ours(msg, request_ids=ids, executor_index=ex)
        b = ref(msg, request_ids=ids, executor_index=ex)
        assert a.request_ids == b.request_ids == tuple(ids)
        assert a.executor_index == b.executor_index == ex
        assert str(a) == str(b)
        assert isinstance(a, RuntimeError)
    with pytest.raises(ours):
        raise ours("x")


def test_unknown_queue_is_a_key_error_without_quotes():
    err = terrors.UnknownQueue("no queue named 'x'", request_ids=(7,))
    assert isinstance(err, KeyError)
    assert str(err) == "no queue named 'x' (requests=[7])"


def _variants():
    """The inputs of the reference's
    ``test_defense.py::test_invalid_graph_variants_rejected_typed``, the
    graph they spoil, and non-finite payloads."""
    g = next(molhiv_like(seed=0, n_graphs=1))
    oor = np.array(g.senders, copy=True)
    oor[0] = g.node_feat.shape[0] + 3
    neg = np.array(g.receivers, copy=True)
    neg[1] = -1
    nan_x = np.array(g.node_feat, copy=True)
    nan_x[0, 0] = np.nan
    inf_e = np.array(g.edge_feat, copy=True)
    inf_e[2, 1] = np.inf
    base = dict(node_feat=g.node_feat, senders=g.senders,
                receivers=g.receivers, edge_feat=g.edge_feat,
                node_pos=g.node_pos)
    return {
        "good": base,
        "good_no_edges": dict(base, senders=g.senders[:0],
                              receivers=g.receivers[:0],
                              edge_feat=g.edge_feat[:0]),
        "out_of_range_sender": dict(base, senders=oor),
        "negative_receiver": dict(base, receivers=neg),
        "float_indices": dict(base, senders=g.senders.astype(np.float32)),
        "node_width": dict(base, node_feat=g.node_feat[:, :-1]),
        "edge_rows": dict(base, edge_feat=g.edge_feat[:-1]),
        "edge_count": dict(base, senders=g.senders[:-1]),
        "zero_nodes": dict(base, node_feat=g.node_feat[:0]),
        "node_1d": dict(base, node_feat=g.node_feat[:, 0]),
        "pos_rows": dict(base, node_pos=g.node_pos[:-1]),
        "nan_node_feat": dict(base, node_feat=nan_x),
        "inf_edge_feat": dict(base, edge_feat=inf_e),
    }


VARIANTS = _variants()


@pytest.mark.parametrize("require_finite", [False, True])
@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_validate_graph_rejects_what_the_reference_rejects(case,
                                                          require_finite):
    """``validate_graph`` raises the port's ``InvalidGraph`` with the
    reference's reason on exactly the inputs where the reference's
    raises."""
    kw = dict(VARIANTS[case], node_feat_dim=9, edge_feat_dim=3, pos_dim=1,
              require_finite=require_finite)
    try:
        jvalidate.validate_graph(**kw)
        ref = None
    except jerrors.InvalidGraph as exc:
        ref = str(exc)
    if ref is None:
        assert tvalidate.validate_graph(**kw) is None
    else:
        with pytest.raises(terrors.InvalidGraph) as ei:
            tvalidate.validate_graph(**kw)
        assert str(ei.value) == ref
    assert (case.startswith("good") or (case.startswith(("nan", "inf"))
                                        and not require_finite)) == (
        ref is None)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("n,e,nb,eb", [
    (100, 50, 64, None),          # over the node budget
    (30, 5000, 64, 4096),         # over the edge budget
    (100, 5000, 64, 4096),        # over both: the node reason first
    (64, 4096, 64, 4096),         # at both budgets
    (10, 10, None, None),         # no budget
    (10, 10 ** 6, 64, None),      # no edge budget
])
def test_check_budget_matches_reference(n, e, nb, eb, wide):
    kw = dict(node_budget=nb, edge_budget=eb, wide_enabled=wide)
    assert (tvalidate.check_budget(n, e, **kw)
            == jvalidate.check_budget(n, e, **kw))


def _engine(**kw):
    cfg = PAPER_GNN_CONFIGS["gin"]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    return GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                             device="cpu", **kw)


def test_require_finite_knob():
    """As the reference's ``test_defense.py::test_require_finite_knob``:
    with ``require_finite`` a NaN feature is refused at ``submit``, typed
    and with its request id; by default it reaches the model."""
    g = next(molhiv_like(seed=0, n_graphs=1))
    nan_feat = np.array(g.node_feat, copy=True)
    nan_feat[0, 0] = np.nan
    with _engine(require_finite=True) as eng:
        with pytest.raises(terrors.InvalidGraph,
                           match="non-finite") as ei:
            eng.submit(nan_feat, g.senders, g.receivers, g.edge_feat)
        assert ei.value.request_ids == (0,)
        out = eng.process(g.node_feat, g.senders, g.receivers, g.edge_feat)
        assert np.isfinite(out).all()
    with _engine() as eng:
        fut = eng.submit(nan_feat, g.senders, g.receivers, g.edge_feat)
        eng.drain(timeout=60)
        assert fut.done()


def test_engine_budget_reason_is_the_references():
    """A graph over the largest bucket: ``GraphTooLarge`` with the
    reference's words (wide placement disabled)."""
    eng = _engine(buckets=(32, 64))
    n = 65
    x = np.zeros((n, 9), np.float32)
    snd = np.arange(n - 1, dtype=np.int32)
    with pytest.raises(terrors.GraphTooLarge) as ei:
        eng.process(x, snd, snd + 1, np.zeros((n - 1, 3), np.float32))
    want = jvalidate.check_budget(n, n - 1, node_budget=64,
                                  wide_enabled=False)
    assert str(ei.value) == f"{want} (requests=[0])"
