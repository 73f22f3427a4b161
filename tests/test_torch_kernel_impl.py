"""The port's ``impl='kernel'`` path against the JAX package's, on the CPU.

Under ``impl='kernel'`` every aggregation is one launch of ``mp_scatter``
(sums), ``mp_scatter_multi`` (every other kind, and multi-kind sweeps) or
``seg_softmax`` (GAT's attention); on the CPU each runs its plain version.
Both sides get the same numpy-seeded messages, the same graphs (the JAX
generators through each side's ``build_graph_batch``) and the same weights
(the JAX ``init``, moved across through ``params_from_numpy``).
Tolerances: 1e-5 at the aggregation level, what the reference holds
between its kernel and jnp arms (``test_kernel_impl_every_kind``); at the
model level 1e-4 against the reference's interpret-mode kernel forward,
what it holds between that and its fused forward
(``test_kernel_impl_matches_fused``), and 1e-5 against its unrolled
``impl='fused'`` forward. Passes over the edges, and calls of each kernel,
must be equal on both sides.
"""

from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import message_passing as jmp  # noqa: E402
from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.graph import build_graph_batch as jbuild  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro.data.graphs import molhiv_like  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core import message_passing as tmpass  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.message_passing import (AGG_KINDS,  # noqa: E402
                                              DataflowConfig,
                                              count_edge_passes)
from repro_torch.core.models import PAPER_GNN_CONFIGS as TCFG  # noqa: E402
from repro_torch.core.models import make_gnn as tmake  # noqa: E402
from repro_torch.kernels import mp_scatter as tms  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import seg_softmax as tss  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
SCATTER_KERNELS = ("mp_scatter", "mp_scatter_multi", "seg_softmax")
# the reference's kernel test dataflow
KERNEL_DF = dict(impl="kernel", num_banks=4, edge_tile=32)


def _paper_graph():
    """One molhiv_like(seed=0) graph at the 32/64 bucket."""
    g = next(molhiv_like(seed=0, n_graphs=1))
    kw = dict(edge_feat=g.edge_feat, node_pos=g.node_pos, node_pad=32,
              edge_pad=64)
    args = (g.node_feat, g.senders, g.receivers)
    return jbuild(*args, **kw), tbuild(*args, device="cpu", **kw)


def _small(cfgs, name):
    """The reference's kernel-test width: hidden 16, three layers."""
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


@contextmanager
def _count_calls(module, names):
    """Count the calls of each named kernel wrapper of ``module`` (the port's
    or the JAX package's ``ops``) made inside the block."""
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(module, n) for n in names}

    def counted(name):
        def fn(*args, **kw):
            calls[name] += 1
            return real[name](*args, **kw)
        return fn

    for n in names:
        setattr(module, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(module, n, fn)


# ---------------------------------------------------------------------------
# the aggregation unit
# ---------------------------------------------------------------------------

def _messages(e=128, d=8, n=32, seed=0):
    """Numpy messages and a COO stream: the last 3 destinations receive no
    edge and about a fifth of the edges are masked."""
    r = np.random.default_rng(seed)
    return (r.normal(size=(e, d)).astype(np.float32),
            r.integers(0, n - 3, size=e).astype(np.int64),
            r.random(e) < 0.8)


def _both(msg, rcv, mask):
    return ((torch.from_numpy(msg), torch.from_numpy(rcv),
             torch.from_numpy(mask)),
            (jnp.asarray(msg), jnp.asarray(rcv, jnp.int32),
             jnp.asarray(mask)))


def _degrees(rcv, mask, n):
    deg = np.bincount(rcv[mask], minlength=n).astype(np.float32)
    return torch.from_numpy(deg), jnp.asarray(deg)


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kind", AGG_KINDS)
def test_segment_aggregate_every_kind(kind, with_degrees):
    msg, rcv, mask = _messages(seed=len(kind))
    (tm, tr, tk), (jm, jr, jk) = _both(msg, rcv, mask)
    dt, dj = _degrees(rcv, mask, 32) if with_degrees else (None, None)
    with count_edge_passes() as ps, _count_calls(tops, SCATTER_KERNELS) as tc:
        ours = tmpass.segment_aggregate(tm, tr, 32, kind=kind, edge_mask=tk,
                                        dataflow=DataflowConfig(**KERNEL_DF),
                                        degrees=dt)
    with jmp.count_edge_passes() as pj, \
            _count_calls(jops, SCATTER_KERNELS) as jc:
        ref = jmp.segment_aggregate(jm, jr, 32, kind=kind, edge_mask=jk,
                                    dataflow=jmp.DataflowConfig(**KERNEL_DF),
                                    degrees=dj)
    assert ps.passes == pj.passes == 1
    assert tc == jc
    assert tc["mp_scatter" if kind == "sum" else "mp_scatter_multi"] == 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if kind != "std":                  # std of an empty row is sqrt(1e-5)
        assert (ours.numpy()[29:] == 0.0).all()


@pytest.mark.parametrize("with_degrees", [False, True])
@pytest.mark.parametrize("kinds", [
    ("mean", "std", "max", "min"),
    ("sum", "mean"),
    ("sum", "var", "max"),
    ("min", "std"),
    AGG_KINDS,
])
def test_segment_multi_aggregate_is_one_launch(kinds, with_degrees):
    msg, rcv, mask = _messages(seed=len(kinds) + 10 * with_degrees)
    (tm, tr, tk), (jm, jr, jk) = _both(msg, rcv, mask)
    dt, dj = _degrees(rcv, mask, 32) if with_degrees else (None, None)
    with count_edge_passes() as ps, _count_calls(tops, SCATTER_KERNELS) as tc:
        ours = tmpass.segment_multi_aggregate(
            tm, tr, 32, kinds=kinds, edge_mask=tk,
            dataflow=DataflowConfig(**KERNEL_DF), degrees=dt)
    with jmp.count_edge_passes() as pj, \
            _count_calls(jops, SCATTER_KERNELS) as jc:
        ref = jmp.segment_multi_aggregate(
            jm, jr, 32, kinds=kinds, edge_mask=jk,
            dataflow=jmp.DataflowConfig(**KERNEL_DF), degrees=dj)
    assert ps.passes == pj.passes == 1
    assert tc == jc == {"mp_scatter": 0, "mp_scatter_multi": 1,
                        "seg_softmax": 0}
    assert tuple(ours) == kinds
    for k in kinds:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)


def test_multi_aggregate_asks_for_count_only_without_degrees():
    """The count accumulator is requested only when moments are wanted and
    no degrees are shared, as in the reference."""
    msg, rcv, mask = _messages(seed=5)
    (tm, tr, tk), _ = _both(msg, rcv, mask)
    dt, _ = _degrees(rcv, mask, 32)
    seen = []
    real = tops.mp_scatter_multi

    def record(*args, **kw):
        seen.append({k for k, v in kw.items() if k.startswith("want_") and v})
        return real(*args, **kw)

    tops.mp_scatter_multi = record
    try:
        df = DataflowConfig(**KERNEL_DF)
        for degrees in (None, dt):
            tmpass.segment_multi_aggregate(tm, tr, 32, kinds=("mean", "max"),
                                           edge_mask=tk, dataflow=df,
                                           degrees=degrees)
        tmpass.segment_multi_aggregate(tm, tr, 32, kinds=("max",),
                                       edge_mask=tk, dataflow=df)
    finally:
        tops.mp_scatter_multi = real
    assert seen == [{"want_sum", "want_count", "want_max"},
                    {"want_sum", "want_max"}, {"want_max"}]


@pytest.mark.parametrize("shape", [(96,), (96, 4)])
def test_segment_softmax_is_two_passes(shape):
    r = np.random.default_rng(4)
    n = 20
    logits = (r.normal(size=shape) * 3).astype(np.float32)
    rcv = r.integers(0, n - 2, size=shape[0]).astype(np.int64)
    mask = r.random(shape[0]) < 0.85
    with count_edge_passes() as ps, _count_calls(tops, SCATTER_KERNELS) as tc:
        ours = tmpass.segment_softmax(
            torch.from_numpy(logits), torch.from_numpy(rcv), n,
            edge_mask=torch.from_numpy(mask),
            dataflow=DataflowConfig(**KERNEL_DF))
    with jmp.count_edge_passes() as pj:
        ref = jmp.segment_softmax(
            jnp.asarray(logits), jnp.asarray(rcv, jnp.int32), n,
            edge_mask=jnp.asarray(mask),
            dataflow=jmp.DataflowConfig(**KERNEL_DF))
    assert ps.passes == pj.passes == 2
    assert tc["seg_softmax"] == 1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    assert (ours.numpy()[~mask] == 0.0).all()


# ---------------------------------------------------------------------------
# the six models: passes and calls at the paper configs, the engine (their
# forwards against the reference are in test_torch_kernel_models.py)
# ---------------------------------------------------------------------------

# passes over the edges / calls of each kernel per forward at the paper
# configs, one molhiv graph at the 32/64 bucket
PAPER_COUNTS = {
    ("gin", True): (10, {"mp_scatter": 5}),
    ("gcn", True): (11, {"mp_scatter": 5}),
    ("gin_vn", True): (10, {"mp_scatter": 5}),
    ("gat", True): (20, {"mp_scatter": 5, "seg_softmax": 5}),
    ("pna", True): (9, {"mp_scatter_multi": 4}),
    ("dgn", True): (11, {"mp_scatter_multi": 4}),
    ("pna", False): (21, {"mp_scatter_multi": 16}),
    ("dgn", False): (15, {"mp_scatter": 4, "mp_scatter_multi": 4}),
}


@pytest.mark.parametrize("name,single_pass", list(PAPER_COUNTS),
                         ids=[f"{n}-{'single' if s else 'per_kind'}"
                              for n, s in PAPER_COUNTS])
def test_paper_config_passes_and_calls_equal_reference(name, single_pass):
    jcfg, tcfg = JCFG[name], TCFG[name]
    jp, tp = _jax_params(jcfg)
    jg, tg = _paper_graph()
    df = dict(impl="kernel", single_pass=single_pass)
    with count_edge_passes() as ps, _count_calls(tops, SCATTER_KERNELS) as tc:
        _port_apply(tcfg, tp, tg, **df)
    with jmp.count_edge_passes() as pj, \
            _count_calls(jops, SCATTER_KERNELS) as jc:
        jax.eval_shape(lambda p, g: jmake(jcfg).apply(
            p, g, jcfg, jmp.DataflowConfig(scan_layers=False, **df)), jp, jg)
    passes, calls = PAPER_COUNTS[(name, single_pass)]
    assert ps.passes == pj.passes == passes
    assert tc == jc == {k: calls.get(k, 0) for k in SCATTER_KERNELS}


@pytest.mark.parametrize("name", ["gat", "pna"])
def test_engine_serves_two_buckets(name):
    """GraphStreamEngine(device='cpu') under impl='kernel' answers like the
    reference engine under fused, with the same passes in every bucket,
    and launches nothing on the CPU."""
    jcfg, tcfg = _small(JCFG, name), _small(TCFG, name)
    jp, tp = _jax_params(jcfg)
    graphs = list(molhiv_like(seed=0, n_graphs=8))[4:]

    def args(g):
        return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos

    with JEngine(jcfg, jp, jmp.DataflowConfig(impl="fused",
                                              scan_layers=False)) as je:
        ref = [je.process(*args(g)) for g in graphs]
    launches = (tms.mp_scatter, tms.mp_scatter_multi, tss.seg_softmax)
    before = [k.launches for k in launches]
    with GraphStreamEngine(tcfg, tp, DataflowConfig(impl="kernel"),
                           device="cpu") as te:
        ours = [te.process(*args(g)) for g in graphs]
        passes = dict(te.edge_passes)
    assert [k.launches for k in launches] == before
    for a, b in zip(ours, ref):
        assert a.shape == (jcfg.out_dim,)
        np.testing.assert_allclose(a, b, **TOL)
    assert len({key[:2] for key in passes}) >= 2
    layers = tcfg.num_layers
    want = {"gat": 4 * layers, "pna": 2 * layers + 1}[name]
    assert set(passes.values()) == {want}
