"""The engine's program per bucket: the staging layout, the program cache
and, on the card, the captured CUDA graphs against the eager forward.

On the CPU the engine runs the eager forward on a batch built afresh
(``EagerProgram``); ``BatchStaging`` is held bitwise to ``build_graph_batch``
in unpinned memory, also after a larger graph in the same buffer. The tests
marked ``cuda`` run on an NVIDIA GPU (``python -m pytest -m cuda``): each
bucket's forward captured once and replayed (``CapturedProgram``), bitwise
against the eager forward composed from ``build_graph_batch`` and
``model.apply``, both under torch's deterministic algorithms.
That machine has no JAX: the reference is imported inside the tests that
need it.
"""

import re
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.engine import (EagerProgram,  # noqa: E402
                                     GraphStreamEngine)
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS  # noqa: E402
from repro_torch.core.models import make_gnn  # noqa: E402
from repro_torch.data.graphs import hep_like, molhiv_like  # noqa: E402
from repro_torch.kernels.ops import launch_counters  # noqa: E402

MODELS = ("gin", "gcn", "gin_vn", "gat", "pna", "dgn")
IMPLS = ("fused_layer", "pipeline", "kernel")


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


def _raw(g, **kw):
    return dict(edge_feat=g.edge_feat, node_pos=g.node_pos, **kw)


def _widths(g):
    return (g.node_feat.shape[1], g.edge_feat.shape[1], g.node_pos.shape[1])


def _molecule(seed=0):
    return next(molhiv_like(seed=seed, n_graphs=1))


def _knn(seed=2):
    return next(hep_like(seed=seed, n_graphs=1))


def _assert_same_batch(a, b):
    for name in tgraph.BATCH_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


def _pads(g):
    return (tgraph.pad_bucket(g.node_feat.shape[0]),
            tgraph.pad_bucket(g.senders.shape[0]))


# ---------------------------------------------------------------------------
# the staging layout (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_molecule, _knn], ids=["molhiv", "hep"])
def test_staging_matches_build_graph_batch(make):
    """One graph staged and copied: bitwise build_graph_batch's batch, each
    array at an offset aligned to 256 bytes of one buffer."""
    g = make()
    node_pad, edge_pad = _pads(g)
    want = tgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                    node_pad=node_pad, edge_pad=edge_pad,
                                    device="cpu", **_raw(g))
    st = tgraph.BatchStaging(node_pad, edge_pad, 1, _widths(g), "cpu")
    st.stage(g.node_feat, g.senders, g.receivers, **_raw(g))
    st.upload()
    _assert_same_batch(st.batch, want)
    base = st.device_buf.data_ptr()
    for name in tgraph.BATCH_FIELDS:
        t = getattr(st.batch, name)
        assert (t.data_ptr() - base) % tgraph.STAGING_ALIGN == 0, name
        assert t.data_ptr() + t.numel() * t.element_size() <= (
            base + st.nbytes)


@pytest.mark.parametrize("packed", [False, True], ids=["one", "packed"])
def test_staging_small_graph_after_large_one(packed):
    """A small graph (or three packed) staged over a larger pair of packed
    graphs in the same buffer gives its own batch bitwise: every padding
    row is rewritten."""
    node_pad, edge_pad, graph_pad = 256, 2048, 4
    big = tgraph.concat_raw_graphs([_knn(2), _knn(3)])
    small = tgraph.concat_raw_graphs(
        list(molhiv_like(seed=5, n_graphs=3 if packed else 1)))
    st = tgraph.BatchStaging(node_pad, edge_pad, graph_pad,
                             (9, 3, big["node_pos"].shape[1]), "cpu")
    for raw in (big, small):
        args = (raw["node_feat"], raw["senders"], raw["receivers"])
        kw = {k: raw[k] for k in ("edge_feat", "node_pos", "graph_offsets")}
        st.stage(*args, **kw)
        st.upload()
    assert len(small["senders"]) < len(big["senders"]) // 4
    assert len(small["node_feat"]) < len(big["node_feat"])
    want = tgraph.build_graph_batch(*args, node_pad=node_pad,
                                    edge_pad=edge_pad, graph_pad=graph_pad,
                                    device="cpu", **kw)
    _assert_same_batch(st.batch, want)


def test_staging_refuses_what_build_graph_batch_refuses():
    g = _knn()
    st = tgraph.BatchStaging(32, 64, 1, _widths(g), "cpu")
    with pytest.raises(ValueError, match="exceeds padding"):
        st.stage(g.node_feat, g.senders, g.receivers, **_raw(g))
    m = _molecule()
    st = tgraph.BatchStaging(64, 128, 1, _widths(m), "cpu")
    with pytest.raises(ValueError, match="graph_pad"):
        st.stage(m.node_feat, m.senders, m.receivers,
                 graph_offsets=np.array([0, 5, m.node_feat.shape[0]]),
                 **_raw(m))


# ---------------------------------------------------------------------------
# the program cache (CPU: the eager program)
# ---------------------------------------------------------------------------

def _engine(name="gin", impl="fused_layer", device="cpu", **kw):
    cfg = PAPER_GNN_CONFIGS[name]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device=device)
    return GraphStreamEngine(cfg, params, DataflowConfig(impl=impl),
                             device=device, **kw)


def test_bucket_builds_its_program_once(monkeypatch):
    """Two buckets, several graphs each: two programs, each built on its
    bucket's first graph, and each bucket's passes recorded once."""
    eng = _engine()
    made = []
    real = eng._make_run
    monkeypatch.setattr(eng, "_make_run",
                        lambda df: made.append(df) or real(df))
    graphs = list(molhiv_like(seed=0, n_graphs=5)) + [_knn(), _knn(3)]
    keys = set()
    for g in graphs:
        eng.process(*_args(g))
        keys.add((tgraph.pad_bucket(g.node_feat.shape[0], eng.buckets),
                  tgraph.pad_bucket(g.senders.shape[0], eng.buckets), 1))
        if len(eng.compiled) == 1:
            first = next(iter(eng.compiled.values()))
    assert len(made) == len(eng.compiled) == len(keys)
    assert all(isinstance(p, EagerProgram) for p in eng.compiled.values())
    assert first in eng.compiled.values()         # not rebuilt
    assert set(eng.edge_passes) == keys
    assert set(eng.edge_passes.values()) == {5}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_make_run_is_the_model_forward(name, impl):
    """``_make_run(df)`` on a CPU batch: bitwise ``model.apply``."""
    eng = _engine(name, impl)
    g = _molecule(1)
    batch = tgraph.build_graph_batch(g.node_feat, g.senders, g.receivers,
                                     node_pad=32, edge_pad=64, device="cpu",
                                     **_raw(g))
    got = eng._make_run(eng.dataflow)(eng.params, batch)
    want = eng.model.apply(eng.params, batch, eng.cfg, eng.dataflow)
    assert torch.equal(got, want)


def test_make_run_matches_the_reference_make_run():
    """The port's ``_make_run`` against the JAX engine's (unrolled, its
    weights moved across) on the same padded graph, to 1e-5."""
    jax = pytest.importorskip("jax")
    from repro.core.engine import GraphStreamEngine as JEngine
    from repro.core.graph import build_graph_batch as jbuild
    from repro.core.message_passing import DataflowConfig as JDF
    from repro.core.models import PAPER_GNN_CONFIGS as JCFG
    from repro.core.models import make_gnn as jmake
    from repro_torch.checkpoint.convert import params_from_numpy
    jcfg = JCFG["gin"]
    jp = jmake(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    g = _knn()
    kw = dict(node_pad=64, edge_pad=1024, **_raw(g))
    with JEngine(jcfg, jp, JDF(impl="fused_layer",
                               scan_layers=False)) as je:
        ref = np.asarray(je._make_run(je.dataflow, donate=False)(
            jp, jbuild(g.node_feat, g.senders, g.receivers, **kw)))
    te = GraphStreamEngine(PAPER_GNN_CONFIGS["gin"], tp,
                           DataflowConfig(impl="fused_layer"), device="cpu")
    ours = te._make_run(te.dataflow)(tp, tgraph.build_graph_batch(
        g.node_feat, g.senders, g.receivers, device="cpu", **kw))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card: captured programs against the eager forward
# ---------------------------------------------------------------------------

# launches one forward makes, by wrapper, per (model, impl)
PER_FORWARD = {
    "fused_layer": {"gin": {"layer_fused": 5}, "gcn": {"layer_fused": 5},
                    "gin_vn": {"layer_fused": 5}, "gat": {"mp_pipeline": 5},
                    "pna": {"layer_fused": 4}, "dgn": {"layer_fused": 4}},
    "pipeline": {"gin": {"mp_pipeline": 5}, "gcn": {"mp_pipeline": 5},
                 "gin_vn": {"mp_pipeline": 5}, "gat": {"mp_pipeline": 5},
                 "pna": {"mp_pipeline": 4}, "dgn": {"mp_pipeline": 4}},
    "kernel": {"gin": {"mp_scatter": 5}, "gcn": {"mp_scatter": 5},
               "gin_vn": {"mp_scatter": 5},
               "gat": {"mp_scatter": 5, "seg_softmax": 5},
               "pna": {"mp_scatter_multi": 4},
               "dgn": {"mp_scatter_multi": 4}},
}
# each kernel's symbol in csrc/ and the wrappers that launch it
SYMBOLS = {"layer_fused_kernel": ("layer_fused",),
           "mp_pipeline_kernel": ("mp_pipeline",),
           "mp_scatter_kernel": ("mp_scatter", "mp_scatter_multi"),
           "seg_softmax_kernel": ("seg_softmax",)}


def _by_symbol(per_forward, times=1):
    return {sym: times * sum(per_forward.get(w, 0) for w in wrappers)
            for sym, wrappers in SYMBOLS.items()}


def _kernel_nodes(prog, path):
    """The kernel nodes of a captured program's graph, one label each, as
    ``CUDAGraph.debug_dump`` writes them (Graphviz)."""
    prog.graph.debug_dump(str(path))
    text = Path(path).read_text(errors="replace")
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', text)[1:]
    return [node for node in nodes if "KERNEL" in node]


def _device_kernels(run):
    """``run()`` under ``torch.profiler``: the device kernel events of each
    symbol (those inside a CUDA-graph replay too)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return {sym: sum(sym in n for n in names) for sym in SYMBOLS}


@pytest.fixture
def card():
    """The card, with torch's deterministic algorithms on while the test
    runs: ``index_add_`` then sums without atomics (the readout, the
    statistics, DGN's field), so two eager forwards are bitwise equal and a
    replay is held to them bitwise. ``warn_only``: cuBLAS asks for a
    workspace setting these tests do not make (its products run in a fixed
    order on one stream either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _eager(eng, g, runs=2):
    """The parent's forward, composed: ``build_graph_batch`` on the card,
    ``model.apply``, the output on the host; ``runs`` times, which must be
    bitwise equal (deterministic algorithms). One run's output."""
    node_pad, edge_pad = (tgraph.pad_bucket(g.node_feat.shape[0],
                                            eng.buckets),
                          tgraph.pad_bucket(g.senders.shape[0], eng.buckets))
    outs = []
    for _ in range(runs):
        batch = tgraph.build_graph_batch(
            g.node_feat, g.senders, g.receivers, node_pad=node_pad,
            edge_pad=edge_pad, pos_dim=eng.cfg.pos_dim, device=eng.device,
            **_raw(g))
        with torch.inference_mode():
            out = eng.model.apply(eng.params, batch, eng.cfg, eng.dataflow)
        outs.append(out.cpu().numpy()[0])
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_cuda_replay_matches_eager(name, impl, tmp_path, card):
    """Both serving buckets: each answer from the captured graph bitwise the
    eager forward's; the wrappers count one forward's launches for each
    program's warm-up run and one for its capture, and the graph holds each
    kernel as often as a forward launches it."""
    eng = _engine(name, impl, "cuda")
    graphs = [_molecule(s) for s in range(3)] + [_knn(2), _knn(3)]
    want = PER_FORWARD[impl][name]
    for fn in launch_counters().values():
        fn.launches = 0
    got = [eng.process(*_args(g)) for g in graphs]
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    built = len(eng.compiled)
    assert built == len({
        (tgraph.pad_bucket(g.node_feat.shape[0], eng.buckets),
         tgraph.pad_bucket(g.senders.shape[0], eng.buckets)) for g in graphs})
    assert counts == {k: want.get(k, 0) * 2 * built for k in counts}
    for i, g in enumerate(graphs):
        np.testing.assert_array_equal(got[i], _eager(eng, g),
                                      err_msg=f"{name} {impl} graph {i}")
    for j, prog in enumerate(eng.compiled.values()):
        nodes = _kernel_nodes(prog, tmp_path / f"{j}.dot")
        assert {sym: sum(sym in n for n in nodes)
                for sym in SYMBOLS} == _by_symbol(want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gat", "pna", "dgn"])
def test_cuda_small_graph_after_large_one(name, card):
    """A small graph replayed after a larger one in the same bucket (one
    bucket of 1024 nodes and edges) gives, bitwise, what it gives served
    alone and what the eager forward gives."""
    small, big = _molecule(4), _knn()
    alone = _engine(name, device="cuda", buckets=(1024,))
    after = _engine(name, device="cuda", buckets=(1024,))
    after.process(*_args(big))
    got = after.process(*_args(small))
    assert len(after.compiled) == 1
    np.testing.assert_array_equal(got, alone.process(*_args(small)))
    np.testing.assert_array_equal(got, _eager(alone, small))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gin", "gat", "dgn"])
def test_cuda_interleaved_buckets(name, card):
    """32/64 -> 64/1024 -> 32/64 in one engine (one memory pool): each
    answer bitwise the eager forward's."""
    eng = _engine(name, device="cuda")
    m, k = _molecule(6), _knn(4)
    first = eng.process(*_args(m))
    second = eng.process(*_args(k))
    third = eng.process(*_args(m))
    assert len(eng.compiled) == 2
    for got, g in ((first, m), (second, k), (third, m)):
        np.testing.assert_array_equal(got, _eager(eng, g))


@pytest.mark.cuda
def test_cuda_replay_counts_and_stats(card):
    """Building a program counts two forwards' launches (its warm-up run
    and its capture); a replay runs no wrapper, and the card runs one
    forward's kernels a replay (the profiler's device events); device_s is
    the replay's span (positive), one per graph."""
    eng = _engine("gat", "kernel", "cuda")
    g = _molecule(7)
    want = PER_FORWARD["kernel"]["gat"]
    for fn in launch_counters().values():
        fn.launches = 0
    eng.warmup(*_args(g))
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    assert counts == {k: 2 * want.get(k, 0) for k in counts}
    for fn in launch_counters().values():
        fn.launches = 0
    on_device = _device_kernels(
        lambda: [eng.process(*_args(g)) for _ in range(4)])
    assert on_device == _by_symbol(want, 4)
    assert all(fn.launches == 0 for fn in launch_counters().values())
    assert len(eng.stats.device_s) == 4
    assert all(0 < s < eng.stats.latencies_s[i]
               for i, s in enumerate(eng.stats.device_s))
