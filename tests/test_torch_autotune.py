"""Per-bucket autotune in the port's engine, against the reference's tests.

The twins of ``tests/test_stream_engine.py``'s autotune tests (a winner is
picked and persisted, ``pipeline`` among the candidates, a cached impl
round-trips), ``tests/test_layer_fused.py``'s candidate-set and cache tests
(the reference forces its Pallas path to see ``fused_layer`` offered; here
that is ``_candidate_dataflows(key, torch.device("cuda"))``, a pure call)
and ``tests/test_scheduler_executor.py``'s cache fingerprint, on the CPU
(the JAX package is imported inside the tests that use it: the ``cuda``
tests run where JAX is not installed).

On top of them: the port's CPU candidate list equals the JAX engine's
(num_banks, edge_tile, impl) list at several buckets and ``max_autotune``
values; ``DataflowConfig(rows_per_block=k)`` reaches every kernel wrapper
``propagate`` calls, under each kernel impl; the six models' outputs are
bitwise the same for any ``rows_per_block`` on the CPU; a bucket tuned to
``pipeline`` demotes from there; a cached winner serves within 1e-5 of the
untuned engine. The ``cuda`` tests keep the winner's own capture as the
bucket's program.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.faults import FaultInjector  # noqa: E402
from repro_torch.core.graph import build_graph_batch  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.data.graphs import molhiv_like  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

MODELS = sorted(PAPER_GNN_CONFIGS)
KERNEL_IMPLS = ("fused_layer", "pipeline", "kernel")
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
TOL = dict(atol=1e-5, rtol=1e-5)


def small_cfg(name, cfgs=PAPER_GNN_CONFIGS):
    cfg = cfgs[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _params(cfg, device="cpu"):
    return make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                              device=device)


def _make_engine(name, **kw):
    cfg = small_cfg(name)
    kw.setdefault("devices", ["cpu"])
    return GraphStreamEngine(cfg, _params(cfg), **kw)


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


def _graph():
    return next(molhiv_like(seed=0, n_graphs=1))


def _jax_engine(**kw):
    """The JAX engine at the same small GIN config (imported here: the
    ``cuda`` tests run where JAX is not installed)."""
    import jax
    from repro.core.engine import GraphStreamEngine as JEngine
    from repro.core.models import PAPER_GNN_CONFIGS as JCFG
    from repro.core.models import make_gnn as jmake
    jcfg = small_cfg("gin", JCFG)
    return JEngine(jcfg, jmake(jcfg).init(jax.random.PRNGKey(0), jcfg), **kw)


def _section(cache):
    saved = json.loads(cache.read_text())
    (section,) = (v for k, v in saved.items() if k != "__schema__")
    return saved, section


# ---------------------------------------------------------------------------
# tests/test_stream_engine.py
# ---------------------------------------------------------------------------

def test_autotune_picks_and_persists(tmp_path):
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        eng.process(*_args(g))
        report = eng.autotune_report()
        assert len(report) == 1
        (entry,) = report.values()
        assert entry["source"] == "autotuned"
        assert entry["num_banks"] >= 1 and entry["edge_tile"] >= 8
        assert len(entry["candidates_us"]) >= 2
        assert entry["failed"] == {}
        assert entry["programs"] == len(entry["candidates_us"])
    saved = json.loads(cache.read_text())
    # schema tag plus one workload-fingerprint section holding one bucket
    sections = {k: v for k, v in saved.items() if k != "__schema__"}
    assert len(sections) == 1
    (section,) = sections.values()
    assert len(section) == 1

    # a fresh engine loads the cache and skips the candidate search
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng2:
        eng2.process(*_args(g))
        (entry2,) = eng2.autotune_report().values()
        assert entry2["source"] == "cache"
        assert "candidates_us" not in entry2
        assert (entry2["num_banks"], entry2["edge_tile"]) == (
            entry["num_banks"], entry["edge_tile"])


def test_autotune_candidates_include_pipeline_and_cache_roundtrips_impl(
        tmp_path):
    """The candidate set offers the fused gather-phi-scatter pipeline, and
    a cached impl='pipeline' winner survives the JSON round trip and
    serves within 1e-5 of the untuned engine."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        key = (64, 128, 1)
        cands = eng._candidate_dataflows(key, CPU)
        assert any(df.impl == "pipeline" for df in cands)
        assert cands[0].impl == eng.dataflow.impl
        eng.process(*_args(g))
        (entry,) = eng.autotune_report().values()
        # the pipeline candidate was timed beside the (banks, tile) ones
        assert any(name.endswith("_pipeline")
                   for name in entry["candidates_us"])
        base = eng.process(*_args(g))
    with _make_engine("gin", max_batch=1) as plain:
        untuned = plain.process(*_args(g))

    # force a pipeline winner into the cache section and reload it
    saved, section = _section(cache)
    (bucket_entry,) = section.values()
    bucket_entry["impl"] = "pipeline"
    cache.write_text(json.dumps(saved))
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng2:
        out = eng2.process(*_args(g))
        (entry2,) = eng2.autotune_report().values()
        assert entry2["source"] == "cache"
        assert entry2["impl"] == "pipeline"
        (prog,) = eng2.compiled.values()
        assert prog.dataflow.impl == "pipeline"
    np.testing.assert_allclose(base, out, **TOL)
    np.testing.assert_allclose(untuned, out, **TOL)


def test_warmup_all_tunes_every_configured_bucket():
    """With ``autotune`` the warm-up tunes each bucket once (on its
    synthetic batch) and every executor then holds only the winner."""
    with _make_engine("gin", buckets=(32, 64), max_batch=2, autotune=True,
                      devices=["cpu"] * 2) as eng:
        keys = eng.warmup_all()
        report = eng.autotune_report()
        assert {k for k, _ in eng.compiled} == set(keys)
        assert all(report["x".join(map(str, k))]["source"] == "autotuned"
                   for k in keys)
        for ex in eng._executors:
            assert {k for k, _ in ex.compiled} == set(keys)
            for (key, _), prog in ex.compiled.items():
                assert prog.dataflow == eng._tuned[key]
        assert set(eng.edge_passes) == set(keys)


# ---------------------------------------------------------------------------
# tests/test_layer_fused.py
# ---------------------------------------------------------------------------

def test_candidate_set_includes_fused_layer_and_grid_expands():
    key = (64, 128, 1)
    with _make_engine("gin") as eng:
        cands = eng._candidate_dataflows(key, CPU)
        assert any(df.impl == "pipeline" for df in cands)
        # off the card fused_layer is left out, as the reference leaves it
        # out where it would time a bitwise duplicate of the pipeline
        assert not any(df.impl == "fused_layer" for df in cands)
        assert len(cands) <= 5                 # default warmup stays cheap
        forced = eng._candidate_dataflows(key, CUDA)
        assert any(df.impl == "fused_layer" for df in forced)
        assert len(forced) <= 5
    with _make_engine("gin", max_autotune=24) as eng_wide:
        wide = eng_wide._candidate_dataflows(key, CPU)
        assert len(wide) == 24
        combos = {(d.num_banks, d.edge_tile, d.impl) for d in wide}
        assert len(combos) == 24               # no duplicate timings
        assert {d.num_banks for d in wide} >= {1, 2, 4, 8}
        assert {d.edge_tile for d in wide} >= {32, 64, 128}
        card = eng_wide._candidate_dataflows(key, CUDA)
        shapes = {(d.impl, d.rows_per_block) for d in card}
        assert len(shapes) == len(card)        # no duplicate timings
        assert {d.rows_per_block for d in card} == {None, 1, 2, 4, 8, 16}
        assert {d.impl for d in card} == {"fused", "pipeline",
                                          "fused_layer"}
    with _make_engine("gin", max_autotune=2) as eng_narrow:
        narrow = eng_narrow._candidate_dataflows(key, CPU)
        assert len(narrow) == 2
        # impl diversity outranks tile diversity under truncation
        assert {d.impl for d in narrow} == {eng_narrow.dataflow.impl,
                                            "pipeline"}
        card = eng_narrow._candidate_dataflows(key, CUDA)
        assert [d.impl for d in card] == [eng_narrow.dataflow.impl,
                                          "pipeline"]


def test_autotune_cache_roundtrips_fused_layer(tmp_path):
    """A cached impl='fused_layer' winner survives the JSON round trip and
    serves within 1e-5 of the tuned and the untuned engine."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        base = eng.process(*_args(g))
        (entry,) = eng.autotune_report().values()
        assert entry["source"] == "autotuned"
    with _make_engine("gin", max_batch=1) as plain:
        untuned = plain.process(*_args(g))
    saved = json.loads(cache.read_text())
    assert saved["__schema__"] == GraphStreamEngine.AUTOTUNE_CACHE_SCHEMA
    _, section = _section(cache)
    (bucket_entry,) = section.values()
    bucket_entry["impl"] = "fused_layer"
    bucket_entry["rows_per_block"] = 8
    saved[next(k for k in saved if k != "__schema__")] = section
    cache.write_text(json.dumps(saved))
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng2:
        out = eng2.process(*_args(g))
        (entry2,) = eng2.autotune_report().values()
        assert entry2["source"] == "cache"
        assert entry2["impl"] == "fused_layer"
        assert entry2["rows_per_block"] == 8
    np.testing.assert_allclose(base, out, **TOL)
    np.testing.assert_allclose(untuned, out, **TOL)


def test_autotune_cache_stale_schema_invalidated(tmp_path):
    """A cache written under another schema (or none) is ignored on load,
    and the file is rebuilt on save."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        eng.process(*_args(g))
    saved = json.loads(cache.read_text())
    stale = {k: v for k, v in saved.items() if k != "__schema__"}
    stale["__schema__"] = GraphStreamEngine.AUTOTUNE_CACHE_SCHEMA - 1
    cache.write_text(json.dumps(stale))
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng2:
        eng2.process(*_args(g))
        (entry,) = eng2.autotune_report().values()
        assert entry["source"] == "autotuned"     # stale cache was ignored
    rebuilt = json.loads(cache.read_text())
    assert rebuilt["__schema__"] == GraphStreamEngine.AUTOTUNE_CACHE_SCHEMA


# ---------------------------------------------------------------------------
# tests/test_scheduler_executor.py
# ---------------------------------------------------------------------------

def test_autotune_fingerprint_namespaces_backend_and_device(tmp_path):
    """Cache sections are keyed by torch, the device type and the device
    kind, and the report names the executor each bucket was tuned on: a
    cache written on one device, or by the JAX engine, is never applied
    on another."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        eng.process(*_args(g))
        (entry,) = eng.autotune_report().values()
        assert entry["source"] == "autotuned"
        assert entry["device"] == eng._executors[0].label == "cpu#0"
    saved = json.loads(cache.read_text())
    (section_key,) = (k for k in saved if k != "__schema__")
    assert section_key.startswith("torch:cpu:")
    assert "cpu" in section_key.split("/")[0].split(":")[2]


def test_a_file_shared_with_the_jax_engine_keeps_both_sections(tmp_path):
    """One cache file written by the JAX engine and the port: each keeps
    the other's section and loads only its own winners."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    with _jax_engine(max_batch=1, autotune=True,
                     autotune_cache=str(cache)) as jeng:
        jeng.process(*_args(g))
    with _make_engine("gin", max_batch=1, autotune=True,
                      autotune_cache=str(cache)) as eng:
        eng.process(*_args(g))
        (entry,) = eng.autotune_report().values()
        assert entry["source"] == "autotuned"   # the JAX winner not applied
    saved = json.loads(cache.read_text())
    sections = sorted(k for k in saved if k != "__schema__")
    assert len(sections) == 2
    assert sum(k.startswith("torch:") for k in sections) == 1
    with _jax_engine(max_batch=1, autotune=True,
                     autotune_cache=str(cache)) as jeng:
        jeng.process(*_args(g))
        (jentry,) = jeng.autotune_report().values()
        assert jentry["source"] == "cache"


# ---------------------------------------------------------------------------
# the candidate list against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_autotune", [1, 2, 5, 24])
@pytest.mark.parametrize("key", [(32, 64, 1), (64, 128, 1), (1024, 2048, 8)])
def test_cpu_candidates_equal_the_reference(key, max_autotune):
    with _jax_engine(max_autotune=max_autotune) as jeng:
        want = [(d.num_banks, d.edge_tile, d.impl)
                for d in jeng._candidate_dataflows(key)]
    with _make_engine("gin", max_autotune=max_autotune) as eng:
        cands = eng._candidate_dataflows(key, CPU)
    assert [(d.num_banks, d.edge_tile, d.impl) for d in cands] == want
    assert all(d.rows_per_block is None for d in cands)


@pytest.mark.parametrize("impl", ["fused_layer", "pipeline", "kernel",
                                  "fused", "unfused"])
def test_card_candidates_order_and_cheap_set(impl):
    """On the card: the configured impl first, then ``pipeline`` and
    ``fused_layer``, at the configured launch shape; then the configured
    impl at the rest of {None, 1, 8}; a plain impl (no kernel) at None
    only; no duplicate at any ``max_autotune``."""
    key = (64, 1024, 8)
    with _make_engine("gin", dataflow=DataflowConfig(impl=impl),
                      max_autotune=5) as eng:
        cands = eng._candidate_dataflows(key, CUDA)
    impls = list(dict.fromkeys([impl, "pipeline", "fused_layer"]))
    assert [d.impl for d in cands[:len(impls)]] == impls
    assert all(d.rows_per_block is None for d in cands[:len(impls)])
    if impl in KERNEL_IMPLS:
        assert [(d.impl, d.rows_per_block)
                for d in cands[len(impls):len(impls) + 2]] == [(impl, 1),
                                                               (impl, 8)]
    for d in cands:
        assert (d.num_banks, d.edge_tile) == (4, 128)
        if d.impl not in KERNEL_IMPLS:
            assert d.rows_per_block is None
    for n in (1, 2, 5, 24):
        with _make_engine("gin", dataflow=DataflowConfig(impl=impl),
                          max_autotune=n) as eng:
            got = eng._candidate_dataflows(key, CUDA)
        shapes = [(d.impl, d.rows_per_block) for d in got]
        assert len(set(shapes)) == len(shapes) == min(
            n, 6 * sum(i in KERNEL_IMPLS for i in impls)
            + sum(i not in KERNEL_IMPLS for i in impls))


# ---------------------------------------------------------------------------
# rows_per_block through propagate
# ---------------------------------------------------------------------------

WRAPPERS = ("layer_fused", "mp_pipeline", "mp_scatter", "mp_scatter_multi",
            "seg_softmax")
# the wrappers each model calls under each kernel impl
CALLED = {("fused_layer", m): {"layer_fused"} for m in
          ("gin", "gcn", "gin_vn", "pna", "dgn")}
CALLED.update({("pipeline", m): {"mp_pipeline"} for m in MODELS})
CALLED[("fused_layer", "gat")] = {"mp_pipeline"}
CALLED.update({("kernel", m): {"mp_scatter"} for m in
               ("gin", "gcn", "gin_vn")})
CALLED[("kernel", "gat")] = {"mp_scatter", "seg_softmax"}
CALLED[("kernel", "pna")] = {"mp_scatter_multi"}
CALLED[("kernel", "dgn")] = {"mp_scatter_multi"}


def _batch(cfg):
    g = _graph()
    return build_graph_batch(
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        node_pos=g.node_pos, node_pad=64, edge_pad=128, graph_pad=1,
        pos_dim=cfg.pos_dim, device="cpu")


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_rows_per_block_reaches_every_kernel_wrapper(name, impl,
                                                     monkeypatch):
    """A spy on each wrapper of ``kernels/ops.py``: under ``impl`` every
    call ``propagate`` (and GAT's layer) makes carries the dataflow's
    ``rows_per_block``, at 3 and at None."""
    cfg = small_cfg(name)
    params, batch = _params(cfg), _batch(cfg)
    for rows in (3, None):
        seen = []
        for w in WRAPPERS:
            real = getattr(kops, w)

            def spy(*a, _real=real, _w=w, **kw):
                seen.append((_w, kw.get("rows_per_block", "missing")))
                return _real(*a, **kw)
            monkeypatch.setattr(kops, w, spy)
        with torch.inference_mode():
            make_gnn(cfg).apply(params, batch, cfg,
                                DataflowConfig(impl=impl,
                                               rows_per_block=rows))
        monkeypatch.undo()
        assert {w for w, _ in seen} == CALLED[(impl, name)]
        assert len(seen) >= cfg.num_layers
        assert all(r == rows for _, r in seen), seen


@pytest.mark.parametrize("name", MODELS)
def test_outputs_are_bitwise_unchanged_for_any_rows_per_block(name):
    cfg = small_cfg(name)
    params, batch = _params(cfg), _batch(cfg)
    model = make_gnn(cfg)
    for impl in KERNEL_IMPLS:
        with torch.inference_mode():
            ref = model.apply(params, batch, cfg, DataflowConfig(impl=impl))
            for rows in (1, 3, 8, 16):
                out = model.apply(params, batch, cfg, DataflowConfig(
                    impl=impl, rows_per_block=rows))
                assert torch.equal(out, ref), (impl, rows)


def test_dataflow_mirrors_the_reference_fields():
    """The port's DataflowConfig keeps the reference's fields and defaults
    and adds only ``rows_per_block`` (default None)."""
    import dataclasses

    from repro.core.message_passing import DataflowConfig as JDF
    ours = {f.name: f.default for f in dataclasses.fields(DataflowConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JDF)}
    assert ours.pop("rows_per_block") is None
    assert ours == ref


# ---------------------------------------------------------------------------
# the tuned winner is rung 0 of the breaker's ladder
# ---------------------------------------------------------------------------

def test_a_bucket_tuned_to_pipeline_demotes_from_there(tmp_path):
    """A bucket whose winner is ``pipeline`` (rung 1) serves on it, and a
    NaN trip demotes it one rung from there (the single-pass plain forms),
    not from the configured dataflow's rung."""
    cache = tmp_path / "autotune.json"
    g = _graph()
    graphs = [g] * 8
    kw = dict(max_batch=8, max_wait_ms=200.0, eager_flush=False,
              autotune=True, autotune_cache=str(cache),
              dataflow=DataflowConfig(impl="fused_layer"),
              breaker_cooldown_s=3600.0)
    with _make_engine("gin", **kw) as eng:
        futs = [eng.submit(*_args(x)) for x in graphs]
        eng.drain(timeout=300)
        ref = [f.result(timeout=5) for f in futs]
    saved, section = _section(cache)
    (bucket_entry,) = section.values()
    bucket_entry["impl"] = "pipeline"
    cache.write_text(json.dumps(saved))
    inj = FaultInjector(seed=0).nan_request(2)
    with _make_engine("gin", fault_injector=inj, **kw) as eng:
        futs = [eng.submit(*_args(x)) for x in graphs]
        eng.drain(timeout=300)
        assert futs[2].exception(timeout=5) is not None
        for i, f in enumerate(futs):
            if i != 2:
                np.testing.assert_allclose(f.result(timeout=5), ref[i],
                                           **TOL)
        (entry,) = eng.autotune_report().values()
        assert (entry["source"], entry["impl"]) == ("cache", "pipeline")
        assert entry["breaker"]["level"] == 1
        assert entry["breaker"]["serving_impl"] == "fused"
        # the next batch is built at the demoted rung
        futs = [eng.submit(*_args(x)) for x in graphs]
        eng.drain(timeout=300)
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=5), ref[i], **TOL)
        (prog,) = eng.compiled.values()
        assert (prog.dataflow.impl, prog.dataflow.single_pass) == (
            "fused", True)


def test_autotune_off_keeps_the_configured_dataflow():
    with _make_engine("gin", max_batch=1,
                      dataflow=DataflowConfig(impl="fused_layer")) as eng:
        eng.process(*_args(_graph()))
        (entry,) = eng.autotune_report().values()
        assert entry["source"] == "default"
        assert (entry["impl"], entry["rows_per_block"]) == ("fused_layer",
                                                            None)
        assert "candidates_us" not in entry
        assert not eng._tuned


def test_a_candidate_that_raises_is_skipped_and_named(monkeypatch):
    """A candidate whose program fails is skipped (the reference's
    semantics) and named in the log's ``failed``; the others are timed
    and the winner serves."""
    real = tengine.GraphStreamEngine._make_run

    def make_run(self, df):
        run = real(self, df)
        if df.impl != "pipeline":
            return run

        def broken(params, graph):
            raise RuntimeError("planted candidate failure")
        return broken
    monkeypatch.setattr(tengine.GraphStreamEngine, "_make_run", make_run)
    with _make_engine("gin", max_batch=1, autotune=True) as eng:
        out = eng.process(*_args(_graph()))
        (entry,) = eng.autotune_report().values()
    (name,) = entry["failed"]
    assert name.endswith("_pipeline")
    assert "planted candidate failure" in entry["failed"][name]
    assert name not in entry["candidates_us"]
    assert entry["programs"] == len(entry["candidates_us"]) + 1
    assert entry["impl"] != "pipeline"
    assert np.all(np.isfinite(out))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_the_winners_capture_serves_the_bucket():
    """On the card each candidate is captured once, timed by its replay's
    span, and the winner's capture is the bucket's program: no capture
    more to serve, answers within 1e-5 of the eager forward under the
    winning dataflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PAPER_GNN_CONFIGS["gin"]
    params = _params(cfg, device="cuda")
    g = _graph()
    built = []
    real = tengine.CapturedProgram.__init__

    def counting(self, *a, **kw):
        real(self, *a, **kw)
        built.append(self)
    tengine.CapturedProgram.__init__ = counting
    try:
        with GraphStreamEngine(cfg, params,
                               DataflowConfig(impl="fused_layer"),
                               device="cuda", autotune=True) as eng:
            outs = [eng.process(*_args(g))]
            (entry,) = eng.autotune_report().values()
            assert entry["failed"] == {}
            assert len(built) == entry["programs"] == len(
                entry["candidates_us"])
            (prog,) = eng.compiled.values()
            ((key, winner),) = eng._tuned.items()
            assert prog in built and prog.dataflow == winner
            outs += [eng.process(*_args(g)) for _ in range(3)]
            assert len(built) == entry["programs"]
            batch = build_graph_batch(
                g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
                node_pos=g.node_pos, node_pad=key[0], edge_pad=key[1],
                graph_pad=key[2], pos_dim=cfg.pos_dim, device="cuda")
            with torch.inference_mode():
                want = make_gnn(cfg).apply(eng.params, batch, cfg, winner)
            for out in outs:
                np.testing.assert_allclose(out, want.cpu().numpy()[0], **TOL)
    finally:
        tengine.CapturedProgram.__init__ = real
