"""Drift retune and LRU eviction of programs in the port's engine.

The twins of ``tests/test_overload.py``'s drift and eviction tests
(DESIGN.md §5), on the CPU (the JAX package is imported inside the tests
that use it: the ``cuda`` tests run where JAX is not installed): a bucket tuned at fill 4 that then sees single
graphs retunes and keeps serving; an executor holds at most
``max_cached_programs`` programs, evicting the least recently used, and an
evicted bucket serves again from its cached winner. On top of them: an
evicted or retuned program is freed only from ``ex.retired`` (at the
executor's next build), the drift trigger against the reference's on one
scripted sequence of completions, the knobs' defaults and the ``cuda``
tests (the pool's memory does not grow on a second cycle through more
buckets than the cap).
"""

import gc
import inspect
import time
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.engine import _BucketLoad  # noqa: E402
from repro_torch.core.executor import CompletedBatch  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.core.packing import PackedBatch, PackItem  # noqa: E402
from repro_torch.core.scheduler import QueueConfig  # noqa: E402
from repro_torch.data.graphs import sized_stream  # noqa: E402


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


def _submit(eng, g, **kw):
    return eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                      g.node_pos, **kw)


# ---------------------------------------------------------------------------
# tests/test_overload.py
# ---------------------------------------------------------------------------

def test_drift_retune_fires_and_bucket_stays_servable():
    cfg = small_cfg("gcn")
    with GraphStreamEngine(cfg, _params(cfg), devices=["cpu"],
                           queues=(QueueConfig("default", max_batch=4,
                                               max_wait_ms=3.0),),
                           autotune=True, max_autotune=2, eager_flush=False,
                           drift_window=4, drift_cooldown_s=0.05,
                           drift_fill_factor=1.3, max_retunes=2) as eng:
        futs = []
        full = list(sized_stream(seed=0, n_graphs=16, n_mean=20, n_std=0,
                                 e_per_node=2.2))
        for i in range(0, 16, 4):                  # tuned regime: fill 4
            futs += [_submit(eng, g) for g in full[i:i + 4]]
            eng.drain(timeout=120)
        # mix shift: singles land in the SAME bucket at fill 1, after a
        # lull past the 50 ms cooldown (a fast host serves the whole tuned
        # regime inside it, and then nothing may fire)
        time.sleep(0.1)
        singles = list(sized_stream(seed=1, n_graphs=6, n_mean=80, n_std=0,
                                    e_per_node=2.6))
        for g in singles:
            futs += [_submit(eng, g)]
            eng.drain(timeout=120)
        assert eng.stats.retunes >= 1
        # the retuned bucket still serves: it was built again on demand
        post = list(sized_stream(seed=2, n_graphs=4, n_mean=20, n_std=0,
                                 e_per_node=2.2))
        futs += [_submit(eng, g) for g in post]
        eng.drain(timeout=120)
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=5)))
        report = eng.autotune_report()
        assert any(e.get("load", {}).get("retunes", 0) >= 1
                   for e in report.values())
        assert eng.stats.summary()["retunes"] == eng.stats.retunes


def test_lru_eviction_bounds_compiled_programs():
    with _make_engine("gin", max_batch=1, max_wait_ms=1.0,
                      max_cached_programs=2) as eng:
        futs = []
        for nm in (10, 60, 200, 10):               # 3 buckets, then revisit
            for g in sized_stream(seed=nm, n_graphs=2, n_mean=nm, n_std=0):
                futs.append(_submit(eng, g))
            eng.drain(timeout=120)
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=5)))
        assert eng.stats.program_evictions >= 1
        for ex in eng._executors:
            assert len(ex.compiled) <= 2
            assert set(ex.touched) == set(ex.compiled)
        report = eng.autotune_report()
        assert any(e.get("evictions", 0) >= 1 for e in report.values())
        assert eng.stats.summary()["program_evictions"] == (
            eng.stats.program_evictions)


# ---------------------------------------------------------------------------
# beyond the reference's tests
# ---------------------------------------------------------------------------

def test_knobs_keep_the_reference_names_and_defaults():
    from repro.core.engine import GraphStreamEngine as JEngine
    ours = inspect.signature(GraphStreamEngine.__init__).parameters
    ref = inspect.signature(JEngine.__init__).parameters
    for name in ("autotune", "autotune_cache", "max_autotune",
                 "max_cached_programs", "drift_window",
                 "drift_device_factor", "drift_fill_factor",
                 "drift_cooldown_s", "max_retunes"):
        assert ours[name].default == ref[name].default, name
    for bad in (0, -1):
        with pytest.raises(ValueError):
            _make_engine("gin", max_cached_programs=bad)


def _three_buckets():
    """One graph in each of three buckets, at max_batch 1."""
    return [next(sized_stream(seed=nm, n_graphs=1, n_mean=nm, n_std=0))
            for nm in (10, 60, 200)]


def test_an_evicted_program_is_freed_only_from_retired():
    """The victim moves to ``ex.retired`` (still alive: a batch of it may
    be on the stream) and is freed when the executor next builds; the
    bucket serves again, built from its cached winner with no new tune."""
    a, b, c = _three_buckets()
    with _make_engine("gin", max_batch=1, max_cached_programs=1,
                      autotune=True) as eng:
        ex = eng._executors[0]
        first = _submit(eng, a).result(timeout=60)
        (prog_a,) = ex.compiled.values()
        ref = weakref.ref(prog_a)
        del prog_a
        _submit(eng, b).result(timeout=60)
        assert len(ex.compiled) == 1
        assert any(p is ref() for p in ex.retired)
        assert eng.stats.program_evictions == 1
        _submit(eng, c).result(timeout=60)     # the next build clears it
        gc.collect()
        assert ref() is None
        tuned = dict(eng._tuned)
        logs = {k: dict(v) for k, v in eng._tune_log.items()}
        again = _submit(eng, a).result(timeout=60)
        assert eng._tuned == tuned             # no new tune: the winner kept
        assert {k: v["candidates_us"] for k, v in eng._tune_log.items()} == {
            k: v["candidates_us"] for k, v in logs.items()}
        np.testing.assert_array_equal(first, again)
        assert eng.stats.program_evictions == 3
        report = eng.autotune_report()
        assert sum(e.get("evictions", 0) for e in report.values()) == 3


def test_a_retuned_program_is_freed_only_from_retired():
    a = _three_buckets()[0]
    with _make_engine("gin", max_batch=1, autotune=True) as eng:
        ex = eng._executors[0]
        first = _submit(eng, a).result(timeout=60)
        ((key, _), prog) = next(iter(ex.compiled.items()))
        ref = weakref.ref(prog)
        del prog
        eng._trigger_retune(key)
        assert key not in eng._tuned and not ex.compiled
        assert any(p is ref() for p in ex.retired)
        again = _submit(eng, a).result(timeout=60)  # tunes again, clears it
        gc.collect()
        assert ref() is None
        assert key in eng._tuned
        np.testing.assert_allclose(first, again, atol=1e-5, rtol=1e-5)


def _completion(pb, t, device_s):
    return CompletedBatch(queue="default", batch=pb, results=[],
                          err=None, t_build_start=t, t_dispatch=t,
                          t_ready=t, device_s=device_s)


def _fill(packed_cls, item_cls, k):
    items = [item_cls(node_feat=np.zeros((2, 9), np.float32),
                      senders=np.array([0], np.int32),
                      receivers=np.array([1], np.int32)) for _ in range(k)]
    return packed_cls(items=items, node_pad=32, edge_pad=64, graph_pad=4)


@pytest.mark.parametrize("case", ["batch_mix", "device_time", "quiet"])
def test_drift_trigger_matches_the_reference(case):
    """One scripted sequence of completions (fill, device time, clock)
    through both engines' ``_observe_bucket_locked``: the same retunes at
    the same batches, with the same reasons."""
    kw = dict(autotune=True, drift_window=4, drift_cooldown_s=0.05,
              drift_fill_factor=1.3, max_retunes=2)
    if case == "batch_mix":
        seq = [(4, 1e-3)] * 6 + [(1, 1e-3)] * 12
    elif case == "device_time":
        seq = [(4, 1e-3)] * 6 + [(4, 9e-3)] * 12
    else:
        seq = [(4, 1e-3)] * 18
    import jax
    from repro.core.engine import GraphStreamEngine as JEngine
    from repro.core.engine import _BucketLoad as JLoad
    from repro.core.models import PAPER_GNN_CONFIGS as JCFG
    from repro.core.models import make_gnn as jmake
    from repro.core.packing import PackedBatch as JPackedBatch
    from repro.core.packing import PackItem as JPackItem
    jcfg = small_cfg("gin", JCFG)
    jeng = JEngine(jcfg, jmake(jcfg).init(jax.random.PRNGKey(0), jcfg), **kw)
    eng = _make_engine("gin", **kw)
    try:
        got = {}
        for tag, e, packed_cls, item_cls, load_cls in (
                ("ref", jeng, JPackedBatch, JPackItem, JLoad),
                ("port", eng, PackedBatch, PackItem, _BucketLoad)):
            key = (32, 64, 4)
            e._tuned[key] = e.dataflow
            load = e._bucket_load.setdefault(key, load_cls())
            load.tuned_device_s = 1e-3
            load.last_tune_t = 0.0
            out = []
            for i, (k, dev) in enumerate(seq):
                with e._cv:
                    out.append(e._observe_bucket_locked(
                        _fill(packed_cls, item_cls, k),
                        _completion(_fill(packed_cls, item_cls, k),
                                    0.1 * (i + 1), dev)))
            got[tag] = (out, e.stats.retunes)
        assert got["port"] == got["ref"]
        fired = [r for r in got["port"][0] if r is not None]
        assert (fired[0] if fired else "quiet") == case
    finally:
        jeng.close()
        eng.close()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_eviction_keeps_the_pool_flat():
    """GIN ``fused_layer`` at max_batch 1 with ``max_cached_programs=2``
    through four buckets twice: evictions, at most two programs held, and
    the executor's pool takes no more memory on the second cycle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = PAPER_GNN_CONFIGS["gin"]
    graphs = [next(sized_stream(seed=nm, n_graphs=1, n_mean=nm, n_std=0))
              for nm in (10, 60, 200, 400)]
    with GraphStreamEngine(cfg, _params(cfg, device="cuda"),
                           DataflowConfig(impl="fused_layer"), device="cuda",
                           max_batch=1, max_cached_programs=2) as eng:
        reserved = []
        for _ in range(2):
            for g in graphs:
                assert np.all(np.isfinite(_submit(eng, g).result(
                    timeout=120)))
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())
        assert eng.stats.program_evictions >= 6
        assert len(eng._executors[0].compiled) <= 2
        assert reserved[1] <= reserved[0]
