"""Chaos against the port's serving stack (``repro_torch/core/faults.py``
through ``GraphStreamEngine``), the twin of ``tests/test_faults.py``.

Every test drives the real engine on the CPU through ``FaultInjector`` and
holds it to the failure contract: futures resolve exactly once, a poison
graph is isolated by retry and bisection so that only ITS future fails,
the survivors are bitwise the fault-free run, a non-finite output is
quarantined, deadlines shed work before dispatch, the watchdog reclaims a
wedged executor, and ``drain`` / ``close`` stay bounded. Multi-executor
cases run a pool of three CPU executors (``devices=["cpu"] * 3``). Beside
the reference's cases: the injector's coins equal the reference
injector's for three seeds, poison isolation for all six models, rate
chaos of every kind on three executors, and a seeded chaos run that fails
exactly the requests the JAX engine fails under the same seed.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.faults import FaultInjector as JInjector  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.errors import (BatchFailed,  # noqa: E402
                                     DeadlineExceeded, EngineClosed,
                                     EngineError, ExecutorDead, PoisonGraph)
from repro_torch.core.faults import (FAULT_KINDS,  # noqa: E402
                                     FaultInjector, InjectedCrash,
                                     InjectedOOM)
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.data.graphs import molhiv_like  # noqa: E402

# injected worker crashes re-raise out of their (daemon) thread on
# purpose: that IS the fault being tested
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

MODELS = sorted(PAPER_GNN_CONFIGS)
POOL = ["cpu"] * 3


def _cfg(name="gin", cfgs=PAPER_GNN_CONFIGS):
    cfg = cfgs[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _params(cfg):
    return make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                              device="cpu")


def _graphs(n, seed=3):
    return list(molhiv_like(seed=seed, n_graphs=n))


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 200.0)
    kw.setdefault("eager_flush", False)     # deterministic co-packing
    kw.setdefault("devices", ["cpu"])
    return GraphStreamEngine(cfg, params, **kw)


def _submit_all(eng, graphs, **kw):
    return [eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                       g.node_pos, **kw) for g in graphs]


def _baseline(cfg, params, graphs, **kw):
    """Fault-free outputs for the same submission stream."""
    with _engine(cfg, params, **kw) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        return [f.result(timeout=5) for f in futs]


def _assert_all_resolved(futs):
    for i, f in enumerate(futs):
        assert f.done(), f"future {i} left unresolved"


# ---------------------------------------------------------------------------
# injector determinism
# ---------------------------------------------------------------------------

def test_injector_coins_are_deterministic():
    a = FaultInjector(seed=7, dispatch_error_rate=0.5, nan_rate=0.3)
    b = FaultInjector(seed=7, dispatch_error_rate=0.5, nan_rate=0.3)
    ids = range(200)
    assert [a.is_poison(r) for r in ids] == [b.is_poison(r) for r in ids]
    assert [a.is_nan(r) for r in ids] == [b.is_nan(r) for r in ids]
    c = FaultInjector(seed=8, dispatch_error_rate=0.5)
    assert [a.is_poison(r) for r in ids] != [c.is_poison(r) for r in ids]
    hits = sum(a.is_poison(r) for r in ids)
    assert 50 < hits < 150


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_injector_coins_equal_the_reference(seed):
    """Every kind's coin, for per-graph and per-executor identities, is
    the reference injector's under the same seed and rates."""
    rates = dict(crash_rate=0.3, dispatch_error_rate=0.2, stall_rate=0.25,
                 nan_rate=0.15, oom_rate=0.1, bad_input_rate=0.35)
    ours, ref = FaultInjector(seed, **rates), JInjector(seed, **rates)
    for kind in FAULT_KINDS:
        for r in range(64):
            assert ours._coin(kind, r) == ref._coin(kind, r), (kind, r)
        for ex in range(3):
            for n in range(16):
                assert ours._coin(kind, ex, n) == ref._coin(kind, ex, n)
    for r in range(64):
        assert ours.is_poison(r) == ref.is_poison(r)
        assert ours.is_nan(r) == ref.is_nan(r)
        assert ours.is_bad_input(r) == ref.is_bad_input(r)


def test_injector_scripting():
    inj = FaultInjector(seed=0).poison_request(3).nan_request(5)
    assert inj.is_poison(3) and not inj.is_poison(4)
    assert inj.is_nan(5) and not inj.is_nan(3)
    inj.oom_request(1)
    with pytest.raises(InjectedOOM):
        inj.on_submit(1)
    inj.on_submit(0)                         # healthy id passes


# ---------------------------------------------------------------------------
# poison isolation via retry + bisection quarantine
# ---------------------------------------------------------------------------

def test_poison_graph_isolated_by_bisection():
    """One poison graph co-packed with 7 healthy ones: exactly its future
    fails with PoisonGraph, every other output is bitwise identical to
    the fault-free run, nothing is stranded, drain stays bounded, and the
    retries and halves are served by the bucket's one program."""
    cfg, graphs = _cfg(), _graphs(8)
    params = _params(cfg)
    ref = _baseline(cfg, params, graphs)

    inj = FaultInjector(seed=0).poison_request(3)
    with _engine(cfg, params, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        with pytest.raises(PoisonGraph) as ei:
            futs[3].result(timeout=5)
        assert ei.value.request_ids == (3,)
        for i, f in enumerate(futs):
            if i != 3:
                np.testing.assert_array_equal(f.result(timeout=5), ref[i])
        s = eng.stats.summary()
        assert s["quarantined_graphs"] == 1
        assert s["failed"] == 1
        assert s["retries"] >= 2             # retry + bisection re-runs
        assert len(eng.compiled) == 1        # no program beyond the first
    assert inj.summary()["dispatch_error"] >= 2


@pytest.mark.parametrize("name", MODELS)
def test_poison_among_eight_fails_only_itself(name):
    """For every model: a poison graph among 8 fails its own future only;
    the seven others are bitwise the fault-free run."""
    cfg = _cfg(name)
    params = _params(cfg)
    graphs = _graphs(8, seed=4)
    ref = _baseline(cfg, params, graphs)
    inj = FaultInjector(seed=0).poison_request(5)
    with _engine(cfg, params, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        failed = [i for i, f in enumerate(futs) if f.exception() is not None]
        assert failed == [5]
        assert isinstance(futs[5].exception(), PoisonGraph)
        for i, f in enumerate(futs):
            if i != 5:
                np.testing.assert_array_equal(f.result(timeout=5), ref[i])


def test_acceptance_poison_with_executor_killed_mid_stream():
    """A poison graph co-packed with 7 healthy ones on a pool of three
    executors, one killed mid-stream: exactly one future fails
    (PoisonGraph), all others are bitwise the fault-free run, none is left
    unresolved, drain returns in time, the pool reports degraded."""
    cfg, graphs = _cfg(), _graphs(8)
    params = _params(cfg)
    ref = _baseline(cfg, params, graphs, devices=POOL)

    inj = (FaultInjector(seed=0).poison_request(3)
           .kill_executor(0, after_batches=0))
    with _engine(cfg, params, devices=POOL, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        t0 = time.perf_counter()
        eng.drain(timeout=300)
        assert time.perf_counter() - t0 < 300
        _assert_all_resolved(futs)
        failed = [i for i, f in enumerate(futs) if f.exception() is not None]
        assert failed == [3]
        assert isinstance(futs[3].exception(), PoisonGraph)
        for i, f in enumerate(futs):
            if i != 3:
                np.testing.assert_array_equal(f.result(timeout=5), ref[i])
        s = eng.stats.summary()
        assert s["executor_deaths"] == 1
        assert s["pool_degraded"] is True
        assert s["quarantined_graphs"] == 1
        assert eng._executors[0].dead
    assert inj.summary()["crash"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_rate_chaos_is_reproducible(seed):
    """Randomized chaos at fixed seeds: the failed requests are exactly the
    injector-predicted set, every failure is typed, every survivor is
    bitwise the fault-free run."""
    cfg, graphs = _cfg(), _graphs(24)
    params = _params(cfg)
    ref = _baseline(cfg, params, graphs)

    rates = dict(dispatch_error_rate=0.15, nan_rate=0.1)
    inj = FaultInjector(seed=seed, **rates)
    oracle = FaultInjector(seed=seed, **rates)
    expected_failed = {r for r in range(len(graphs))
                       if oracle.is_poison(r) or oracle.is_nan(r)}
    assert expected_failed, "chaos seeds should hit at least one victim"

    with _engine(cfg, params, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        failed = {i for i, f in enumerate(futs)
                  if f.exception() is not None}
        assert failed == expected_failed
        for i, f in enumerate(futs):
            if i in failed:
                assert isinstance(f.exception(), PoisonGraph)
            else:
                np.testing.assert_array_equal(f.result(timeout=5), ref[i])


def test_seeded_chaos_fails_what_the_reference_fails():
    """The JAX engine and the port under the same seed and rates fail the
    same requests, with the same types, and their survivors agree to
    1e-5."""
    graphs = _graphs(24)
    rates = dict(dispatch_error_rate=0.15, nan_rate=0.1)
    jcfg = _cfg("gin", JCFG)
    jparams = jmake(jcfg).init(jax.random.PRNGKey(0), jcfg)
    with JEngine(jcfg, jparams, max_batch=8, max_wait_ms=200.0,
                 eager_flush=False, devices=jax.devices()[:1],
                 fault_injector=JInjector(seed=1, **rates)) as jeng:
        jfuts = _submit_all(jeng, graphs)
        jeng.drain(timeout=300)
    from repro_torch.checkpoint.convert import params_from_numpy
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    with _engine(_cfg(), params,
                 fault_injector=FaultInjector(seed=1, **rates)) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
    assert ({i for i, f in enumerate(futs) if f.exception() is not None}
            == {i for i, f in enumerate(jfuts) if f.exception() is not None})
    for f, jf in zip(futs, jfuts):
        if jf.exception() is not None:
            assert type(f.exception()).__name__ == (
                type(jf.exception()).__name__)
        else:
            np.testing.assert_allclose(f.result(), np.asarray(jf.result()),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# NaN/Inf output-validation gate
# ---------------------------------------------------------------------------

def test_nan_gate_quarantines_offending_graph():
    cfg, graphs = _cfg(), _graphs(4)
    params = _params(cfg)
    inj = FaultInjector(seed=0).nan_request(2)
    with _engine(cfg, params, max_batch=4, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        with pytest.raises(PoisonGraph):
            futs[2].result(timeout=5)
        for i in (0, 1, 3):
            assert np.all(np.isfinite(futs[i].result(timeout=5)))
        assert eng.stats.quarantined == 1


def test_nan_gate_can_be_disabled():
    cfg, graphs = _cfg(), _graphs(2)
    params = _params(cfg)
    inj = FaultInjector(seed=0).nan_request(0)
    with _engine(cfg, params, max_batch=2, fault_injector=inj,
                 validate_outputs=False) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        assert np.all(np.isnan(futs[0].result(timeout=5)))


# ---------------------------------------------------------------------------
# submit-time OOM
# ---------------------------------------------------------------------------

def test_submit_oom_rejects_before_future_exists():
    cfg, graphs = _cfg(), _graphs(3)
    params = _params(cfg)
    inj = FaultInjector(seed=0).oom_request(0)
    with _engine(cfg, params, max_batch=2, fault_injector=inj) as eng:
        with pytest.raises(InjectedOOM):
            _submit_all(eng, graphs[:1])
        futs = _submit_all(eng, graphs[1:])  # engine still serves
        eng.drain(timeout=300)
        for f in futs:
            assert np.all(np.isfinite(f.result(timeout=5)))


# ---------------------------------------------------------------------------
# deadlines: shed before dispatch
# ---------------------------------------------------------------------------

def test_deadline_shed_before_dispatch():
    cfg, graphs = _cfg(), _graphs(2)
    params = _params(cfg)
    with _engine(cfg, params, max_wait_ms=5000.0) as eng:
        # never fills a batch, never flushes for 5 s: the deadline fires
        # long before dispatch could happen
        fut = _submit_all(eng, graphs[:1], deadline=0.05)[0]
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=10)
        assert eng.stats.shed_deadline == 1
        assert not eng.compiled               # it never reached a program
        ok = _submit_all(eng, graphs[1:], deadline=30.0)[0]
        eng.drain(timeout=300)
        assert np.all(np.isfinite(ok.result(timeout=5)))


def test_deadline_validation():
    cfg = _cfg()
    params = _params(cfg)
    g = _graphs(1)[0]
    with _engine(cfg, params) as eng:
        with pytest.raises(ValueError):
            eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                       g.node_pos, deadline=0.0)


def test_deadline_bounds_the_admission_wait():
    """A deadline'd request blocked at backpressure waits at most its
    budget, then fails fast without being admitted."""
    cfg, graphs = _cfg(), _graphs(2)
    params = _params(cfg)
    with _engine(cfg, params, max_pending=1, max_wait_ms=5000.0) as eng:
        first = _submit_all(eng, graphs[:1])[0]       # holds the cap
        t0 = time.perf_counter()
        late = _submit_all(eng, graphs[1:], deadline=0.1)[0]
        assert time.perf_counter() - t0 < 5.0
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=5)
        eng.drain(timeout=300)
        assert np.all(np.isfinite(first.result(timeout=5)))
        assert eng.stats.shed_deadline == 1


# ---------------------------------------------------------------------------
# in-flight watchdog
# ---------------------------------------------------------------------------

def test_watchdog_reclaims_stalled_batch():
    """A transfer stall longer than the in-flight timeout: the watchdog
    fails the stuck batch with DeadlineExceeded, marks the executor dead,
    and the late completion is ignored (registry miss, no crash)."""
    cfg, graphs = _cfg(), _graphs(2)
    params = _params(cfg)
    inj = FaultInjector(seed=0, stall_s=1.5).stall_request(0)
    with _engine(cfg, params, max_batch=2, fault_injector=inj,
                 inflight_timeout_s=0.25) as eng:
        eng.warmup_all(pairs=[(64, 128), (128, 256), (256, 512)])
        futs = _submit_all(eng, graphs)
        with pytest.raises(DeadlineExceeded):
            futs[0].result(timeout=30)
        _assert_all_resolved(futs)
        assert eng.stats.executor_deaths >= 1
        assert eng.stats.pool_degraded is True
        assert eng._dead_executors             # kept, never freed early
        time.sleep(1.6)        # let the stalled completer wake harmlessly
        eng.close(timeout=10)
    assert inj.summary()["stall"] == 1


# ---------------------------------------------------------------------------
# bounded drain/close: wedged executors never strand callers
# ---------------------------------------------------------------------------

def test_drain_timeout_fails_outstanding_futures():
    cfg, graphs = _cfg(), _graphs(2)
    params = _params(cfg)
    inj = FaultInjector(seed=0, stall_s=6.0).stall_request(0)
    eng = _engine(cfg, params, max_batch=2, fault_injector=inj)
    futs = _submit_all(eng, graphs)
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        eng.drain(timeout=0.5)
    assert time.perf_counter() - t0 < 5.0
    _assert_all_resolved(futs)
    for f in futs:
        assert isinstance(f.exception(), ExecutorDead)
    assert eng.stats.failed == 2
    t0 = time.perf_counter()
    eng.close(timeout=1.0)                   # bounded despite the sleeper
    assert time.perf_counter() - t0 < 10.0


def test_close_timeout_is_bounded():
    cfg, graphs = _cfg(), _graphs(1)
    params = _params(cfg)
    inj = FaultInjector(seed=0, stall_s=6.0).stall_request(0)
    eng = _engine(cfg, params, max_batch=1, fault_injector=inj)
    futs = _submit_all(eng, graphs)
    time.sleep(0.3)                          # let it reach the stall
    t0 = time.perf_counter()
    eng.close(timeout=1.0)
    assert time.perf_counter() - t0 < 10.0
    _assert_all_resolved(futs)
    assert isinstance(futs[0].exception(), ExecutorDead)


def test_submit_after_close_raises_typed_error():
    cfg = _cfg()
    params = _params(cfg)
    g = _graphs(1)[0]
    eng = _engine(cfg, params)
    eng.close()
    with pytest.raises(EngineClosed):
        eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                   g.node_pos)


# ---------------------------------------------------------------------------
# supervision: degradation and respawn
# ---------------------------------------------------------------------------

def test_executor_death_work_replaces_on_survivors():
    """Kill one executor of three mid-stream: its work re-places on the
    survivors, every future succeeds, the pool reports degraded."""
    cfg, graphs = _cfg(), _graphs(12)
    params = _params(cfg)
    ref = _baseline(cfg, params, graphs, max_batch=4, devices=POOL)
    inj = FaultInjector(seed=0).kill_executor(0, after_batches=0)
    with _engine(cfg, params, max_batch=4, devices=POOL,
                 fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=5), ref[i])
        s = eng.stats.summary()
        assert s["executor_deaths"] == 1
        assert s["pool_degraded"] is True
        assert s["retries"] >= 1             # the killed batch requeued


def test_respawn_restores_the_pool():
    """With respawn enabled a killed executor is replaced in its pool slot
    (a fresh params replica) and later submissions are served."""
    cfg, graphs = _cfg(), _graphs(4)
    params = _params(cfg)
    inj = FaultInjector(seed=0).kill_executor(0, after_batches=0)
    with _engine(cfg, params, max_batch=2, fault_injector=inj,
                 respawn_executors=True) as eng:
        first = _submit_all(eng, graphs[:2])
        deadline = time.time() + 60
        while eng.stats.respawns < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert eng.stats.respawns == 1
        later = _submit_all(eng, graphs[2:])
        eng.drain(timeout=300)
        _assert_all_resolved(first + later)
        for f in later:
            assert np.all(np.isfinite(f.result(timeout=5)))
        for f in first:
            if f.exception() is not None:
                assert isinstance(f.exception(), EngineError)
        assert eng.stats.pool_degraded is False
        assert eng.stats.executor_deaths == 1
        fresh = eng._executors[0]
        assert fresh.params is not eng._dead_executors[0].params


def test_crash_rate_chaos_never_strands():
    """Random crash chaos: whatever dies, every future resolves (success or
    a typed EngineError) and drain/close stay bounded."""
    cfg, graphs = _cfg(), _graphs(16)
    params = _params(cfg)
    inj = FaultInjector(seed=1, crash_rate=0.25)
    with _engine(cfg, params, max_batch=4, fault_injector=inj,
                 respawn_executors=True) as eng:
        futs = _submit_all(eng, graphs)
        try:
            eng.drain(timeout=120)
        except TimeoutError:
            pass                             # bounded is the contract
        _assert_all_resolved(futs)
        for f in futs:
            exc = f.exception()
            assert exc is None or isinstance(exc, EngineError)


@pytest.mark.parametrize("seed", [0, 3])
def test_every_kind_of_chaos_on_three_executors_resolves_once(seed):
    """Crash, dispatch error, NaN and stall coins together on a pool of
    three CPU executors with respawn and the watchdog: every future
    resolves exactly once, with its answer (bitwise the fault-free run) or
    a typed ``EngineError``; a graph the injector poisons or NaNs never
    returns an answer."""
    cfg, graphs = _cfg(), _graphs(32, seed=5)
    params = _params(cfg)
    ref = _baseline(cfg, params, graphs, max_batch=4, devices=POOL)
    rates = dict(crash_rate=0.1, dispatch_error_rate=0.1, nan_rate=0.1,
                 stall_rate=0.1)
    inj = FaultInjector(seed=seed, stall_s=0.6, **rates)
    oracle = FaultInjector(seed=seed, **rates)
    resolutions = {}

    with _engine(cfg, params, max_batch=4, devices=POOL, fault_injector=inj,
                 respawn_executors=True, inflight_timeout_s=0.4) as eng:
        eng.warmup_all(pairs=[(32, 64), (64, 128), (128, 256)])
        futs = _submit_all(eng, graphs)
        for i, f in enumerate(futs):
            f.add_done_callback(
                lambda f, i=i: resolutions.__setitem__(
                    i, resolutions.get(i, 0) + 1))
        try:
            eng.drain(timeout=120)
        except TimeoutError:
            pass
        _assert_all_resolved(futs)
        for i, f in enumerate(futs):
            exc = f.exception()
            if exc is None:
                assert not (oracle.is_poison(i) or oracle.is_nan(i)), i
                np.testing.assert_array_equal(f.result(), ref[i])
            else:
                assert isinstance(exc, EngineError), exc
                if isinstance(exc, BatchFailed):
                    assert isinstance(exc, PoisonGraph)
        time.sleep(0.7)                  # stalled completers wake, dropped
    assert resolutions == {i: 1 for i in range(len(graphs))}


def test_injected_crash_is_not_an_exception():
    """The crash escapes the executors' per-batch ``except Exception``."""
    assert issubclass(InjectedCrash, BaseException)
    assert not issubclass(InjectedCrash, Exception)
