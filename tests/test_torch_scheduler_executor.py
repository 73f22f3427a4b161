"""The port's scheduler/executor split, against
``tests/test_scheduler_executor.py`` and the preemption tests of
``tests/test_overload.py``, on the CPU.

Covers the ``BatchScheduler`` drain policy alone (weighted-fair ordering,
re-entry floors, per-queue deadlines, idle flush, preempt chunks), the
engine facade over tenant queues (per-queue stats, the starvation bound,
unknown-queue rejection, per-queue backpressure, streaming futures), the
executor's death and stop paths, and a pool of CPU executors
(``devices=["cpu"] * 3``): the same stream on 1 and 3 executors gives
bitwise the same answers for all six models, with every executor serving.
The port's engine is held to the JAX engine on a packed stream at atol =
rtol = 1e-5 (what the reference holds between its own eager and compiled
forwards). Every wait in a threaded test has a time limit of its own.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.message_passing import DataflowConfig as JDF  # noqa: E402
from repro.core.models import PAPER_GNN_CONFIGS as JCFG  # noqa: E402
from repro.core.models import make_gnn as jmake  # noqa: E402
from repro_torch.checkpoint.convert import params_from_numpy  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.errors import (BatchFailed, ExecutorDead,  # noqa: E402
                                     InvalidRequest, UnknownQueue)
from repro_torch.core.executor import DeviceExecutor  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.core.packing import PackedBatch, PackItem  # noqa: E402
from repro_torch.core.scheduler import (BatchScheduler,  # noqa: E402
                                        QueueConfig)
from repro_torch.data.graphs import molhiv_like, sized_stream  # noqa: E402

MODELS = sorted(PAPER_GNN_CONFIGS)
POOL = ["cpu"] * 3


def small_cfg(name, cfgs=PAPER_GNN_CONFIGS):
    cfg = cfgs[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _make_engine(name, **kw):
    cfg = small_cfg(name)
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    kw.setdefault("devices", ["cpu"])
    return GraphStreamEngine(cfg, params, **kw)


def _item(n=8, e=16, seed=0, node_dim=4):
    r = np.random.default_rng(seed)
    return PackItem(
        node_feat=r.normal(size=(n, node_dim)).astype(np.float32),
        senders=r.integers(0, n, size=e).astype(np.int32),
        receivers=r.integers(0, n, size=e).astype(np.int32))


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


# ---------------------------------------------------------------------------
# BatchScheduler: weighted-fair draining, per-queue deadlines
# ---------------------------------------------------------------------------

def _two_queue_scheduler(w_bulk=1.0, w_lat=4.0, max_batch=2):
    return BatchScheduler(
        [QueueConfig("bulk", weight=w_bulk, max_wait_ms=1000.0,
                     max_batch=max_batch),
         QueueConfig("latency", weight=w_lat, max_wait_ms=1000.0,
                     max_batch=max_batch)])


def test_scheduler_rejects_bad_config():
    with pytest.raises(ValueError):
        BatchScheduler([])
    with pytest.raises(ValueError):
        BatchScheduler([QueueConfig("a"), QueueConfig("a")])
    with pytest.raises(ValueError):
        QueueConfig("a", weight=0.0)
    with pytest.raises(ValueError):
        BatchScheduler([QueueConfig("a")], preempt_chunk=0)
    s = _two_queue_scheduler()
    with pytest.raises(UnknownQueue):
        s.add("nope", _item())
    with pytest.raises(KeyError):
        s.add("nope", _item())


def test_weighted_fair_interleaves_tenants():
    """A deep bulk backlog cannot starve the latency queue: with weight 4
    vs 1, latency batches are served ~4x as often while both have work."""
    s = _two_queue_scheduler(w_bulk=1.0, w_lat=4.0, max_batch=1)
    for i in range(8):
        s.add("bulk", _item(seed=i), now=0.0)
        s.add("latency", _item(seed=100 + i), now=0.0)
    order = []
    while (nxt := s.next_batch()) is not None:
        order.append(nxt[0])
    assert len(order) == 16
    assert order[:5].count("latency") == 4
    assert order.index("bulk") < 6                # bulk is not starved either
    assert max(i for i, q in enumerate(order) if q == "latency") < 12


def test_fair_queue_reenters_at_service_floor():
    """A queue that was idle must not bank credit: equal weights from the
    floor alternate strictly, no latency burst."""
    s = _two_queue_scheduler(w_bulk=1.0, w_lat=1.0, max_batch=1)
    for i in range(6):
        s.add("bulk", _item(seed=i), now=0.0)
    for _ in range(4):                      # serve bulk alone for a while
        assert s.next_batch()[0] == "bulk"
    for i in range(3):
        s.add("latency", _item(seed=50 + i), now=0.0)
    order = [s.next_batch()[0] for _ in range(5)]
    assert order[:4].count("latency") == 2
    assert order[0] != order[1] and order[1] != order[2]


def test_long_idle_queue_cannot_monopolize_after_reentry():
    """A queue idle through a long stretch of service re-enters at the
    SYSTEM virtual time, even if it is the only ready queue at the instant
    it flushes."""
    s = _two_queue_scheduler(w_bulk=1.0, w_lat=16.0, max_batch=1)
    for i in range(50):
        s.add("bulk", _item(seed=i), now=0.0)
    for _ in range(50):
        assert s.next_batch()[0] == "bulk"
    for i in range(64):
        s.add("latency", _item(seed=100 + i), now=0.0)
    for i in range(50, 58):
        s.add("bulk", _item(seed=i), now=0.0)
    order = [s.next_batch()[0] for _ in range(24)]
    assert "bulk" in order[:18]
    assert order.count("latency") >= 16


def test_per_queue_deadlines_poll_independently():
    s = BatchScheduler(
        [QueueConfig("fast", max_wait_ms=1000.0, max_batch=8),
         QueueConfig("slow", max_wait_ms=5000.0, max_batch=8)])
    s.add("fast", _item(seed=1), now=0.0)
    s.add("slow", _item(seed=2), now=0.0)
    assert s.next_deadline() == pytest.approx(1.0)
    assert s.poll(now=0.5) == 0
    assert s.poll(now=1.5) == 1                 # fast expired, slow still open
    assert s.next_batch()[0] == "fast"
    assert s.open_batches == 1
    assert s.poll(now=5.5) == 1
    assert s.next_batch()[0] == "slow"


def test_flush_oldest_open_and_flush_all():
    s = _two_queue_scheduler()
    s.add("bulk", _item(seed=1), now=10.0)      # deadline 11.0  (1000 ms)
    s.add("latency", _item(seed=2), now=9.0)    # deadline 10.0
    name, pb = s.flush_oldest_open()
    assert name == "latency" and pb.num_graphs == 1
    s.add("latency", _item(seed=3), now=12.0)
    out = s.flush_all()
    assert sorted(n for n, _ in out) == ["bulk", "latency"]
    assert s.open_batches == 0 and s.pending_graphs == 0


def test_graph_pads_reflect_per_queue_max_batch():
    s = BatchScheduler([QueueConfig("a", max_batch=2),
                        QueueConfig("b", max_batch=8),
                        QueueConfig("c")], default_max_batch=8)
    assert s.graph_pads() == (2, 8)


def _preempt_scheduler(chunk=2, horizon=1.0):
    return BatchScheduler(
        [QueueConfig("bulk", max_batch=8, max_wait_ms=1000.0),
         QueueConfig("lat", max_batch=1, max_wait_ms=1000.0,
                     priority=True)],
        preempt_chunk=chunk, preempt_horizon_s=horizon)


def test_scheduler_preempt_splits_bulk_pop_only_inside_window():
    """As ``test_overload.py``'s: inside a priority tenant's window a bulk
    pop is served a chunk at a time, each chunk re-bucketed to its own
    content, the remainder readmitted pinned to the sealed bucket; after
    the window the remainder is served whole on the parent's bucket."""
    s = _preempt_scheduler()
    for i in range(8):
        s.add("bulk", _item(seed=i), now=0.0)
    name, pb = s.next_batch(now=0.0)
    assert (name, pb.num_graphs, s.preempt_splits) == ("bulk", 8, 0)
    bucket = pb.bucket

    for i in range(8):
        s.add("bulk", _item(seed=i), now=2.0)
    s.add("lat", _item(seed=99), now=2.0)          # opens the window
    name, pb = s.next_batch(now=2.0)
    assert (name, pb.num_graphs) == ("lat", 1)     # priority never split
    served, now = [], 2.0
    while True:
        s.poll(now)                                # reflush readmitted rest
        nxt = s.next_batch(now)
        if nxt is None:
            break
        served.append(nxt[1])
        now += 0.1
    assert sum(b.num_graphs for b in served) == 8  # nothing lost
    assert s.preempt_splits >= 3 and s.preempted_graphs >= 6
    assert all(b.num_graphs <= 2 for b in served)
    assert all(b.graph_pad == bucket[2] for b in served)
    assert all(b.node_pad <= bucket[0] and b.edge_pad <= bucket[1]
               for b in served)

    for i in range(8):
        s.add("bulk", _item(seed=i), now=10.0)
    s.add("lat", _item(seed=100), now=10.0)        # reopens the window
    assert s.next_batch(now=10.0)[0] == "lat"
    _, head = s.next_batch(now=10.0)
    assert head.num_graphs == 2
    s.poll(now=20.0)                               # window long expired
    _, rest = s.next_batch(now=20.0)
    assert rest.num_graphs == 6 and rest.bucket == bucket

    s2 = _preempt_scheduler()
    for i in range(8):
        s2.add("bulk", _item(seed=i), now=0.0)
    s2.add("lat", _item(seed=99), now=0.0)
    _, pb = s2.next_batch(now=0.0)
    assert (pb.num_graphs, s2.preempt_splits) == (2, 1)
    drained = s2.flush_all()                       # now=None never splits
    assert s2.preempt_splits == 1
    assert sum(b.num_graphs for _, b in drained) == 7


# ---------------------------------------------------------------------------
# engine facade: tenant queues
# ---------------------------------------------------------------------------

def test_submit_rejects_unknown_queue_and_deadlines():
    with _make_engine("gin") as eng:
        g = next(molhiv_like(seed=0, n_graphs=1))
        with pytest.raises(KeyError):
            eng.submit(*_args(g), queue="nope")
        # deadlines are served now; a budget that is not positive is refused
        with pytest.raises(InvalidRequest, match="deadline"):
            eng.submit(*_args(g), deadline=0.0)
        with pytest.raises(InvalidRequest, match="deadline"):
            eng.submit(*_args(g), deadline=-1.0)
    cfg = small_cfg("gin")
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    with pytest.raises(ValueError, match="not both"):
        GraphStreamEngine(cfg, params, device="cpu", devices=["cpu"])


def test_two_tenant_stats_and_starvation_bound():
    """With the bulk queue saturated, the latency queue's p90 stays bounded:
    its graphs jump the bulk backlog through weighted-fair draining even
    though they arrive last."""
    queues = [QueueConfig("bulk", weight=1.0, max_wait_ms=20.0, max_batch=8),
              QueueConfig("latency", weight=16.0, max_wait_ms=1.0,
                          max_batch=2)]
    graphs = list(molhiv_like(seed=0, n_graphs=24))
    with _make_engine("gin", queues=queues, eager_flush=False) as eng:
        eng.warmup(*_args(graphs[0]))
        bulk = [eng.submit(*_args(g), queue="bulk")
                for g in graphs for _ in range(3)]          # deep backlog
        lat = [eng.submit(*_args(g), queue="latency")
               for g in graphs[:8]]                          # arrives last
        eng.drain(timeout=120)
        for f in bulk + lat:
            f.result(timeout=5)
        s = eng.stats.summary()
    assert set(s["queues"]) == {"bulk", "latency"}
    sb, sl = s["queues"]["bulk"], s["queues"]["latency"]
    assert sb["count"] == 72.0 and sl["count"] == 8.0
    assert sl["p90_ms"] < sb["p90_ms"]
    assert s["count"] == 80.0
    for k in ("queue_wait_mean_ms", "queue_wait_p99_ms", "mean_batch_size",
              "aggregate_gps", "throughput_gps"):
        assert s[k] > 0, k
    assert s["mean_batch_size"] > 1


def test_same_result_from_any_queue():
    """Queue routing does not change the math: the same graph served via
    two tenants is bitwise identical (same bucket)."""
    queues = [QueueConfig("a", max_batch=1), QueueConfig("b", max_batch=1)]
    g = next(molhiv_like(seed=2, n_graphs=1))
    with _make_engine("gin", queues=queues) as eng:
        fa = eng.submit(*_args(g), queue="a")
        fb = eng.submit(*_args(g), queue="b")
        eng.drain(timeout=60)
        np.testing.assert_array_equal(fa.result(timeout=5),
                                      fb.result(timeout=5))


def test_per_queue_admission_backpressure():
    """A bulk tenant pinned at ITS max_pending cap must not block a latency
    tenant's submit(): admission backpressure is per queue."""
    queues = [QueueConfig("bulk", max_pending=1, max_batch=64,
                          max_wait_ms=10_000.0),
              QueueConfig("latency", max_batch=64, max_wait_ms=10_000.0)]
    g = next(molhiv_like(seed=0, n_graphs=1))
    with _make_engine("gin", queues=queues, eager_flush=False) as eng:
        futs = [eng.submit(*_args(g), queue="bulk")]   # bulk AT its cap

        blocked = threading.Event()

        def second_bulk():
            blocked.set()
            futs.append(eng.submit(*_args(g), queue="bulk"))  # blocks
        t = threading.Thread(target=second_bulk, daemon=True)
        t.start()
        blocked.wait(timeout=5)
        time.sleep(0.2)                            # let it reach the wait

        t0 = time.perf_counter()
        lat = eng.submit(*_args(g), queue="latency")   # must NOT block
        assert time.perf_counter() - t0 < 2.0
        eng.drain(timeout=60)                      # unblocks the bulk waiter
        t.join(timeout=60)
        assert not t.is_alive()
        eng.drain(timeout=60)
        for f in futs + [lat]:
            assert f.result(timeout=5).shape == (1,)


def test_drain_is_not_a_results_barrier():
    """Streaming futures: a submitted graph's future resolves without any
    drain() once its batch completes (flushed by its deadline)."""
    g = next(molhiv_like(seed=0, n_graphs=1))
    with _make_engine("gin", max_batch=8, max_wait_ms=5.0) as eng:
        fut = eng.submit(*_args(g))
        assert fut.result(timeout=60).shape == (1,)


def test_a_failing_batch_fails_its_futures_with_the_cause():
    """A batch whose program raises fails every one of its futures with
    ``BatchFailed`` (after its retry and bisection, ``PoisonGraph``, a
    ``BatchFailed``), the error chained; the engine keeps serving."""
    graphs = list(molhiv_like(seed=0, n_graphs=3))
    with _make_engine("gin", max_batch=2, max_wait_ms=10_000.0,
                      eager_flush=False) as eng:
        real = eng._make_run

        def boom(df):
            def run(params, graph):
                raise RuntimeError("kernel launch failed")
            return run
        eng._make_run = boom
        futs = [eng.submit(*_args(g)) for g in graphs[:2]]
        for f in futs:
            with pytest.raises(BatchFailed) as ei:
                f.result(timeout=60)
            assert isinstance(ei.value.__cause__, RuntimeError)
        assert eng.stats.failed == 2
        eng._make_run = real
        for ex in eng._executors:
            ex.compiled.clear()
        fut = eng.submit(*_args(graphs[2]))
        eng.drain(timeout=60)
        assert np.isfinite(fut.result(timeout=5)).all()


# ---------------------------------------------------------------------------
# executor death and stop
# ---------------------------------------------------------------------------

class InjectedCrash(BaseException):
    """A worker-loop death: a BaseException, which the loops do not catch
    as a batch error."""


class _Program:
    """A program that answers zeros at once (the executor's interface)."""

    def enqueue(self, pb, params):
        return pb

    def wait(self, ticket):
        return np.zeros((1, 1)), None

    def release(self, ticket):
        pass


def _bare_executor(on_complete, on_fatal=None, fault_hook=None):
    prog = _Program()
    return DeviceExecutor(
        device="cpu", index=0, params=None,
        program_fn=lambda e, key, pb: prog,
        unpack_fn=lambda pb, out: [np.zeros(1)] * pb.num_graphs,
        on_complete=on_complete,
        on_fatal=on_fatal or (lambda e, exc: None),
        fault_hook=fault_hook)


def _batch(seed=0):
    return PackedBatch(items=[_item(seed=seed)], node_pad=32, edge_pad=64,
                       graph_pad=1)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_executor_worker_death_fails_batches_and_stop_does_not_hang():
    """A worker-loop death (an escaping BaseException from the completion
    callback) resolves every held batch with an error and leaves stop()
    deadlock-free."""
    calls, fatal = [], []
    boom = [True]

    def on_complete(ex, done):
        calls.append(done)
        if boom[0]:
            boom[0] = False
            raise KeyboardInterrupt("completer dies")    # BaseException

    ex = _bare_executor(on_complete, on_fatal=lambda e, exc: fatal.append(exc))
    ex.start()
    for i in range(5):
        ex.submit("q", _batch(i))
    deadline = time.time() + 20
    while not fatal and time.time() < deadline:
        time.sleep(0.02)
    assert fatal, "fatal hook never fired"
    ex.stop(timeout=20)                       # must not deadlock
    assert len(calls) == 5                    # every batch resolved
    assert sum(d.err is not None for d in calls) >= 4
    assert ex.backlog == 0


def test_executor_dead_before_submit_fails_immediately():
    """Work placed on an executor that is already dead resolves with
    ExecutorDead right away."""
    calls = []
    ex = _bare_executor(lambda e, done: calls.append(done))
    ex.mark_dead()
    ex.submit("q", _batch())
    assert len(calls) == 1
    assert isinstance(calls[0].err, ExecutorDead)
    assert calls[0].err.executor_index == 0
    assert ex.backlog == 0
    assert not ex.has_capacity
    assert ex.stop() is False                # dead executor reports it


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_executor_completer_crash_with_staged_batches():
    """Completer death while batches sit in the depth-2 staging pipe: every
    batch resolves, stop() returns."""
    calls, fatal = [], []

    def crash_completer(site, ex, pb):
        if site == "complete":
            raise InjectedCrash("completer dies on first batch")

    ex = _bare_executor(lambda e, done: calls.append(done),
                        on_fatal=lambda e, exc: fatal.append(exc),
                        fault_hook=crash_completer)
    ex.start()
    for i in range(6):
        ex.submit("q", _batch(i))
    deadline = time.time() + 20
    while len(calls) < 6 and time.time() < deadline:
        time.sleep(0.02)
    assert ex.stop(timeout=10) is False
    assert len(calls) == 6                   # no batch stranded
    assert all(d.err is not None for d in calls)
    assert any(isinstance(exc, InjectedCrash) for exc in fatal)
    assert ex.backlog == 0
    assert ex.dead


def test_executor_stop_timeout_with_wedged_completer():
    """stop(timeout=...) returns within the budget even when the completer
    is stuck inside a long wait."""
    def stall(site, ex, pb):
        if site == "complete":
            time.sleep(5.0)

    calls = []
    ex = _bare_executor(lambda e, done: calls.append(done), fault_hook=stall)
    ex.start()
    ex.submit("q", _batch())
    time.sleep(0.2)                          # let it reach the stall
    t0 = time.time()
    assert ex.stop(timeout=0.5) is False
    assert time.time() - t0 < 5.0
    assert ex.dead


# ---------------------------------------------------------------------------
# a pool of CPU executors
# ---------------------------------------------------------------------------

def _serve_stream(name, devices, graphs):
    with _make_engine(name, max_batch=4, max_wait_ms=100.0,
                      eager_flush=False, devices=devices) as eng:
        futs = [eng.submit(*_args(g)) for g in graphs]
        eng.drain(timeout=120)
        outs = [f.result(timeout=5) for f in futs]
        return outs, eng.stats.summary()


@pytest.mark.parametrize("name", MODELS)
def test_multi_executor_serving_is_bitwise_deterministic(name):
    """The same stream on 1 vs 3 executors gives bitwise the same
    per-graph outputs, and the pool really served."""
    graphs = list(molhiv_like(seed=7, n_graphs=12))
    outs_1, _ = _serve_stream(name, ["cpu"], graphs)
    outs_n, s_n = _serve_stream(name, POOL, graphs)
    for o1, on in zip(outs_1, outs_n):
        np.testing.assert_array_equal(o1, on)
    assert len(s_n.get("devices", {})) >= 2


def test_least_backlog_placement_uses_every_executor():
    graphs = list(molhiv_like(seed=1, n_graphs=32))
    _, s = _serve_stream("gin", POOL, graphs)
    assert len(s["devices"]) == len(POOL)
    assert sum(int(d["count"]) for d in s["devices"].values()) == 32


def test_warmup_all_covers_every_executor():
    """After warmup_all, a stream served on ANY executor builds nothing."""
    with _make_engine("gin", buckets=(32, 64), max_batch=2,
                      devices=POOL) as eng:
        keys = eng.warmup_all()
        assert set(keys) == {(32, 64, 2), (64, 128, 2)}
        built = [set(k for k, _ in ex.compiled) for ex in eng._executors]
        assert all(s == set(keys) for s in built)
        programs = {k: id(p) for k, p in eng.compiled.items()}
        graphs = [g for g in molhiv_like(seed=0, n_graphs=64)
                  if 17 <= g.node_feat.shape[0] <= 30
                  and 40 <= g.senders.shape[0] <= 60][:12]
        assert len(graphs) >= 8
        futs = [eng.submit(*_args(g)) for g in graphs]
        eng.drain(timeout=120)
        for f in futs:
            f.result(timeout=5)
        assert all(set(k for k, _ in ex.compiled) == set(keys)
                   for ex in eng._executors)
        assert {k: id(p) for k, p in eng.compiled.items()} == programs


@pytest.mark.parametrize("name", MODELS)
def test_packed_stream_matches_the_reference_engine(name):
    """The port's engine and the JAX engine (unrolled) serve the same 12
    ``molhiv_like(seed=7)`` graphs packed four to a batch, on the same
    weights: every future agrees to atol = rtol = 1e-5, and both really
    packed."""
    jcfg, tcfg = small_cfg(name, JCFG), small_cfg(name)
    jp = jmake(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    graphs = list(molhiv_like(seed=7, n_graphs=12))
    kw = dict(max_batch=4, max_wait_ms=100.0, eager_flush=False)
    with JEngine(jcfg, jp, JDF(scan_layers=False), **kw) as je:
        jf = [je.submit(*_args(g)) for g in graphs]
        je.drain(timeout=300)
        ref = [f.result(timeout=5) for f in jf]
        js = je.stats.summary()
    with GraphStreamEngine(tcfg, tp, devices=["cpu"], **kw) as te:
        tf = [te.submit(*_args(g)) for g in graphs]
        te.drain(timeout=120)
        ours = [f.result(timeout=5) for f in tf]
        ts = te.stats.summary()
    for a, b in zip(ours, ref):
        assert a.shape == b.shape == (jcfg.out_dim,)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    assert js["mean_batch_size"] > 1 and ts["mean_batch_size"] > 1


def test_concurrent_submitters_stress():
    """More submitting threads than cores, the interpreter switching every
    10 us: every future resolves once to its graph's answer (bitwise: the
    plain CPU forward gives a graph the same answer in any bucket), the stats
    count every graph once, and the pending and backlog counters return
    to 0 (a lost update in any of them would break one of these)."""
    import os
    import sys
    graphs = list(molhiv_like(seed=4, n_graphs=8))
    with _make_engine("gin", devices=["cpu"]) as eng:
        ref = [eng.process(*_args(g), record=False) for g in graphs]
    n_threads = 2 * (os.cpu_count() or 4)
    futs = [[] for _ in range(n_threads)]
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _make_engine("gin", max_batch=4, max_wait_ms=1.0,
                          devices=POOL) as eng:
            def submit(k):
                for i in range(len(graphs)):
                    j = (i + k) % len(graphs)
                    futs[k].append((j, eng.submit(*_args(graphs[j]))))
            threads = [threading.Thread(target=submit, args=(k,),
                                        daemon=True)
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            eng.drain(timeout=120)
            for per_thread in futs:
                for j, f in per_thread:
                    np.testing.assert_array_equal(f.result(timeout=5),
                                                  ref[j])
            total = n_threads * len(graphs)
            assert eng.stats.summary()["count"] == float(total)
            assert eng._pending == 0 and not eng._requests
            assert all(v == 0 for v in eng._pending_by_queue.values())
            assert all(ex.backlog == 0 and ex.queued_batches == 0
                       for ex in eng._executors)
    finally:
        sys.setswitchinterval(was)


# ---------------------------------------------------------------------------
# preemption: preempted graphs resolve once, as the unloaded run
# ---------------------------------------------------------------------------

PREEMPT_QUEUES = (QueueConfig("lat", weight=8.0, max_batch=1,
                              max_wait_ms=0.25, priority=True),
                  QueueConfig("bulk", weight=1.0, max_batch=8,
                              max_wait_ms=30.0))


def test_preempted_graphs_resolve_once_and_bitwise_match_unloaded():
    """As ``test_overload.py``'s test of this name: a latency arrival opens
    a 2 s preempt window, so the bulk batch behind it is served two graphs
    at a time, each chunk re-bucketed to its own content. Every graph
    resolves exactly once (the stats count each once) and its answer is
    bitwise the unloaded run's: the port's plain CPU forward gives a graph
    the same answer at any node_pad (row-count invariant)."""
    bulk = list(sized_stream(seed=0, n_graphs=8, n_mean=12, n_std=0))
    lat = list(sized_stream(seed=1, n_graphs=1, n_mean=10, n_std=0))
    with _make_engine("gin", queues=PREEMPT_QUEUES, eager_flush=False,
                      preempt=False) as eng:
        futs = [eng.submit(*_args(g), queue="bulk") for g in bulk]
        eng.drain(timeout=60)
        base = [f.result(timeout=5) for f in futs]
        assert eng.stats.preemptions == 0
        base_buckets = {k for k, _ in eng.compiled}

    with _make_engine("gin", queues=PREEMPT_QUEUES, eager_flush=False,
                      preempt=True, preempt_chunk=2,
                      preempt_horizon_ms=2000.0) as eng:
        fl = eng.submit(*_args(lat[0]), queue="lat")
        futs = [eng.submit(*_args(g), queue="bulk") for g in bulk]
        eng.drain(timeout=60)
        outs = [f.result(timeout=5) for f in futs]
        assert np.all(np.isfinite(fl.result(timeout=5)))
        assert eng.stats.preemptions >= 1
        assert eng.stats.preemptions == eng._scheduler.preempt_splits
        assert eng.stats.summary()["count"] == 9.0     # each graph once
        chunk_buckets = {k for k, _ in eng.compiled if k[2] == 8}
    assert chunk_buckets - base_buckets        # the chunks re-bucketed
    for b, o in zip(base, outs):                   # bitwise, not allclose
        np.testing.assert_array_equal(b, o)
