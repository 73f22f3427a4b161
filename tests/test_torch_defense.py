"""Defense in depth in the port's engine (DESIGN.md §9 layers 2 and 3):
the circuit breaker with shadow audits, and hot parameter reload. The twin
of ``tests/test_defense.py``'s breaker, audit, NaN-trip and
``update_params`` tests, on the CPU.

Layer 2. A numerically broken impl (finite corruption that passes the NaN
gate) is caught by the shadow auditor, which runs each sampled batch again
on the CPU under the unfused mirror; the bucket demotes one rung, keeps
serving, and after a quiet cooldown probes the rung above. The ladder's
rungs and the served dataflow are held to the reference's; on the port's
kernel path a NaN trip or an audit demotes ``fused_layer`` to
``pipeline``, and on the CPU a program that fails to build walks the
ladder down. On the card the ladder ends at ``pipeline`` (the lowest rung
with a hand-written kernel) and a capture that raises fails its batch
(``cuda`` tests).

Layer 3. ``update_params`` swaps the weights under live traffic with no
request dropped; a failing canary rolls back and the old version keeps
serving bitwise. Programs built before the swap serve the new weights:
on the CPU the program runs the params its dispatch pinned, and on the
card (``cuda`` test) the executor copies them into the one tree of weights
its captured programs read, with no bucket captured again.
"""

import gc
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine import GraphStreamEngine as JEngine  # noqa: E402
from repro.core.message_passing import DataflowConfig as JDF  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.errors import ParamUpdateFailed  # noqa: E402
from repro_torch.core.executor import _map_tensors  # noqa: E402
from repro_torch.core.faults import FaultInjector  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn  # noqa: E402
from repro_torch.data.graphs import molhiv_like  # noqa: E402

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")

POOL = ["cpu"] * 3


def _cfg(name="gin"):
    cfg = PAPER_GNN_CONFIGS[name]
    return cfg.replace(num_layers=2, hidden_dim=16,
                       head_mlp=(8,) if cfg.head_mlp else ())


def _params(cfg, seed=0, device="cpu"):
    return make_gnn(cfg).init(torch.Generator().manual_seed(seed), cfg,
                              device=device)


def _scaled(params, factor):
    return _map_tensors(lambda t: t * factor, params)


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
    with _engine(cfg, params, **kw) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        return [f.result(timeout=5) for f in futs]


def _assert_all_resolved(futs):
    for i, f in enumerate(futs):
        assert f.done(), f"future {i} left unresolved"


def _breaker_entries(eng):
    return {k: v["breaker"] for k, v in eng.autotune_report().items()
            if "breaker" in v}


def _one_bucket_stream(n=8):
    """n copies of one graph: a deterministic single-bucket batch."""
    return [_graphs(1)[0]] * n


# ---------------------------------------------------------------------------
# the ladder itself, against the reference's
# ---------------------------------------------------------------------------

LADDER = [dict(impl=i, single_pass=sp)
          for i in ("fused_layer", "kernel", "pipeline", "banked", "fused",
                    "twopass", "unfused")
          for sp in (True, False)]


@pytest.mark.parametrize("kw", LADDER,
                         ids=[f"{k['impl']}-{k['single_pass']}"
                              for k in LADDER])
def test_ladder_rungs_match_the_reference(kw):
    ours, ref = DataflowConfig(**kw), JDF(**kw)
    assert GraphStreamEngine._impl_rung(ours) == JEngine._impl_rung(ref)
    eng = _engine(_cfg(), _params(_cfg()))
    for rung in range(5):
        got = eng._ladder_df(ours, rung)
        want = JEngine._ladder_df(JEngine, ref, rung)
        assert (got.impl, got.single_pass) == (want.impl, want.single_pass)
    eng.close()


# ---------------------------------------------------------------------------
# layer 2: circuit breaker + shadow audits
# ---------------------------------------------------------------------------

def test_audit_mismatch_demotes_exactly_one_bucket():
    cfg = _cfg()
    params = _params(cfg)
    stream_a = _one_bucket_stream(8)            # the bucket under attack
    stream_b = _graphs(8, seed=11)              # bystander traffic
    base_a = _baseline(cfg, params, stream_a)
    base_b = _baseline(cfg, params, stream_b)

    inj = FaultInjector(seed=0)
    with _engine(cfg, params, audit_sample_rate=1.0,
                 breaker_cooldown_s=3600.0,     # no re-probe in this test
                 fault_injector=inj) as eng:
        futs_b = _submit_all(eng, stream_b)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        assert not _breaker_entries(eng)
        # break the default impl, hit bucket A: finite corruption passes
        # the NaN gate; only the audit can catch it
        inj.break_impl("fused", eps=0.05)
        futs_a = _submit_all(eng, stream_a)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        inj.fix_impl("fused")
        entries = _breaker_entries(eng)
        assert len(entries) == 1, f"expected 1 demoted bucket: {entries}"
        (health,) = entries.values()
        assert health["level"] == 1
        assert health["last_reason"] == "audit_mismatch"
        assert health["serving_impl"] == "unfused"
        s = eng.stats.summary()
        assert s["audit_mismatches"] >= 1
        assert s["breaker_trips"] == 1
        assert s["audits"] >= 2
        # the demoted bucket still serves, on the mirror: bitwise the
        # fault-free run (gin's rungs are bitwise equal on the CPU)
        futs_a2 = _submit_all(eng, stream_a)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        for f, want in zip(futs_a2, base_a):
            np.testing.assert_array_equal(f.result(timeout=5), want)
        futs_b2 = _submit_all(eng, stream_b)
        eng.drain(timeout=300)
        for f, want in zip(futs_b2, base_b):
            np.testing.assert_array_equal(f.result(timeout=5), want)
        assert eng.stats.summary()["breaker_trips"] == 1
        _assert_all_resolved(futs_a + futs_b + futs_a2 + futs_b2)


def test_breaker_reprobes_after_cooldown():
    cfg = _cfg()
    params = _params(cfg)
    stream = _one_bucket_stream(8)
    base = _baseline(cfg, params, stream)

    inj = FaultInjector(seed=0).break_impl("fused", eps=0.05)
    with _engine(cfg, params, audit_sample_rate=1.0,
                 breaker_cooldown_s=0.2, fault_injector=inj) as eng:
        futs = _submit_all(eng, stream)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        assert eng.stats.breaker_trips == 1
        inj.fix_impl("fused")                   # the impl is healed
        time.sleep(0.3)                         # let the cooldown pass
        for _ in range(3):
            futs += _submit_all(eng, stream)
            eng.drain(timeout=300)
            assert eng.flush_audits(timeout=120)
        s = eng.stats.summary()
        assert s["breaker_probes"] >= 1
        (health,) = _breaker_entries(eng).values()
        assert health["level"] == 0, f"probe should have promoted: {health}"
        assert not health["probing"]
        assert health["serving_impl"] == "fused"
        futs2 = _submit_all(eng, stream)
        eng.drain(timeout=300)
        for f, want in zip(futs2, base):
            np.testing.assert_array_equal(f.result(timeout=5), want)
        _assert_all_resolved(futs + futs2)


def test_a_probe_of_a_still_broken_impl_demotes_again():
    """After the cooldown the probe serves the broken rung again: its
    forced audit mismatches and the bucket goes back down; the probes are
    bounded by ``breaker_max_probes``."""
    cfg = _cfg()
    params = _params(cfg)
    stream = _one_bucket_stream(8)
    inj = FaultInjector(seed=0).break_impl("fused", eps=0.05)
    with _engine(cfg, params, audit_sample_rate=1.0, breaker_cooldown_s=0.1,
                 breaker_max_probes=1, fault_injector=inj) as eng:
        for _ in range(5):
            _submit_all(eng, stream)
            eng.drain(timeout=300)
            assert eng.flush_audits(timeout=120)
            time.sleep(0.15)
        (health,) = _breaker_entries(eng).values()
        assert health["probes"] == 1
        assert health["level"] == 1
        assert health["serving_impl"] == "unfused"
        assert eng.stats.breaker_trips == 2


def test_nan_gate_trips_breaker():
    cfg = _cfg()
    params = _params(cfg)
    graphs = _graphs(8)
    inj = FaultInjector(seed=0).nan_request(2)
    with _engine(cfg, params, fault_injector=inj) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        assert futs[2].exception() is not None     # quarantined
        assert all(f.exception() is None
                   for i, f in enumerate(futs) if i != 2)
        s = eng.stats.summary()
        assert s["quarantined_graphs"] == 1
        assert s["breaker_trips"] == 1             # NaN gate demoted a rung
        entries = _breaker_entries(eng)
        assert any(v["last_reason"] == "nan_gate" for v in entries.values())


def test_breaker_disabled_knob():
    cfg = _cfg()
    params = _params(cfg)
    inj = FaultInjector(seed=0).nan_request(2)
    with _engine(cfg, params, breaker=False, fault_injector=inj) as eng:
        futs = _submit_all(eng, _graphs(8))
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        assert eng.stats.breaker_trips == 0
        assert not _breaker_entries(eng)


def test_kernel_path_demotes_fused_layer_to_pipeline():
    """The port's rung 0: a NaN trip on a ``fused_layer`` bucket rebuilds
    it on ``pipeline`` (one program more, none for the retries), whose
    answers agree with rung 0's; an audit of a broken ``fused_layer``
    demotes the same way, and after ``fix_impl`` a probe brings the bucket
    back to ``fused_layer``."""
    cfg = _cfg()
    params = _params(cfg)
    graphs = _graphs(8)
    df = DataflowConfig(impl="fused_layer")
    base = _baseline(cfg, params, graphs, dataflow=df)
    inj = FaultInjector(seed=0).nan_request(3)
    with _engine(cfg, params, dataflow=df, fault_injector=inj,
                 breaker_cooldown_s=3600.0) as eng:   # no probe here
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        assert isinstance(futs[3].exception(), tengine.PoisonGraph)
        (health,) = _breaker_entries(eng).values()
        assert (health["level"], health["serving_impl"]) == (1, "pipeline")
        assert not eng.compiled                    # dropped, not rebuilt
        again = _submit_all(eng, graphs[:3] + graphs[4:])
        eng.drain(timeout=300)
        (health,) = _breaker_entries(eng).values()
        assert health["serving_impl"] == "pipeline"
        assert len(eng.compiled) == 1
        for f, want in zip(again, base[:3] + base[4:]):
            np.testing.assert_allclose(f.result(timeout=5), want,
                                       rtol=1e-5, atol=1e-5)

    inj = FaultInjector(seed=0).break_impl("fused_layer", eps=0.05)
    with _engine(cfg, params, dataflow=df, fault_injector=inj,
                 audit_sample_rate=1.0, breaker_cooldown_s=0.1) as eng:
        _submit_all(eng, graphs)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        (health,) = _breaker_entries(eng).values()
        assert health["last_reason"] == "audit_mismatch"
        assert health["level"] == 1
        inj.fix_impl("fused_layer")
        time.sleep(0.15)
        for _ in range(3):
            _submit_all(eng, graphs)
            eng.drain(timeout=300)
            assert eng.flush_audits(timeout=120)
        (health,) = _breaker_entries(eng).values()
        assert (health["level"], health["probing"]) == (0, False)
        assert health["serving_impl"] == "fused_layer"


def test_the_cards_ladder_ends_at_the_pipeline():
    """On a GPU the floor is ``pipeline``, the lowest rung that runs a
    hand-written kernel (an engine on the CPU stands for it here with the
    card's floor): three NaN trips in one bucket demote it once, the
    later two are recorded and leave it on ``pipeline``."""
    cfg = _cfg()
    params = _params(cfg)
    graphs = _one_bucket_stream()
    inj = FaultInjector(seed=0).nan_request(2).nan_request(10)
    inj.nan_request(18)
    df = DataflowConfig(impl="fused_layer")
    with _engine(cfg, params, dataflow=df, fault_injector=inj,
                 breaker_cooldown_s=3600.0) as eng:
        assert eng._floor == tengine._JNP_RUNG
        eng._floor = tengine._KERNEL_RUNG
        for rung in range(5):
            assert eng._ladder_df(df, rung).impl == (
                "fused_layer" if rung == 0 else "pipeline")
        for _ in range(3):
            futs = _submit_all(eng, graphs)
            eng.drain(timeout=300)
            _assert_all_resolved(futs)
        (health,) = _breaker_entries(eng).values()
        assert (health["level"], health["serving_impl"]) == (1, "pipeline")
        assert health["last_reason"] == "nan_gate"
        (ledger,) = eng._bucket_health.values()
        assert ledger.trips == 3
        assert eng.stats.breaker_trips == 1
        assert eng.stats.summary()["quarantined_graphs"] == 3


def test_the_collector_stays_off_until_the_last_capture_leaves():
    """Two captures that overlap (two engines' threads): the collector is
    process-wide, so it comes back on only when the second one leaves."""
    assert gc.isenabled()
    entered, leave = threading.Event(), threading.Event()

    def other():
        with tengine._no_gc():
            entered.set()
            leave.wait(10)
    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(10)
    with tengine._no_gc():
        assert not gc.isenabled()
    assert not gc.isenabled()          # the other capture is still open
    leave.set()
    t.join(10)
    assert gc.isenabled()


def test_a_rung_that_fails_to_build_walks_down_the_ladder(monkeypatch):
    """A program that fails to build trips the breaker (``build_failure``)
    and the next rung down is built and serves."""
    cfg = _cfg()
    params = _params(cfg)
    real = tengine.EagerProgram

    class Refuses(real):
        def __init__(self, run, *a, **kw):
            if run.df_impl == "fused_layer":
                raise RuntimeError("no kernel image for this device")
            super().__init__(run, *a, **kw)
    make_run = GraphStreamEngine._make_run

    def tagged(self, df):
        run = make_run(self, df)
        run.df_impl = df.impl
        return run
    monkeypatch.setattr(tengine, "EagerProgram", Refuses)
    monkeypatch.setattr(GraphStreamEngine, "_make_run", tagged)
    graphs = _graphs(4)
    # no probe may promote the bucket back before the checks: a first
    # forward slower than the default 1 s cooldown would open one
    with _engine(cfg, params, dataflow=DataflowConfig(impl="fused_layer"),
                 max_batch=4, breaker_cooldown_s=3600.0) as eng:
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        assert all(f.exception() is None for f in futs)
        (health,) = _breaker_entries(eng).values()
        assert health["last_reason"].startswith("build_failure")
        assert health["serving_impl"] == "pipeline"
        assert eng.stats.breaker_trips == 1


# ---------------------------------------------------------------------------
# layer 3: hot parameter reload
# ---------------------------------------------------------------------------

def test_update_params_under_live_traffic():
    cfg = _cfg()
    params = _params(cfg)
    params2 = _scaled(params, 1.01)
    graphs = _graphs(24)
    g = graphs[0]
    with _engine(cfg, params) as eng:
        futs = _submit_all(eng, graphs)         # in flight on v0
        version = eng.update_params(params2)    # swap mid-stream
        assert version == 1
        futs += _submit_all(eng, graphs)        # lands on v1
        eng.drain(timeout=300)
        _assert_all_resolved(futs)
        assert all(f.exception() is None for f in futs)
        assert eng.stats.param_updates == 1
        post = eng.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                           g.node_pos)
    with _engine(cfg, params2) as fresh:
        want = fresh.process(g.node_feat, g.senders, g.receivers,
                             g.edge_feat, g.node_pos)
    np.testing.assert_array_equal(post, want)


def test_update_params_changes_what_built_programs_serve():
    """Every bucket's program is built BEFORE the swap; after it the same
    programs (no rebuild) serve the new weights: bitwise what an engine
    built with them serves, and not what they served before. On a pool of
    three executors each executor holds its own replica."""
    cfg = _cfg()
    params = _params(cfg)
    params2 = _params(cfg, seed=1)
    graphs = _graphs(16)
    before = _baseline(cfg, params, graphs, devices=POOL)
    want = _baseline(cfg, params2, graphs, devices=POOL)
    with _engine(cfg, params, devices=POOL) as eng:
        reps = [ex.params for ex in eng._executors]
        assert len({id(r["node_enc"]["w"]) for r in reps}) == 3
        futs = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        built = {k: id(p) for k, p in eng.compiled.items()}
        assert built
        assert eng.update_params(params2) == 1
        futs2 = _submit_all(eng, graphs)
        eng.drain(timeout=300)
        assert {k: id(p) for k, p in eng.compiled.items()} == built
        assert all(ex.params_version == 1 for ex in eng._executors)
    for f, w in zip(futs + futs2, before + want):
        np.testing.assert_array_equal(f.result(timeout=5), w)
    assert any(not np.array_equal(b, w) for b, w in zip(before, want))


def test_update_params_canary_rollback():
    cfg = _cfg()
    params = _params(cfg)
    g = _graphs(1)[0]
    with _engine(cfg, params) as eng:
        before = eng.process(g.node_feat, g.senders, g.receivers,
                             g.edge_feat, g.node_pos)
        bad = _map_tensors(lambda t: torch.full_like(t, np.nan),
                                   params)
        with pytest.raises(ParamUpdateFailed):
            eng.update_params(bad)
        one_nan = _map_tensors(torch.clone, params)
        one_nan["node_enc"]["w"][0, 0] = float("nan")
        with pytest.raises(ParamUpdateFailed):
            eng.update_params(one_nan)
        assert eng.stats.param_rollbacks == 2
        assert eng.stats.param_updates == 0
        after = eng.process(g.node_feat, g.senders, g.receivers,
                            g.edge_feat, g.node_pos)
        np.testing.assert_array_equal(before, after)


def test_update_params_rejects_incompatible_tree():
    cfg = _cfg()
    params = _params(cfg)
    with _engine(cfg, params) as eng:
        reshaped = _map_tensors(
            lambda t: t.unsqueeze(0).repeat(2, *([1] * t.dim())), params)
        with pytest.raises(ParamUpdateFailed):
            eng.update_params(reshaped)
        with pytest.raises(ParamUpdateFailed):
            eng.update_params({"wrapped": params})
        as_f64 = _map_tensors(lambda t: t.double(), params)
        with pytest.raises(ParamUpdateFailed):
            eng.update_params(as_f64)
        assert eng.stats.param_rollbacks == 3
        g = _graphs(1)[0]
        out = eng.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                          g.node_pos)
        assert np.all(np.isfinite(out))


def test_respawn_after_an_update_pins_the_current_version():
    cfg = _cfg()
    params = _params(cfg)
    params2 = _params(cfg, seed=1)
    graphs = _graphs(4)
    want = _baseline(cfg, params2, graphs, max_batch=2)
    inj = FaultInjector(seed=0)
    with _engine(cfg, params, max_batch=2, fault_injector=inj,
                 respawn_executors=True) as eng:
        eng.update_params(params2)
        inj.kill_executor(0, after_batches=0)
        _submit_all(eng, graphs[:2])
        deadline = time.time() + 60
        while eng.stats.respawns < 1 and time.time() < deadline:
            time.sleep(0.02)
        assert eng._executors[0].params_version == 1
        later = _submit_all(eng, graphs[2:])
        eng.drain(timeout=300)
        for f, w in zip(later, want[2:]):
            np.testing.assert_array_equal(f.result(timeout=5), w)


# ---------------------------------------------------------------------------
# acceptance: all three layers in one engine (1 and 3 executors)
# ---------------------------------------------------------------------------

def _e2e_defense(cfg, params, **engine_kw):
    from repro_torch.core.errors import InvalidGraph
    graphs = _graphs(24)
    victims = {3, 10}
    clean = [g for i, g in enumerate(graphs) if i not in victims]
    base = _baseline(cfg, params, clean, **engine_kw)

    inj = FaultInjector(seed=5)
    for v in victims:
        inj.bad_input_request(v)
    inj.break_impl("fused", eps=0.05)
    rejected, futs = [], []
    with _engine(cfg, params, require_finite=True, audit_sample_rate=1.0,
                 breaker_cooldown_s=3600.0, fault_injector=inj,
                 **engine_kw) as eng:
        for i, g in enumerate(graphs):
            try:
                futs.append(eng.submit(g.node_feat, g.senders, g.receivers,
                                       g.edge_feat, g.node_pos))
            except InvalidGraph as exc:
                assert exc.request_ids
                rejected.append(i)
        eng.drain(timeout=300)
        assert eng.flush_audits(timeout=120)
        s = eng.stats.summary()
        assert sorted(rejected) == sorted(victims)
        assert s["invalid_graphs"] == len(victims)
        assert s["audit_mismatches"] >= 1
        assert s["breaker_trips"] >= 1
        inj.fix_impl("fused")
        copy = _map_tensors(torch.clone, params)
        assert eng.update_params(copy) == 1
        futs2 = [eng.submit(g.node_feat, g.senders, g.receivers,
                            g.edge_feat, g.node_pos)
                 for i, g in enumerate(graphs) if i not in victims]
        eng.drain(timeout=300)
        _assert_all_resolved(futs + futs2)
        assert all(f.exception() is None for f in futs + futs2)
        assert eng.stats.param_updates == 1
        results = [f.result(timeout=5) for f in futs2]
    for got, want in zip(results, base):
        np.testing.assert_array_equal(got, want)


def test_defense_e2e_single_device():
    cfg = _cfg()
    _e2e_defense(cfg, _params(cfg))


def test_defense_e2e_multi_executor():
    cfg = _cfg()
    _e2e_defense(cfg, _params(cfg), devices=POOL)


# ---------------------------------------------------------------------------
# the card: a captured program serves the new weights
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_update_params_changes_what_captured_programs_serve():
    """GIN ``fused_layer`` at the paper config: every bucket captured
    before the swap; after ``update_params`` the same captured programs
    (no capture; the executor copies the new weights once into the one
    tree they all read) serve the new weights,
    bitwise the eager forward under them (deterministic algorithms), and
    a canary with a NaN leaf leaves the answers bitwise unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _cuda_update_case()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.cuda
def test_cuda_a_capture_that_raises_fails_its_batch(monkeypatch):
    """On the card a program that fails to build (a kernel that does not
    build or launch) fails its batch and trips nothing: no lower rung, and
    no plain PyTorch, serves in its place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    class Refuses(tengine.CapturedProgram):
        def __init__(self, *a, **kw):
            raise RuntimeError("no kernel image for this device")
    monkeypatch.setattr(tengine, "CapturedProgram", Refuses)
    cfg = _cfg()
    g = _graphs(1)[0]
    with GraphStreamEngine(cfg, _params(cfg, device="cuda"),
                           DataflowConfig(impl="fused_layer"),
                           device="cuda", max_retries=0) as eng:
        fut = eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat,
                         g.node_pos)
        eng.drain(timeout=300)
        assert "no kernel image" in repr(fut.exception(timeout=5).__cause__)
        assert eng.stats.breaker_trips == 0
        assert not _breaker_entries(eng)
        assert not eng.compiled


@pytest.mark.cuda
def test_cuda_nan_trips_stop_at_the_pipeline():
    """On the card three NaN trips in one ``fused_layer`` bucket leave it
    on ``pipeline`` (``mp_pipeline``), never on a plain rung."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = _cfg()
    graphs = _one_bucket_stream()
    inj = FaultInjector(seed=0).nan_request(2).nan_request(10)
    inj.nan_request(18)
    with GraphStreamEngine(cfg, _params(cfg, device="cuda"),
                           DataflowConfig(impl="fused_layer"),
                           device="cuda", max_batch=8, max_wait_ms=200.0,
                           eager_flush=False, fault_injector=inj,
                           breaker_cooldown_s=3600.0) as eng:
        for _ in range(3):
            futs = _submit_all(eng, graphs)
            eng.drain(timeout=300)
            _assert_all_resolved(futs)
        (health,) = _breaker_entries(eng).values()
        assert (health["level"], health["serving_impl"]) == (1, "pipeline")
        assert eng.stats.breaker_trips == 1
        assert eng.stats.summary()["quarantined_graphs"] == 3


def _cuda_update_case():
    from repro_torch.core.graph import build_graph_batch, pad_bucket
    cfg = PAPER_GNN_CONFIGS["gin"]
    params = _params(cfg, device="cuda")
    params2 = _params(cfg, seed=1, device="cuda")
    graphs = _graphs(16)
    df = DataflowConfig(impl="fused_layer")
    eng = GraphStreamEngine(cfg, params, df, device="cuda")

    def serve():                 # each graph alone in its bucket
        return [eng.process(g.node_feat, g.senders, g.receivers,
                            g.edge_feat, g.node_pos) for g in graphs]
    before = serve()
    built = {k: id(p) for k, p in eng.compiled.items()}
    assert all(isinstance(p, tengine.CapturedProgram)
               for p in eng.compiled.values())
    eng.update_params(params2)
    after = serve()
    assert {k: id(p) for k, p in eng.compiled.items()} == built
    (ex,) = eng._executors
    assert (ex.swaps, ex.resident_version) == (1, 1)
    assert all(p.params is ex.resident for p in eng.compiled.values())
    model = make_gnn(cfg)
    for g, b, got in zip(graphs, before, after):
        batch = build_graph_batch(
            g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
            node_pos=g.node_pos,
            node_pad=pad_bucket(g.node_feat.shape[0], eng.buckets),
            edge_pad=pad_bucket(g.senders.shape[0], eng.buckets),
            graph_pad=8, pos_dim=cfg.pos_dim, device="cuda")
        with torch.inference_mode():
            want = model.apply(params2, batch, cfg, df).cpu().numpy()[0]
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(b, got)
    nan = _map_tensors(torch.clone, params2)
    nan["node_enc"]["w"][0, 0] = float("nan")
    with pytest.raises(ParamUpdateFailed):
        eng.update_params(nan)
    for a, again in zip(after, serve()):
        np.testing.assert_array_equal(again, a)
    eng.close(timeout=60)


@pytest.mark.cuda
def test_cuda_the_collector_is_off_while_a_bucket_is_captured(monkeypatch):
    """A cyclic collection on the capturing thread may free a dead engine's
    captured graph inside the capture, which the capture forbids: it then
    fails and leaves its pool recording. The engine captures with the
    collector off (and on again after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import gc
    seen = []
    make_run = GraphStreamEngine._make_run

    def watched(self, df):
        run = make_run(self, df)

        def inner(params, graph):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            return run(params, graph)
        return inner
    monkeypatch.setattr(GraphStreamEngine, "_make_run", watched)
    cfg = PAPER_GNN_CONFIGS["gin"]
    g = _graphs(1)[0]
    with GraphStreamEngine(cfg, _params(cfg, device="cuda"),
                           DataflowConfig(impl="fused_layer"),
                           device="cuda") as eng:
        out = eng.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                          g.node_pos)
    assert seen == [False] and gc.isenabled()
    assert np.isfinite(out).all()
