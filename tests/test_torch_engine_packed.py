"""Packed serving on the card: the executor's pipe, its ring of pinned
slots and a capture while a batch is in flight (``cuda`` tests; they skip
where there is no NVIDIA GPU).

Each answer is held to the same graph served alone in the same bucket by
the eager forward (``build_graph_batch`` + ``model.apply`` at the bucket's
pads): bitwise under torch's deterministic algorithms (``index_add_``
without atomics), and within ``EAGER_RTOL`` = 1e-5 relative to
max(1, |ref|) as served, where the readout's ``index_add_`` adds with
atomics in an order that changes from run to run.
"""

import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core.graph import build_graph_batch  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.core.models import PAPER_GNN_CONFIGS  # noqa: E402
from repro_torch.core.models import make_gnn  # noqa: E402
from repro_torch.core.scheduler import QueueConfig  # noqa: E402
from repro_torch.data.graphs import hep_like, molhiv_like  # noqa: E402

EAGER_RTOL = 1e-5


@pytest.fixture(params=[True, False], ids=["deterministic", "as_served"])
def card(request):
    """The card, TF32 off, with torch's deterministic algorithms on or off
    while the test runs; yields whether they are on. ``warn_only``: cuBLAS
    asks for a workspace setting these tests do not make."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(request.param, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield request.param
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _args(g):
    return g.node_feat, g.senders, g.receivers, g.edge_feat, g.node_pos


def _engine(name="gin", **kw):
    cfg = PAPER_GNN_CONFIGS[name]
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cuda")
    return tengine.GraphStreamEngine(
        cfg, params, DataflowConfig(impl="fused_layer"), device="cuda",
        eager_flush=False, max_wait_ms=10_000.0, **kw)


def _served(eng, graphs, queues=None):
    """Submit ``graphs`` (to ``queues[i]`` when given), drain; each graph's
    answer and the bucket its batch was served in."""
    buckets = {}
    real = eng._handle_completion

    def record(ex, done):
        for it in done.batch.items:
            buckets[it.payload.req_id] = done.batch.bucket
        real(ex, done)
    eng._handle_completion = record
    for ex in eng._executors:
        ex._on_complete = record
    futs = [eng.submit(*_args(g), queue=None if queues is None else q)
            for g, q in zip(graphs, queues or [None] * len(graphs))]
    eng.drain(timeout=300)
    outs = [f.result(timeout=5) for f in futs]
    ids = sorted(buckets)
    return outs, [buckets[i] for i in ids[-len(graphs):]]


def _alone(eng, g, bucket):
    """``g`` alone in ``bucket`` through the eager forward on the card."""
    node_pad, edge_pad, graph_pad = bucket
    batch = build_graph_batch(
        g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
        node_pos=g.node_pos, node_pad=node_pad, edge_pad=edge_pad,
        graph_pad=graph_pad, pos_dim=eng.cfg.pos_dim, device="cuda")
    with torch.inference_mode():
        out = eng.model.apply(eng.params, batch, eng.cfg, eng.dataflow)
    return out.cpu().numpy()[0]


def _check(eng, graphs, outs, buckets, deterministic):
    for i, (g, o, b) in enumerate(zip(graphs, outs, buckets)):
        ref = _alone(eng, g, b)
        if deterministic:
            np.testing.assert_array_equal(o, ref, err_msg=f"graph {i} {b}")
        else:
            rel = float(np.abs(o - ref).max()) / max(
                1.0, float(np.abs(ref).max()))
            assert rel <= EAGER_RTOL, (i, b, rel)


class _InFlight:
    """Counts the captured programs' batches enqueued whose copy-out has not
    been waited for yet (batches in flight on the card), and the most seen
    at once."""

    def __init__(self, monkeypatch):
        self.now = self.most = self.enqueued = 0
        self.lock = threading.Lock()
        enqueue = tengine.CapturedProgram.enqueue
        wait = tengine.CapturedProgram.wait

        def counted_enqueue(prog, pb, params):
            ticket = enqueue(prog, pb, params)
            with self.lock:
                self.now += 1
                self.enqueued += 1
                self.most = max(self.most, self.now)
            return ticket

        def counted_wait(prog, ticket):
            out = wait(prog, ticket)
            with self.lock:
                self.now -= 1
            return out
        monkeypatch.setattr(tengine.CapturedProgram, "enqueue",
                            counted_enqueue)
        monkeypatch.setattr(tengine.CapturedProgram, "wait", counted_wait)


@pytest.mark.cuda
def test_cuda_two_buckets_interleaved_in_flight(card, monkeypatch):
    """Two queues of other max_batch (two buckets, one executor) submitted
    in turns, each replay made to run ~1 ms on the card (a spin before it,
    so that the host enqueues faster than the card serves): batches of both
    buckets are in flight together (up to the pipe's depth), and every
    answer is the graph's alone in its bucket."""
    queues = [QueueConfig("a", max_batch=2), QueueConfig("b", max_batch=4)]
    eng = _engine(queues=queues)
    graphs = list(molhiv_like(seed=3, n_graphs=36))
    names = ["a" if (i // 2) % 3 == 0 else "b" for i in range(36)]
    _served(eng, graphs[:6], names[:6])              # build both programs
    replay = tengine.CapturedProgram.replay

    def slow(prog, slot):
        torch.cuda._sleep(2_000_000)
        replay(prog, slot)
    monkeypatch.setattr(tengine.CapturedProgram, "replay", slow)
    flight = _InFlight(monkeypatch)
    outs, buckets = _served(eng, graphs, names)
    assert {b[2] for b in buckets} == {2, 4}
    assert flight.most >= 2, flight.most
    _check(eng, graphs, outs, buckets, card)
    eng.close(timeout=60)


@pytest.mark.cuda
def test_cuda_new_bucket_captured_while_a_batch_is_in_flight(card,
                                                             monkeypatch):
    """A batch of a built bucket is made to run long on the card (a spin
    before its replay); a batch of a new bucket arrives behind it. The new
    program is built only after the executor's pipe has drained: the
    dispatch thread enters ``quiesce`` with the first batch unfinished and
    leaves it with none. Both answers are the graphs' alone."""
    eng = _engine(max_batch=2)
    ex = eng._executors[0]
    mols = list(molhiv_like(seed=5, n_graphs=2))
    knn = list(hep_like(seed=2, n_graphs=2))
    _served(eng, mols)                               # the first bucket
    seen = []
    quiesce = ex.quiesce

    def recorded():
        seen.append(ex._unfinished)
        quiesce()
        seen.append(ex._unfinished)
    monkeypatch.setattr(ex, "quiesce", recorded)
    replay = tengine.CapturedProgram.replay

    def slow(prog, slot):
        torch.cuda._sleep(200_000_000)               # ~0.1 s of the card
        replay(prog, slot)
    (built,) = ex.compiled.values()
    monkeypatch.setattr(built, "replay", lambda slot: slow(built, slot))
    outs, buckets = _served(eng, mols + knn)
    assert seen[:2] == [1, 0], seen
    assert len(ex.compiled) == 2
    _check(eng, mols + knn, outs, buckets, card)
    eng.close(timeout=60)


@pytest.mark.cuda
def test_cuda_ring_slots_wrap_three_times(card, monkeypatch):
    """One bucket (every batch pads to 1024 nodes and edges) serves 14
    batches of other graphs: its ring of ``CapturedProgram.SLOTS`` pinned
    slots comes round more than three times, and each answer is its
    graph's alone, so no batch read another's slot."""
    eng = _engine(max_batch=2, buckets=(1024,))
    graphs = list(molhiv_like(seed=9, n_graphs=28))
    flight = _InFlight(monkeypatch)
    outs, buckets = _served(eng, graphs)
    assert set(buckets) == {(1024, 1024, 2)}
    assert len(eng.compiled) == 1
    assert flight.enqueued >= 3 * tengine.CapturedProgram.SLOTS + 1
    _check(eng, graphs, outs, buckets, card)
    eng.close(timeout=60)
