"""The port's examples, driven at small n on the CPU.

``examples/quickstart_torch.py::flowgnn_demo`` and the four functions of
``examples/gnn_streaming_torch.py`` run as a user runs them, with
``device="cpu"``: every graph answered, the engine's first answer within
the reference's sparse-vs-dense tolerance (1e-4) of the port's dense
oracle, every future resolved, both tenants served. The reference's own
example drives the same calls on its engine. ``quickstart_torch.py::
lm_demo`` takes one gradient of reduced llama3-8b's loss, and
``examples/train_lm_torch.py`` trains its small config for a few steps
with a restart from the checkpoint halfway.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data.graphs import hep_like, molhiv_like  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def streaming():
    return _load("gnn_streaming_torch")


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: beside the suite's other workers,
    torch's default of a thread per core in every worker oversubscribes
    the cores, and a training loop's many small ops then ran 20-35x slower
    than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_serves_every_graph():
    stats = _load("quickstart_torch").flowgnn_demo(n_graphs=4, device="cpu")
    assert stats["count"] == 4 and stats["p50_ms"] > 0


@pytest.mark.parametrize("model,gen,n", [("gin", molhiv_like, 3),
                                         ("gat", molhiv_like, 3),
                                         ("gin", hep_like, 2)])
def test_stream_matches_the_dense_oracle(streaming, model, gen, n):
    s = streaming.stream(model, gen, gen.__name__, n, device="cpu")
    assert s["count"] == n
    assert s["dense_err"] <= streaming.DENSE_TOL and s["dense_ms"] > 0


def test_stream_packed_resolves_every_future(streaming):
    s = streaming.stream_packed("gin", 10, max_batch=4, device="cpu")
    assert s["resolved"] == 10 and s["count"] == 10
    assert s["mean_batch_size"] > 1


def test_two_tenants_are_both_served(streaming):
    s = streaming.stream_two_tenants("gin", 4, device="cpu")
    assert s["queues"]["bulk"]["count"] == 12
    assert s["queues"]["latency"]["count"] == 4


def test_time_fn_is_a_median_of_wall_seconds(streaming):
    calls = []
    t = streaming.time_fn(lambda: calls.append(1), device=torch.device("cpu"),
                          warmup=1, iters=3)
    assert len(calls) == 4 and 0 <= t < 1 and np.isfinite(t)


def test_quickstart_lm_demo_takes_a_gradient():
    """``lm_demo``: a finite loss near log(vocab) at random weights and a
    positive gradient norm."""
    out = _load("quickstart_torch").lm_demo(device="cpu")
    assert 0 < out["loss"] < 2 * np.log(512) and out["grad_norm"] > 0


def test_train_lm_trains_and_resumes(tmp_path, one_thread):
    """``train_lm_torch.py`` at its small config, 30 steps of (8, 64): a
    restart at step 15 resumes from the checkpoint written there, and the
    loss falls across it."""
    out = _load("train_lm_torch").train(steps=30, batch=8, seq=64,
                                        ckpt_dir=str(tmp_path),
                                        device="cpu")
    assert out["resumed"] and out["resumed_at"] == 15
    assert len(out["first"]) == 15 and len(out["second"]) == 15
    assert out["second"][-1] < out["first"][0]
