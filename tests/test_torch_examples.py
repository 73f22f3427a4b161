"""The port's examples, driven at small n on the CPU.

``examples/quickstart_torch.py::flowgnn_demo`` and the four functions of
``examples/gnn_streaming_torch.py`` run as a user runs them, with
``device="cpu"``: every graph answered, the engine's first answer within
the reference's sparse-vs-dense tolerance (1e-4) of the port's dense
oracle, every future resolved, both tenants served. The reference's own
example drives the same calls on its engine.
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
