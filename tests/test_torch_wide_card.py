"""Wide placement on the card: the engine's gang of four executors on one
H100 serving graphs over its largest bucket through one captured wide
program (``CapturedWideProgram``), beside narrow traffic.

This file imports no JAX (the machine with the card has none): the answers
are held to the port's own eager single-device forward on the card. It
skips where there is no card; ``tests/test_torch_wide.py`` holds the CPU
twins against the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import models as TM  # noqa: E402
from repro_torch.core.engine import GraphStreamEngine  # noqa: E402
from repro_torch.core.graph import build_graph_batch as tbuild  # noqa: E402
from repro_torch.core.graph import pad_bucket  # noqa: E402
from repro_torch.core.message_passing import DataflowConfig  # noqa: E402
from repro_torch.data.graphs import mesh_like  # noqa: E402

WAIT_S = 300.0


def _mesh_graph(n, seed):
    return next(mesh_like(seed=seed, n_graphs=1, n_nodes=n, node_dim=8,
                          edge_dim=1))


def _small_cfg():
    return TM.GNNConfig(model="gin", num_layers=3, hidden_dim=16,
                        node_feat_dim=8, edge_feat_dim=1, out_dim=4)


def _params(cfg, device):
    return TM.make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                 device=device)


@pytest.mark.cuda
def test_cuda_engine_gang_serves_oversized_graph():
    """``chip_smoke.py`` phase 4f (a)'s engine at a small size: four
    executors on one card, GIN ``fused_layer`` (3 layers, hidden 16),
    graphs over the largest bucket (512) through one captured wide
    program, beside narrow traffic; answers within 1e-5 of the eager
    single-device forward at the 1024 bucket on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _small_cfg()
    params = _params(cfg, device="cuda")
    df = DataflowConfig(impl="fused_layer")
    graphs = ([_mesh_graph(n=900 + 80 * (i % 2), seed=20 + i)
               for i in range(4)]
              + [_mesh_graph(n=48, seed=40 + i) for i in range(4)])
    with GraphStreamEngine(cfg, params, df,
                           buckets=(32, 64, 128, 256, 512), wide=True,
                           wide_k=4, devices=["cuda"] * 4) as eng:
        futs = [eng.submit(g.node_feat, g.senders, g.receivers, g.edge_feat)
                for g in graphs]
        eng.drain(timeout=WAIT_S)
        outs = [f.result(timeout=WAIT_S) for f in futs]
        (prog,) = eng._wide_programs.values()
        assert type(prog).__name__ == "CapturedWideProgram"
        assert eng.edge_passes[("wide", 4, 512, 1024)] == 3
    for g, out in zip(graphs, outs):
        n, e = g.node_feat.shape[0], g.senders.shape[0]
        b = tbuild(g.node_feat, g.senders, g.receivers,
                   edge_feat=g.edge_feat, node_pad=pad_bucket(n),
                   edge_pad=pad_bucket(e), device="cuda")
        with torch.inference_mode():
            ref = TM.make_gnn(cfg).apply(params, b, cfg, df).cpu().numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(out - ref[0]).max()) <= 1e-5 * scale
