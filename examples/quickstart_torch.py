"""Quickstart for the PyTorch port: FlowGNN's streaming inference on a GPU,
then one gradient of the LM substrate's loss.

The twin of ``examples/quickstart.py``. ``flowgnn_demo``: a GIN at the
paper's config (5 layers, width 100, Eq. 1) served by the port's real-time
engine, 20 raw COO molecules streamed through ``process`` at batch size 1,
in arrival order and with no preprocessing, then the latency stats. The
engine runs the port's main path, ``impl="fused_layer"``: one
``layer_fused`` kernel launch per layer on the card. ``lm_demo``: the loss
of reduced llama3-8b on a random batch and its gradient's global norm,
through the flash attention kernel and its backward on the card.

Run (from the root of a checkout):
    PYTHONPATH=src python examples/quickstart_torch.py                # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # CPU
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.archs import REDUCED
from repro_torch.core.engine import GraphStreamEngine
from repro_torch.core.message_passing import DataflowConfig
from repro_torch.core.models import PAPER_GNN_CONFIGS, make_gnn
from repro_torch.data.graphs import molhiv_like
from repro_torch.models import lm
from repro_torch.optim.optimizers import global_norm, tree_leaves


def flowgnn_demo(n_graphs: int = 20, device=None) -> dict:
    """Serve ``n_graphs`` molhiv-like graphs with the paper's GIN (weights
    from ``torch.Generator().manual_seed(0)``) on ``device`` (the card by
    default); returns the engine's stats summary."""
    print("=== FlowGNN streaming inference (paper scenario) ===")
    cfg = PAPER_GNN_CONFIGS["gin"]          # 5 layers, dim 100, Eq. (1)
    params = make_gnn(cfg).init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    graphs = list(molhiv_like(seed=0, n_graphs=n_graphs))
    with GraphStreamEngine(cfg, params, DataflowConfig(impl="fused_layer"),
                           device=device) as engine:
        g0 = graphs[0]
        engine.warmup(g0.node_feat, g0.senders, g0.receivers, g0.edge_feat,
                      g0.node_pos)
        for g in graphs:                     # batch size 1, arrival order
            engine.process(g.node_feat, g.senders, g.receivers, g.edge_feat,
                           g.node_pos)
        stats = engine.stats.summary()
    print("stream stats:", stats)
    return stats


def lm_demo(device=None) -> dict:
    """One loss and gradient of reduced llama3-8b (weights from
    ``torch.Generator().manual_seed(0)``) on a (4, 64) batch of random
    tokens, on ``device`` (the card by default); returns the loss, its
    parts and the gradient's global norm."""
    print("=== LM substrate: one gradient of reduced llama3-8b ===")
    dev = resolve_device(device)
    cfg = REDUCED["llama3-8b"]
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    loss, parts = lm.lm_loss(params, batch, cfg)
    gnorm = global_norm(torch.autograd.grad(loss, leaves))
    out = {"loss": float(loss), "xent": float(parts["xent"]),
           "grad_norm": float(gnorm)}
    print(f"loss={out['loss']:.4f} xent={out['xent']:.4f} "
          f"grad_norm={out['grad_norm']:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, which must exist)")
    args = ap.parse_args()
    flowgnn_demo(args.graphs, args.device)
    lm_demo(args.device)
